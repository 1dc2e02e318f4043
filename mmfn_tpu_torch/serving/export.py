"""Ahead-of-time export of the inference forward for serving (``torch.export``).

The port's counterpart of the JAX package's ``jax.export`` artifact: an
``ExportedProgram`` of ``(params, batch) -> waypoints`` in ATen IR, which a
server runs without the port's model code (only torch and this package's
kernel-2 operator, registered on import). Properties:

- **weights stay external**: the program takes the parameters and the
  buffers (the BatchNorm statistics among them) as an input dict through
  ``torch.func.functional_call``, so checkpoints rotate without re-exporting
  and the artifact holds no weights;
- **batch-polymorphic**: the leading batch dimension is a ``torch.export.Dim``,
  so one artifact serves any batch;
- **kernel 2 inside**: under ``attn_impl="pallas"`` the graph holds
  ``torch.ops.mmfn.fused_attention``, which launches ``csrc/attention.cu`` on
  the card (kernel 1 is not in the forward: the BEV comes in the batch).

An artifact exported on a CPU host serves on the card: :func:`serving_call`
moves the program to the device of the parameters it is given
(``torch.export.passes.move_to_device_pass``), which rewrites the devices
that tracing on the CPU baked into the graph. ATen IR has no per-backend
lowering, so there is no counterpart of ``jax.export``'s ``platforms``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import torch
import torch.fx.experimental._config as fx_config
from torch.export.exported_program import ExportedProgram
from torch.export.graph_signature import ExportGraphSignature, InputKind
from torch.export.passes import move_to_device_pass

import mmfn_tpu_torch.ops.attention  # noqa: F401  (registers mmfn::fused_attention)
from mmfn_tpu_torch.data.batch import Batch

# labels, which the forward never reads
_LABELS = ("waypoints", "action")
# the largest symbolic batch: cuDNN's batch norm on the card takes at most
# 65,535 samples, and the trace on the card guards it
MAX_BATCH = 65535


class _Forward(torch.nn.Module):
    """``(params, fields) -> model output``: the model's forward with every
    parameter and buffer taken from ``params``."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, params: Dict[str, torch.Tensor], fields: Dict[str, torch.Tensor]):
        batch = Batch(**fields)
        args = (batch,)
        if getattr(self.model, "variant", "") == "cilrs":
            args = (batch, batch.command.to(torch.int32))
        return torch.func.functional_call(self.model, params, args)


def _without_weights(exported: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """The program without its lifted parameters and buffers. ``export``
    lifts every one the root module owns, but ``functional_call`` swaps in
    the ``params`` input, so the lifted ones have no use in the graph."""
    sig = exported.graph_signature
    lifted = {spec.arg.name for spec in sig.input_specs
              if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER)}
    gm = exported.graph_module
    for node in list(gm.graph.nodes):
        if node.op == "placeholder" and node.name in lifted:
            if node.users:
                raise RuntimeError(f"export: the graph reads the model's own {node.name}, "
                                   "not the params input")
            gm.graph.erase_node(node)
    gm.recompile()
    specs = [spec for spec in sig.input_specs if getattr(spec.arg, "name", None) not in lifted]
    return ExportedProgram(
        root=gm, graph=gm.graph,
        graph_signature=ExportGraphSignature(input_specs=specs, output_specs=sig.output_specs),
        state_dict={}, range_constraints=exported.range_constraints,
        module_call_graph=exported.module_call_graph, example_inputs=None,
        constants=exported.constants, verifiers=getattr(exported, "verifiers", None))


def model_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers by name: the program's first input."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def batch_fields(batch: Batch, model: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """The batch's tensors the forward reads, by field name: the program's
    second input (CILRS also reads ``command``)."""
    labels = _LABELS + (() if getattr(model, "variant", "") == "cilrs" else ("command",))
    return {k: v for k, v in batch._asdict().items() if v is not None and k not in labels}


def export_forward(model: torch.nn.Module, params: Dict[str, torch.Tensor],
                   sample_batch: Batch,
                   symbolic_batch: bool = True) -> torch.export.ExportedProgram:
    """Export the inference forward ``(params, batch) -> waypoints`` of
    ``model`` (in eval mode) on the device of ``params``.

    ``sample_batch`` fixes every shape except, with ``symbolic_batch``, the
    leading batch dimension, which becomes ``Dim("b", min=1, max=MAX_BATCH)``
    (trace it at a batch of 2 or more: a sample of 1 specializes it)."""
    fields = batch_fields(sample_batch, model)
    dynamic = None
    if symbolic_batch:
        b = torch.export.Dim("b", min=1, max=MAX_BATCH)
        dynamic = ({k: None for k in params}, {k: {0: b} for k in fields})
    model.eval()
    # a batch of 1 must not be told apart from the sample's 2 by the checks
    # that ops make on sizes (size-oblivious reasoning)
    with torch.no_grad(), fx_config.patch(backed_size_oblivious=True):
        exported = torch.export.export(_Forward(model), (dict(params), fields),
                                       dynamic_shapes=dynamic)
    # the sample inputs hold the weights too, and would be saved with the program
    return _without_weights(exported)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(exported, f)
    os.replace(tmp, path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    return torch.export.load(path)


def input_fields(exported: torch.export.ExportedProgram):
    """The batch fields the program takes, in order."""
    spec = exported.call_spec.in_spec
    if hasattr(spec, "child"):
        return spec.child(0).child(1).context
    return spec.children_specs[0].children_specs[1].context


def serving_call(exported: torch.export.ExportedProgram) -> Callable:
    """A ``(params, batch) -> waypoints`` callable from a loaded artifact, on
    the device of the ``params`` it is called with (the program is moved
    there once per device)."""
    programs = {}

    def call(params: Dict[str, torch.Tensor], batch: Batch):
        device = next(iter(params.values())).device
        if device not in programs:
            programs[device] = move_to_device_pass(
                exported, device).module()
        fields = {k: getattr(batch, k) for k in input_fields(exported)}
        with torch.inference_mode():
            return programs[device](dict(params), fields)

    return call
