"""Process groups, device meshes, data parallelism and tensor parallelism.

The port's counterpart of the JAX package's ``parallel/mesh.py``, under its
names. JAX builds one ``Mesh`` over the devices of every process and lets
GSPMD place the collectives. Here each process drives one device, and the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group, laid out ``("data",)`` or ``("data", "model")``; rank ``r`` sits at
``(r // M, r % M)``, as ``np.reshape`` lays the JAX devices out.

- :func:`init_distributed` joins the process group: the counterpart of
  ``jax.distributed.initialize`` in the JAX phase2 CLI. The rendezvous comes
  from the environment, as ``torchrun`` sets it (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); the JAX config keys
  ``coordinator_address`` (``host:port``), ``num_processes`` and
  ``process_id`` take their place when given.
- :func:`shard_batch` gives this rank its rows of a global batch, and
  :func:`replicate` broadcasts a model's parameters and buffers from rank 0:
  the data-parallel layout, whose gradient all-reduce DDP does
  (``train/engine.py``).
- :func:`tensor_parallel_sharding` applies ``_TP_RULES``, the JAX package's
  Megatron rules transposed to ``nn.Linear.weight``'s (out, in) layout:
  QKV and ``fc1`` (``blocks.i.mlp.0``) are column-parallel, sharded on dim 0 with
  their biases; ``proj`` and ``fc2`` (``blocks.i.mlp.2``) are row-parallel, sharded
  on dim 1, their biases added once after the all-reduce. Each rank of a
  ``model`` group then holds ``n_head / M`` heads; ``models/gpt.py`` runs
  the sharded blocks with the conjugate f/g operators. DDP reduces over
  the ``data`` group, TP over ``model``, and BatchNorm's global-batch
  statistics over ``data`` (the ranks of one model group see the same rows).
- :func:`full_state_dict` gathers the sharded tensors back, so a checkpoint
  written from a tensor-parallel run holds full tensors under the reference
  keys, and :func:`local_state_dict` cuts full tensors to this rank's shard.

The backend is NCCL on ``cuda:LOCAL_RANK``, with gloo beside it for the
CPU-side coordination of ``torch.distributed.checkpoint.async_save``
(``"cpu:gloo,cuda:nccl"``: CUDA tensors never go through gloo). Gloo alone
only when the CPU is asked for, or ``backend="gloo"`` is given.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

# (parameter-name pattern, sharded dim of nn.Linear.weight / bias), first
# match wins; every other parameter and buffer replicates
_TP_RULES = (
    (re.compile(r"blocks\.\d+\.attn\.(key|query|value)\.(weight|bias)$"), 0),
    (re.compile(r"blocks\.\d+\.attn\.proj\.weight$"), 1),
    (re.compile(r"blocks\.\d+\.mlp\.0\.(weight|bias)$"), 0),
    (re.compile(r"blocks\.\d+\.mlp\.2\.weight$"), 1),
)


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    rank: int
    world_size: int
    local_rank: int
    address: str
    port: int


def rendezvous(cfg=None, environ=None) -> Rendezvous:
    """The process's place in the group: ``torchrun``'s variables, with the
    JAX config keys ``coordinator_address`` / ``num_processes`` /
    ``process_id`` over them when the config gives them."""
    cfg = cfg or {}
    env = os.environ if environ is None else environ
    address = env.get("MASTER_ADDR", "localhost")
    port = env.get("MASTER_PORT", "29500")
    if cfg.get("coordinator_address"):
        address, _, port = str(cfg["coordinator_address"]).rpartition(":")
    world = cfg.get("num_processes") or env.get("WORLD_SIZE", 1)
    rank = cfg.get("process_id")
    rank = env.get("RANK", 0) if rank is None else rank
    local = env.get("LOCAL_RANK", rank if cfg.get("process_id") is not None else 0)
    r = Rendezvous(int(rank), int(world), int(local), address, int(port))
    if not 0 <= r.rank < r.world_size:
        raise ValueError(f"rank {r.rank} outside a world of {r.world_size}")
    return r


def torchrun_environment(environ=None) -> bool:
    """Whether the process was started by ``torchrun`` (or with its
    variables set by hand)."""
    env = os.environ if environ is None else environ
    return "RANK" in env and "WORLD_SIZE" in env


def init_distributed(cfg=None, device=None, backend: Optional[str] = None) -> torch.device:
    """Join the process group (see the module docstring) and return this
    process's device: ``cuda:LOCAL_RANK``; the CPU when ``device`` (or the
    config's ``device``) says ``cpu``; a CUDA device with an index when it
    names one (two ranks on one card need ``backend="gloo"``: NCCL refuses
    that). Raises when CUDA is wanted and there is none."""
    cfg = cfg or {}
    r = rendezvous(cfg)
    want = device if device is not None else cfg.get("device")
    want = None if want is None else torch.device(want)
    cpu = want is not None and want.type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device=cpu to train on "
                               "the CPU over gloo")
        dev = want if want is not None and want.index is not None else \
            torch.device("cuda", r.local_rank)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "gloo" if cpu else "cpu:gloo,cuda:nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://{r.address}:{r.port}",
                                rank=r.rank, world_size=r.world_size)
    return dev


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None):
    """A DeviceMesh over the process group: ``n_devices`` (the world size,
    one device a process) laid out over ``axes``. With ``axis_sizes`` None
    every rank goes to the first axis, as in the JAX package."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a world of {n_devices} "
                         f"processes, one device each (the world is {world})")
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axes) - 1)
    if len(axis_sizes) != len(axes) or _prod(axis_sizes) != world:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} do not lay out {world} ranks "
                         f"over {tuple(axes)}")
    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axes))


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``; 1 when the mesh (or None) lacks it."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``; 0 when the mesh lacks it."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis``, or None when it has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of a global batch (a ``Batch`` or any NamedTuple of
    tensors and None): equal contiguous shards along ``axis``."""
    n, i = axis_size(mesh, axis), axis_rank(mesh, axis)
    rows = next(len(v) for v in batch if v is not None)
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} ranks of {axis!r}")
    per = rows // n
    return type(batch)(*[None if v is None else v[i * per:(i + 1) * per] for v in batch])


@torch.no_grad()
def replicate(model: nn.Module, mesh=None) -> nn.Module:
    """Broadcast ``model``'s parameters and buffers from global rank 0 to
    every rank, in place; returns the model."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0)
    return model


# --------------------------------------------------------------------------- #
# tensor parallelism
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class TensorParallel:
    """What :func:`tensor_parallel_sharding` did to a model: the mesh, the
    ``model`` group and, by parameter name, the sharded dim."""
    mesh: object
    group: object
    size: int
    rank: int
    dims: Dict[str, int]


def tp_dim(name: str) -> Optional[int]:
    """The dim ``_TP_RULES`` shards parameter ``name`` on, or None."""
    for pattern, dim in _TP_RULES:
        if pattern.search(name):
            return dim
    return None


def tensor_parallel_sharding(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s fusion transformers over the mesh's ``model`` axis
    by ``_TP_RULES``, in place (each parameter keeps its identity and takes
    this rank's slice), and switch their blocks to the sharded forward.
    Refuses a model-axis size that does not divide the heads. Returns the
    model; a mesh whose ``model`` axis has one rank leaves it as it was."""
    from mmfn_tpu_torch.models.gpt import Block, SelfAttention

    size, rank, group = axis_size(mesh, "model"), axis_rank(mesh, "model"), axis_group(mesh, "model")
    if size == 1:
        return model
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    if not attns:
        raise ValueError("tensor parallelism shards the fusion transformers, and this "
                         "model has none")
    for a in attns:
        if a.n_head % size:
            raise ValueError(f"model_parallel={size} does not divide the {a.n_head} heads "
                             f"of the fusion transformer; use 1, 2 or 4 for 4 heads")
    dims = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = tp_dim(name)
            if dim is None:
                continue
            if p.shape[dim] % size:
                raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} does not split "
                                 f"over {size} ranks")
            p.data = p.data.chunk(size, dim)[rank].clone()
            dims[name] = dim
    for m in model.modules():
        if isinstance(m, (SelfAttention, Block)):
            m.set_model_group(group, size)
    model.tensor_parallel = TensorParallel(mesh, group, size, rank, dims)
    return model


def layout_of(model: nn.Module) -> Optional[TensorParallel]:
    return getattr(model, "tensor_parallel", None)


def gather_full(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """All ranks' shards of ``t`` along ``dim``, concatenated (a collective
    over ``group``)."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every tensor-parallel shard gathered to
    its full tensor (a collective on the model group: every rank calls it)."""
    sd = model.state_dict()
    tp = layout_of(model)
    if tp is None:
        return sd
    return {k: gather_full(v, tp.dims[k], tp.group, tp.size) if k in tp.dims else v
            for k, v in sd.items()}


def local_state_dict(model: nn.Module, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full tensors under the reference keys -> this rank's shards, ready
    for ``model.load_state_dict``."""
    tp = layout_of(model)
    if tp is None:
        return full
    return {k: v.chunk(tp.size, tp.dims[k])[tp.rank] if k in tp.dims else v
            for k, v in full.items()}
