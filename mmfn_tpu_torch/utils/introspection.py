"""Model introspection: attention maps and intermediate activations.

The port of the JAX package's ``utils/introspection.py``. There flax's
``capture_intermediates`` records submodule outputs and ``SelfAttention``
sows its softmax maps; here forward hooks record the same things into a
tree of the same shape and keys (module paths split at the dots, flax's
``block_{i}`` for ``blocks.{i}``):

- ``{path}/__call__``: a one-tuple holding the output of each module the
  filter selects (by default every ``SelfAttention`` and ``FusionTransformer``;
  the fusion grids come out NCHW here, NHWC there);
- ``{path}/attention_weights``: a one-tuple holding each ``SelfAttention``'s
  (B, heads, T, T) softmax, taken where it enters the attention dropout.

As in the JAX package (``models/gpt.py``), the maps exist only on the plain
attention path: under ``attn_impl="pallas"`` the fused kernel never forms
them, and :func:`attention_weights` returns nothing.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _tree_path(name: str) -> Tuple[str, ...]:
    return tuple(re.sub(r"(^|\.)blocks\.(\d+)", r"\1block_\2", name).split(".")) if name else ()


def _put(tree: dict, path: Tuple[str, ...], key: str, value) -> None:
    for part in path:
        tree = tree.setdefault(part, {})
    tree[key] = (value,)


def _detach(out):
    if isinstance(out, torch.Tensor):
        return out.detach()
    if isinstance(out, (list, tuple)):
        return type(out)(_detach(x) for x in out)
    return out


def forward_with_intermediates(model: torch.nn.Module, batch, filter_fn=None
                               ) -> Tuple[torch.Tensor, Dict]:
    """Run an inference forward of ``model`` on ``batch``, capturing
    intermediate activations.

    ``filter_fn(module, name) -> bool`` selects the modules whose outputs are
    recorded (default: every ``SelfAttention`` and ``FusionTransformer``);
    every ``SelfAttention``'s attention map is recorded regardless."""
    from mmfn_tpu_torch.models.gpt import SelfAttention

    if filter_fn is None:
        def filter_fn(module, name):
            return type(module).__name__ in ("SelfAttention", "FusionTransformer")

    tree: Dict = {}
    handles = []

    def record(path, key, which):
        def hook(module, args, out):
            _put(tree, path, key, _detach(args[0] if which == "input" else out))
        return hook

    try:
        for name, module in model.named_modules():
            path = _tree_path(name)
            if filter_fn(module, name):
                handles.append(module.register_forward_hook(record(path, "__call__", "output")))
            if isinstance(module, SelfAttention):
                handles.append(module.attn_drop.register_forward_hook(
                    record(path, "attention_weights", "input")))
        with torch.inference_mode():
            out = model(batch)
    finally:
        for h in handles:
            h.remove()
    return out, tree


def _np(x) -> np.ndarray:
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def attention_rollout(intermediates: Dict, transformer: str = "transformer4"
                      ) -> np.ndarray:
    """Average the captured attention-layer outputs of one fusion stage into a
    (T, C) token map for visualization. Returns an empty array when the stage
    was not captured."""
    stage = intermediates.get("encoder", {}).get(transformer, {})
    outputs = []

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                collect(v)
        elif node is not None:
            arr = _np(node)
            if arr.ndim == 3:  # (B, T, C) attention block output
                outputs.append(arr)

    collect(stage)
    if not outputs:
        return np.zeros((0, 0))
    return np.mean([o.mean(axis=0) for o in outputs], axis=0)


def attention_weights(intermediates: Dict) -> Dict[str, np.ndarray]:
    """Collect the softmax attention maps of every SelfAttention, keyed by
    their module path. Each value is (B, heads, T, T)."""
    maps: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v, path)
        elif node is not None and path and path[-1] == "attention_weights":
            arr = _np(node)
            if arr.ndim == 4:
                maps["/".join(path[:-1])] = arr

    walk(intermediates, ())
    return maps


def token_attention_image(att: np.ndarray, query_group: int, key_group: int,
                          grid: int = 8) -> np.ndarray:
    """Average one stage's (B, H, T, T) attention into a (grid*grid,) map of
    how much modality ``query_group``'s tokens attend to each spatial token of
    modality ``key_group``, reshaped to (grid, grid). Token layout is
    n_groups x grid^2 (gpt.py: per-modality 8x8 grids concatenated)."""
    n = grid * grid
    sub = att.mean(axis=(0, 1))          # (T, T) averaged over batch + heads
    q0, k0 = query_group * n, key_group * n
    block = sub[q0:q0 + n, k0:k0 + n]    # queries x keys
    return block.mean(axis=0).reshape(grid, grid)
