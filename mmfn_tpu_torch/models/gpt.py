"""Cross-modal fusion transformer ("GPT" in the reference).

Each modality contributes an 8x8 token grid; T = 64 x n_groups tokens get a
learnable position embedding plus a velocity embedding ``Linear(1, C)``
broadcast to every token, then n_layer pre-LN blocks with ReLU MLPs and a
final LayerNorm; the tokens split back into per-modality grids. Keys follow
the reference checkpoint: ``pos_emb``, ``vel_emb``, ``blocks.{i}.ln1``,
``blocks.{i}.attn.{key,query,value,proj}``, ``blocks.{i}.mlp.{0,2}``, ``ln_f``.

**Tensor parallelism.** ``parallel/mesh.py:tensor_parallel_sharding`` cuts
QKV and ``mlp.0`` on their output features and ``proj`` and ``mlp.2`` on
their input features, then calls :meth:`SelfAttention.set_model_group` and
:meth:`Block.set_model_group`. A sharded sublayer enters through
:func:`copy_to_model` (identity forward, all-reduce backward) and leaves
through :func:`reduce_from_model` (all-reduce forward, identity backward),
Megatron's f and g; the row-parallel bias is added once, after the
all-reduce. Each rank attends over ``n_head / M`` heads, so under
``attn_impl="pallas"`` kernel 2 runs at the local head count on the strided
views of the local QKV outputs.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mmfn_tpu_torch.models.common import init_linear_normal
from mmfn_tpu_torch.ops.attention import fused_attention


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


class SelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float,
                 resid_pdrop: float, attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ("xla", "pallas"):
            raise ValueError(f"attn_impl must be 'xla' or 'pallas', got {attn_impl!r}")
        self.key = nn.Linear(n_embd, n_embd)
        self.query = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        self.attn_drop = nn.Dropout(attn_pdrop)
        self.resid_drop = nn.Dropout(resid_pdrop)
        self.n_head = n_head
        self.attn_impl = attn_impl
        self.model_group = None    # the tensor-parallel group (set_model_group)
        self.local_heads = n_head

    def set_model_group(self, group, size: int) -> None:
        """Run as one of ``size`` tensor-parallel ranks over ``group``, with
        ``n_head / size`` heads (the weights are already sharded)."""
        self.model_group = group
        self.local_heads = self.n_head // size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hs = c // self.n_head
        h = self.local_heads
        group = self.model_group
        if group is not None:
            x = copy_to_model(x, group)

        def heads(y):
            return y.view(b, t, h, hs).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        if self.attn_impl == "pallas" and not self.training:
            # the fused kernel (inference only: it has no backward) reads the
            # heads in place and returns the transpose of a (b, t, h, hs)
            # buffer, so neither side of it copies
            y = fused_attention(q, k, v)
        else:
            att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(hs), dim=-1)
            y = self.attn_drop(att) @ v
        y = y.transpose(1, 2).reshape(b, t, h * hs)
        if group is None:
            return self.resid_drop(self.proj(y))
        y = reduce_from_model(F.linear(y, self.proj.weight), group) + self.proj.bias
        return self.resid_drop(y)


class Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, block_exp: int, attn_pdrop: float,
                 resid_pdrop: float, attn_impl: str = "xla"):
        super().__init__()
        self.ln1 = nn.LayerNorm(n_embd, eps=1e-5)
        self.ln2 = nn.LayerNorm(n_embd, eps=1e-5)
        self.attn = SelfAttention(n_embd, n_head, attn_pdrop, resid_pdrop, attn_impl)
        self.mlp = nn.Sequential(nn.Linear(n_embd, block_exp * n_embd), nn.ReLU(),
                                 nn.Linear(block_exp * n_embd, n_embd),
                                 nn.Dropout(resid_pdrop))
        self.model_group = None

    def set_model_group(self, group, size: int) -> None:
        """The MLP's counterpart of :meth:`SelfAttention.set_model_group`."""
        self.model_group = group

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        group = self.model_group
        if group is None:
            return self.mlp(x)
        fc1, relu, fc2, drop = self.mlp
        x = relu(fc1(copy_to_model(x, group)))
        return drop(reduce_from_model(F.linear(x, fc2.weight), group) + fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self._mlp(self.ln2(x))


class FusionTransformer(nn.Module):
    """Fuse ``n_groups`` NCHW 8x8 grids; returns the updated grids.

    Equivalent to the reference GPT for n_groups=3 and RadarGPT for 4."""

    def __init__(self, n_embd: int, n_head: int, block_exp: int, n_layer: int,
                 n_groups: int, vert_anchors: int = 8, horz_anchors: int = 8,
                 seq_len: int = 1, embd_pdrop: float = 0.1, attn_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1, attn_impl: str = "xla"):
        super().__init__()
        self.n_groups = n_groups
        t = n_groups * seq_len * vert_anchors * horz_anchors
        self.pos_emb = nn.Parameter(torch.zeros(1, t, n_embd))
        self.vel_emb = nn.Linear(1, n_embd)
        self.drop = nn.Dropout(embd_pdrop)
        self.blocks = nn.Sequential(*[
            Block(n_embd, n_head, block_exp, attn_pdrop, resid_pdrop, attn_impl)
            for _ in range(n_layer)])
        self.ln_f = nn.LayerNorm(n_embd, eps=1e-5)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """The reference GPT's init: normal(0, 0.02) Linears, zero biases,
        zero position embedding."""
        init_linear_normal(self, 0.02, g)
        self.pos_emb.zero_()

    def forward(self, grids: List[torch.Tensor], velocity: torch.Tensor) -> List[torch.Tensor]:
        if len(grids) != self.n_groups:
            raise ValueError(f"expected {self.n_groups} grids, got {len(grids)}")
        b, c, h, w = grids[0].shape
        tokens = torch.cat([g.permute(0, 2, 3, 1).reshape(b, h * w, c) for g in grids], dim=1)
        vel = self.vel_emb(velocity[:, None].to(tokens.dtype))       # (B, C)
        x = self.drop(self.pos_emb + tokens + vel[:, None, :])
        x = self.ln_f(self.blocks(x)).view(b, self.n_groups, h, w, c)
        return [x[:, i].permute(0, 3, 1, 2) for i in range(self.n_groups)]
