"""Cross-modal fusion transformer ("GPT" in the reference).

Each modality contributes an 8x8 token grid; T = 64 x n_groups tokens get a
learnable position embedding plus a velocity embedding ``Linear(1, C)``
broadcast to every token, then n_layer pre-LN blocks with ReLU MLPs and a
final LayerNorm; the tokens split back into per-modality grids. Keys follow
the reference checkpoint: ``pos_emb``, ``vel_emb``, ``blocks.{i}.ln1``,
``blocks.{i}.attn.{key,query,value,proj}``, ``blocks.{i}.mlp.{0,2}``, ``ln_f``.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from mmfn_tpu_torch.models.common import init_linear_normal
from mmfn_tpu_torch.ops.attention import fused_attention


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hs = c // self.n_head

        def heads(y):
            return y.view(b, t, self.n_head, hs).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        if self.attn_impl == "pallas" and not self.training:
            # the fused kernel (inference only: it has no backward) reads the
            # heads in place and returns the transpose of a (b, t, h, hs)
            # buffer, so neither side of it copies
            y = fused_attention(q, k, v)
        else:
            att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(hs), dim=-1)
            y = self.attn_drop(att) @ v
        y = y.transpose(1, 2).reshape(b, t, c)
        return self.resid_drop(self.proj(y))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


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
