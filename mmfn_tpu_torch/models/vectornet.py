"""VectorNet-style lane encoder.

Lanes arrive padded to (B, max_lanes, 10, 5) with per-sample counts. A
per-lane polyline subgraph (3 x MLP + max-pool concat) makes one token per
lane; masked global self-attention runs over the lanes (padded lanes masked
with -1e9); a positional MLP fed zeros gives one constant vector per token (a
reference quirk, kept); an agent-fusion MLP follows; a generator expands lane
token 0 into the (B, 64, 64, 64) NCHW seed of the map stream (the reference's
``b (c h w) -> b c h w``). GELUs are exact.
"""

from __future__ import annotations

import torch
from torch import nn


class _MLP(nn.Module):
    """Linear + LayerNorm + ReLU; keys ``mlp.0`` / ``mlp.1``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(cin, cout), nn.LayerNorm(cout, eps=1e-5), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class Subgraph(nn.Module):
    """(B, L, V, d_in) -> (B, L, 2 * hidden); keys ``layers.mlp_{i}.mlp.*``."""

    def __init__(self, cin: int, hidden: int, num_layers: int = 3):
        super().__init__()
        self.layers = nn.Sequential()
        for i in range(num_layers):
            self.layers.add_module(f"mlp_{i}", _MLP(cin if i == 0 else 2 * hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for mlp in self.layers:
            x = mlp(x)
            pooled = x.max(dim=-2, keepdim=True).values
            x = torch.cat([x, pooled.expand_as(x)], dim=-1)
        return x.max(dim=-2).values


class MaskSelfAttention(nn.Module):
    """Multi-head self-attention with a key mask; keys ``to_qkv``, ``to_out.0``."""

    def __init__(self, dim: int, heads: int = 1, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(dim, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``mask`` (B, N) bool, False = ignore that key."""
        b, n, dim = x.shape
        dh = dim // self.heads
        q, k, v = (t.view(b, n, self.heads, dh).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        dots = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
        dots = dots.masked_fill(~mask[:, None, None, :], -1e9)
        out = (torch.softmax(dots, dim=-1) @ v).transpose(1, 2).reshape(b, n, dim)
        return self.to_out(out)


class VectornetEncoder(nn.Module):
    def __init__(self, lane_channels: int = 7, hidden_size: int = 64,
                 subgraph_layers: int = 3, pos_dim: int = 64, heads: int = 2,
                 fusion_dim: int = 128, out_hw: int = 64, out_channels: int = 64):
        super().__init__()
        self.out_hw, self.out_channels = out_hw, out_channels
        self.lane_subgraph = Subgraph(lane_channels, hidden_size, subgraph_layers)
        self.pos_emb = nn.Sequential(nn.Linear(2, pos_dim), nn.LayerNorm(pos_dim, eps=1e-5),
                                     nn.GELU(), nn.Linear(pos_dim, pos_dim))
        self.L2L = MaskSelfAttention(hidden_size * 2, heads)
        d_cat = pos_dim + hidden_size * 2
        self.agent_fusion = nn.Sequential(
            nn.Linear(d_cat, fusion_dim), nn.LayerNorm(fusion_dim, eps=1e-5), nn.GELU(),
            nn.Linear(fusion_dim, hidden_size * 2))
        self.generator = nn.Sequential(
            nn.Linear(hidden_size * 2, hidden_size), nn.LayerNorm(hidden_size, eps=1e-5),
            nn.GELU(), nn.Linear(hidden_size, out_hw * out_hw * out_channels))

    def forward(self, lanes: torch.Tensor, lane_num: torch.Tensor) -> torch.Tensor:
        """lanes (B, L, 10, 5) float, lane_num (B,) int -> (B, 64, 64, 64) NCHW."""
        b, max_lanes = lanes.shape[:2]
        vec = torch.cat([lanes[:, :, :-1, 0:2], lanes[:, :, 1:, 0:2], lanes[:, :, 1:, 2:]],
                        dim=-1)
        lane_token = self.lane_subgraph(vec)                          # (B, L, 128)
        mask = torch.arange(max_lanes, device=lanes.device)[None, :] < lane_num[:, None]
        lane_token = self.L2L(lane_token, mask)
        pos = self.pos_emb(lane_token.new_zeros(b, max_lanes, 2))
        fused = self.agent_fusion(torch.cat([lane_token, pos], dim=-1))
        out = self.generator(fused[:, 0, :])
        return out.view(b, self.out_channels, self.out_hw, self.out_hw)

