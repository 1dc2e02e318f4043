"""Radar graph-attention encoder (dense masked attention over 81 nodes).

Shape walk, as the reference's: x (B, 81, 5) -> per head Wh = x @ W
(B, 81, 162); e = leaky_relu(Wh @ a) (B, 81, 81); attention =
softmax(where(adj > 0, e, -9e15)); h' = elu(attention @ Wh). Heads are
concatenated along the NODE axis -> (B, 162, 162); mlp_1 (162 -> 256) on
elu(x), transpose, mlp_2 (162 -> 128); ``view(B, 8, 8, 512).transpose(1, 3)``
gives (B, 512, 8, 8) NCHW, then log_softmax over channels.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


class GraphAttentionLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, dropout: float, alpha: float):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_features, 2 * out_features))
        self.a = nn.Parameter(torch.empty(2 * out_features, out_features))
        self.dropout = nn.Dropout(dropout)
        self.alpha = alpha

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """xavier-normal with gain 1.414, as the reference's pyGAT layers."""
        for p in (self.W, self.a):
            std = 1.414 * math.sqrt(2.0 / (p.shape[0] + p.shape[-1]))
            p.copy_(torch.randn(p.shape, generator=g) * std)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        wh = h @ self.W                                                 # (B, N, 2*out)
        e = F.leaky_relu(wh @ self.a, self.alpha)                      # (B, N, N)
        attention = torch.where(adj > 0, e, torch.full_like(e, -9e15))
        attention = self.dropout(torch.softmax(attention, dim=-1))
        return F.elu(attention @ wh)


class RadarGAT(nn.Module):
    """(B, 81, 5) radar + (B, 81, 81) adjacency -> (B, 512, 8, 8) NCHW."""

    def __init__(self, nfeat: int = 5, nhid: int = 81, dropout: float = 0.1,
                 alpha: float = 0.2, nheads: int = 2):
        super().__init__()
        self.nheads = nheads
        for i in range(nheads):
            self.add_module(f"attention_{i}", GraphAttentionLayer(nfeat, nhid, dropout, alpha))
        self.mlp_1 = nn.Sequential(nn.Linear(nheads * nhid, 256), nn.Dropout(dropout))
        self.mlp_2 = nn.Sequential(nn.Linear(nheads * nhid, 128), nn.Dropout(dropout))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        x = self.dropout(x)
        x = torch.cat([getattr(self, f"attention_{i}")(x, adj) for i in range(self.nheads)],
                      dim=1)                                            # node axis
        x = self.dropout(x)
        x = self.mlp_1(F.elu(x))
        x = self.mlp_2(x.transpose(1, 2))
        x = x.reshape(x.shape[0], 8, 8, 512).transpose(1, 3)
        return F.log_softmax(x, dim=1)
