"""Autoregressive GRU waypoint decoder.

The reference keeps the cell and the output head at the top of the model
(keys ``decoder.*`` and ``output.*``), so this is a function over the two
modules rather than a module of its own. ``nn.GRUCell`` orders its gates
[r, z, n], as the JAX package's cell does. While ``torch.export`` traces,
the cell's step is written out (:func:`gru_step`): on CUDA ``nn.GRUCell``
calls a fused operator that has no tracing rule.
"""

from __future__ import annotations

import torch
from torch import nn


def gru_step(cell: nn.GRUCell, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One step of ``cell`` in plain operations: the same gates as
    ``nn.GRUCell``."""
    gi = nn.functional.linear(x, cell.weight_ih, cell.bias_ih)
    gh = nn.functional.linear(h, cell.weight_hh, cell.bias_hh)
    i_r, i_z, i_n = gi.chunk(3, dim=1)
    h_r, h_z, h_n = gh.chunk(3, dim=1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def decode_waypoints(cell: nn.GRUCell, output: nn.Linear, z: torch.Tensor,
                     target_point: torch.Tensor, pred_len: int = 4,
                     input_mode: str = "add") -> torch.Tensor:
    """z (B, hidden) + target point (B, 2) -> (B, pred_len, 2) waypoints.

    ``input_mode='add'`` feeds x + target_point into the GRU (MMFN,
    TransFuser); ``'cat'`` concatenates them (AIM). Each step integrates the
    predicted delta: x_{k+1} = x_k + output(h_{k+1})."""
    x = z.new_zeros(z.shape[0], 2)
    tp = target_point.to(z.dtype)
    h = z
    exporting = torch.compiler.is_exporting()
    waypoints = []
    for _ in range(pred_len):
        x_in = x + tp if input_mode == "add" else torch.cat([x, tp], dim=1)
        h = gru_step(cell, x_in, h) if exporting else cell(x_in, h)
        x = x + output(h)
        waypoints.append(x)
    return torch.stack(waypoints, dim=1)
