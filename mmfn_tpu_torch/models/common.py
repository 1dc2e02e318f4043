"""Shared building blocks and the seeded weight initialisation."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def join_mlp() -> nn.Sequential:
    """The reference's 'join' MLP 512->256->128->64; keys join.0/2/4."""
    return nn.Sequential(nn.Linear(512, 256), nn.ReLU(),
                         nn.Linear(256, 128), nn.ReLU(),
                         nn.Linear(128, 64), nn.ReLU())


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _uniform(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)


def _normal(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=g) * std)


def init_linear_normal(module: nn.Module, std: float, g: torch.Generator) -> None:
    """normal(0, std) weights and zero biases for every Linear in ``module``
    (the reference GPT's init) and default LayerNorms."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _normal(m.weight, std, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


@torch.no_grad()
def init_weights(module: nn.Module, g: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from the generator ``g``, in
    the families the JAX package uses: kaiming-normal (fan_out) convs,
    torch-default uniform Linears and GRU cells, identity BatchNorms and
    LayerNorms. A module with its own ``init_weights(g)`` method (the fusion
    transformer, the radar GAT) initialises its whole subtree itself."""
    own = getattr(module, "init_weights", None)
    if own is not None:
        own(g)
        return
    if isinstance(module, nn.Conv2d):
        fan_out = module.out_channels * module.kernel_size[0] * module.kernel_size[1]
        _normal(module.weight, math.sqrt(2.0 / fan_out), g)
        if module.bias is not None:
            module.bias.zero_()
    elif isinstance(module, nn.Linear):
        bound = 1.0 / math.sqrt(module.in_features)
        _uniform(module.weight, bound, g)
        if module.bias is not None:
            _uniform(module.bias, bound, g)
    elif isinstance(module, nn.GRUCell):
        bound = 1.0 / math.sqrt(module.hidden_size)
        for p in module.parameters():
            _uniform(p, bound, g)
    elif isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
        module.reset_parameters()
    for child in module.children():
        init_weights(child, g)
