"""ResNet backbones (torchvision BasicBlock topology), staged execution.

The MMFN encoder interleaves fusion transformers between ResNet stages, so
the backbone exposes ``stem`` and ``stage(i)`` instead of one forward.
Parameter names are torchvision's (``conv1``, ``bn1``, ``layer2.0.downsample.0``
...), so reference checkpoints load unchanged. BatchNorm eps is 1e-5 and runs
from its running statistics in eval mode.

**BatchNorm running variance.** In train mode :class:`BatchNorm2d` normalises
with the biased batch variance, as stock torch does, but it also updates
``running_var`` with the BIASED variance, as the JAX package's flax
``nn.BatchNorm(momentum=0.9)`` does. Stock torch updates it with the unbiased
one, larger by a factor of n/(n-1) for n values per channel. The port follows
the JAX package, the reference it is held to; the state_dict keys are
torch's.

**Global-batch statistics.** Under a data-parallel mesh the JAX package's
BN moments are global-batch statistics: XLA all-reduces them
(``docs/PARITY.md``). :func:`set_batchnorm_group` gives every
:class:`BatchNorm2d` of a model the mesh's ``data`` group; in train mode each
then all-reduces its per-channel sum, sum of squares and count over the
group with ``torch.distributed.nn.functional.all_reduce``, so gradients flow
through the reduction, and takes flax's variance E[x²] - E[x]² (clamped at
0) from them. ``torch.nn.SyncBatchNorm`` would not do: it refuses CPU
tensors and updates ``running_var`` unbiased. With no group, or a group of
one rank, the code path is the single-process one.

**Remat.** ``remat=True`` (``GlobalConfig.remat``) runs each BasicBlock in
training under ``torch.utils.checkpoint`` (non-reentrant), as the JAX package
wraps each block in ``nn.remat``: the backward recomputes the block's
activations instead of keeping them. The recomputation runs the block's
BatchNorms again in train mode; they skip their running-stat update there,
so the stats are updated once per step, as without remat.

``first_stage=2`` builds a backbone without ``conv1``/``bn1``/``layer1``: the
vec and rad map streams are seeded at layer2 by VectorNet and never run them.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmfn_tpu_torch.models.common import max_pool_3x3_s2_p1

WIDTHS = (64, 128, 256, 512)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses the
    biased batch variance (flax's rule; see the module docstring). Set
    ``update_stats`` False to normalise by batch statistics without touching
    the running ones."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True
        self.data_group = None     # set_batchnorm_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.data_group is not None:
            return self._global_batch_norm(x)
        # One pass: torch's op leaves (1 - m) * old + m * the unbiased batch
        # variance in ``var``; moving (1 - m) * old by (n - 1) / n of the way
        # to it adds m * the biased one. Autograd keeps the running_var the
        # op was given, so it gets a copy; remat's recomputation
        # (update_stats False) gets copies of both, updates them and drops
        # them.
        m = self.momentum
        mean = self.running_mean if self.update_stats else self.running_mean.clone()
        var = self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, m, self.eps)
        if self.update_stats:
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_var.mul_(1 - m).lerp_(var, (n - 1) / n)
                self.num_batches_tracked.add_(1)
        return out

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode BN over the global batch of the data group (module
        docstring), in f32."""
        from torch.distributed.nn.functional import all_reduce

        c, xf = x.shape[1], x.float()
        stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        stats = all_reduce(stats, group=self.data_group)
        mean = stats[:c] / stats[-1]
        var = torch.clamp(stats[c:2 * c] / stats[-1] - mean * mean, min=0.0)
        if self.update_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.lerp_(mean, m)
                self.running_var.lerp_(var, m)
                self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return out.to(x.dtype)


def set_batchnorm_group(model: nn.Module, group) -> nn.Module:
    """Give every :class:`BatchNorm2d` of ``model`` the data-parallel
    ``group`` for global-batch statistics (None: per-process statistics,
    the single-process path)."""
    import torch.distributed as dist

    if group is not None and dist.get_world_size(group) == 1:
        group = None
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.data_group = group
    return model


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, remat: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout, eps=1e-5))
        self.remat = remat

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)

    @contextlib.contextmanager
    def _frozen_stats(self) -> Iterator[None]:
        """The recomputation's context: batch statistics, no stat update."""
        norms = [m for m in self.modules() if isinstance(m, BatchNorm2d)]
        for m in norms:
            m.update_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(self._block, x, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  self._frozen_stats()))
        return self._block(x)


class ResNet(nn.Module):
    """Staged ResNet; ``stage_sizes`` (2,2,2,2) is resnet18, (3,4,6,3) resnet34."""

    def __init__(self, stage_sizes: Sequence[int], in_channels: int = 3,
                 first_stage: int = 1, remat: bool = False):
        super().__init__()
        self.first_stage = first_stage
        if first_stage == 1:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
            self.bn1 = BatchNorm2d(64, eps=1e-5)
        for i, (width, blocks) in enumerate(zip(WIDTHS, stage_sizes)):
            if i + 1 < first_stage:
                continue
            cin = WIDTHS[max(i - 1, 0)]
            layer = [BasicBlock(cin if j == 0 else width, width,
                                2 if (i > 0 and j == 0) else 1, remat) for j in range(blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_3x3_s2_p1(F.relu(self.bn1(self.conv1(x))))

    def stage(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """Run layer{index} (1-based, torchvision naming)."""
        return getattr(self, f"layer{index}")(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(1, 5):
            x = self.stage(x, i)
        return x.mean(dim=(2, 3))


def resnet18(in_channels: int = 3, first_stage: int = 1, remat: bool = False) -> ResNet:
    return ResNet((2, 2, 2, 2), in_channels, first_stage, remat)


def resnet34(in_channels: int = 3, first_stage: int = 1, remat: bool = False) -> ResNet:
    return ResNet((3, 4, 6, 3), in_channels, first_stage, remat)
