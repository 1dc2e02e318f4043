"""Sensor preprocessing ops and the two hand-written CUDA kernels.

Importing this package builds nothing: each kernel compiles at its first
launch on a CUDA tensor (``ops/_cuda.py``).
"""

from mmfn_tpu_torch.ops.attention import ATTENTION
from mmfn_tpu_torch.ops.lidar import BEV_HIST

KERNELS = {"bev_hist": BEV_HIST, "fused_attention": ATTENTION}


def reset_launch_counts() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
