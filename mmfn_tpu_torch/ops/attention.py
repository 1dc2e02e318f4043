"""Fused inference self-attention: softmax(q k^T / sqrt(d)) v.

The fusion transformers' attention is full (no mask) over T = 64 x n_groups
tokens (192, or 256 at rad stage 4) with head dims 16..128. On a CUDA tensor
:func:`fused_attention` launches the hand-written kernel
``csrc/attention.cu``, which never writes the (T, T) matrix to device memory;
on a CPU tensor it takes the plain PyTorch version :func:`attention_plain`.
Inference only: the kernel has no backward, and training takes the plain
path in ``models/gpt.py``.

Layout contract: q, k and v may be strided (B, H, T, D) views whose last
dimension is contiguous, such as ``y.view(b, t, h, d).transpose(1, 2)`` of a
Linear's (B, T, H*D) output; the kernel reads them in place. On the GPU the
result is the ``transpose(1, 2)`` view of a contiguous (B, T, H, D) buffer, so
``out.transpose(1, 2).reshape(b, t, h * d)`` copies nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from mmfn_tpu_torch.ops._cuda import CudaKernel, stream_handle

HEAD_DIMS = (16, 32, 64, 128)
MAX_TOKENS = 3072    # the largest T that chip_smoke.py checks on the GPU
MAX_GRID_YZ = 65535  # H and B are the grid's y and z
_ALIGN_FLOATS = 4    # 16-byte rows for the kernel's cp.async copies and vector loads

_STRIDES = ctypes.c_longlong * 3
_STRIDES_P = ctypes.POINTER(ctypes.c_longlong)
ATTENTION = CudaKernel("attention.cu", "mmfn_attention_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    _STRIDES_P, _STRIDES_P, _STRIDES_P,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (B, H, T, D) -> (B, H, T, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v


def _kernel_strides(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> Tuple[Tuple[int, int, int], ...]:
    """The (b, h, t) element strides of q, k and v, once each is checked to be
    a (B, H, T, D) view the kernel can read in place: f32 on q's device, same
    shapes, a contiguous last dimension, 16-byte-aligned row bases, D in
    :data:`HEAD_DIMS`, 1 <= T <= :data:`MAX_TOKENS`. Raises ValueError
    otherwise. Needs no GPU."""
    if q.dim() != 4:
        raise ValueError(f"q: expected (B, H, T, D), got shape {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 0 < t <= MAX_TOKENS or b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"shape {tuple(q.shape)} outside the kernel's range")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name}: expected float32 on {q.device}, "
                             f"got {x.dtype} on {x.device}")
        if x.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != q's {tuple(q.shape)}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous, "
                             f"strides {x.stride()}")
        rows = x.stride()[:3]
        if x.data_ptr() % (4 * _ALIGN_FLOATS) or any(s % _ALIGN_FLOATS for s in rows):
            raise ValueError(f"{name}: rows must start 16-byte aligned "
                             f"(strides {x.stride()}, data pointer {x.data_ptr():#x})")
        strides.append(tuple(rows))
    return tuple(strides)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for (B, H, T, D) f32 tensors, strided as the
    module docstring allows. On the GPU the result is the transposed view of a
    contiguous (B, T, H, D) buffer."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"q: expected a CUDA tensor, got {q.device}")
    q_s, k_s, v_s = _kernel_strides(q, k, v)
    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if b * h:
        ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         _STRIDES(*q_s), _STRIDES(*k_s), _STRIDES(*v_s),
                         b, h, t, d, 1.0 / math.sqrt(d), stream_handle(q.device))
    return out.transpose(1, 2)
