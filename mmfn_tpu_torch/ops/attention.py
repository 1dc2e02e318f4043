"""Fused inference self-attention: softmax(q k^T / sqrt(d)) v.

The fusion transformers' attention is full (no mask) over T = 64 x n_groups
tokens (192, or 256 at rad stage 4) with head dims 16..128. On a CUDA tensor
:func:`fused_attention` launches the hand-written kernel
``csrc/attention.cu``, which never writes the (T, T) matrix to device memory;
on a CPU tensor it takes the plain PyTorch version :func:`attention_plain`.
Inference only: the kernel has no backward, and training takes the plain
path in ``models/gpt.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mmfn_tpu_torch.ops._cuda import CudaKernel, check_cuda_tensor, stream_handle

HEAD_DIMS = (16, 32, 64, 128)
MAX_TOKENS = 3072   # the kernel's 16 x T f32 score strip must fit shared memory

ATTENTION = CudaKernel("attention.cu", "mmfn_attention_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, (B, H, T, D) -> (B, H, T, D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1) @ v


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for contiguous (B, H, T, D) f32 tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda_tensor(name, t, (torch.float32,), 4)
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: shape/device {tuple(t.shape)}/{t.device} "
                             f"!= q's {tuple(q.shape)}/{q.device}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 0 < t <= MAX_TOKENS or b * h > 65535:
        raise ValueError(f"shape {tuple(q.shape)} outside the kernel's range")
    out = torch.empty_like(q)
    if b * h:
        ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         b * h, t, d, 1.0 / math.sqrt(d), stream_handle(q.device))
    return out
