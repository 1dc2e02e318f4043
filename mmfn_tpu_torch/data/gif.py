"""Animated GIF89a writer (numpy and the standard library only).

The port's stand-in for PIL's ``Image.save(path, save_all=True,
append_images=..., duration=..., loop=0)``, which the JAX package's
``scripts/record_episode.py`` writes its birdview episodes with; the GPU
machine has no PIL. Every frame carries its own exact palette (a local
colour table of its distinct colours), so a frame of 256 colours or fewer is
stored losslessly, and a frame with more raises rather than being quantized.
Pixels are LZW-coded as giflib codes them (code widths grow once the next
code no longer fits, a clear code when the table reaches 4,095 entries).
The file loops forever (a NETSCAPE2.0 block with count 0) and each frame
shows for ``duration_ms`` rounded down to centiseconds.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

MAX_COLORS = 256
_LZW_TABLE_LIMIT = 4095


def _palette(frame: np.ndarray):
    """(colour table rows, per-pixel indices) of an (H, W, 3) uint8 frame."""
    rgb = frame.reshape(-1, 3).astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    colors, index = np.unique(packed, return_inverse=True)
    if len(colors) > MAX_COLORS:
        raise ValueError(f"a GIF frame holds at most {MAX_COLORS} colours; this one has "
                         f"{len(colors)} (quantize it first)")
    table = np.stack([(colors >> 16) & 255, (colors >> 8) & 255, colors & 255], 1)
    return table.astype(np.uint8), index.astype(np.int64)


def lzw_encode(indices: Sequence[int], min_code_size: int) -> bytes:
    """GIF's variable-width LZW code stream of palette ``indices``."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    size, next_code = min_code_size + 1, end + 1
    table = {}
    out = bytearray()
    acc = nbits = 0

    def emit(code):
        nonlocal acc, nbits, size
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        if next_code >= 1 << size:
            size += 1

    emit(clear)
    it = iter(indices)
    cur = next(it)
    for px in it:
        key = cur << 8 | px
        code = table.get(key)
        if code is not None:
            cur = code
            continue
        emit(cur)
        cur = px
        if next_code >= _LZW_TABLE_LIMIT:
            emit(clear)
            size, next_code = min_code_size + 1, end + 1
            table.clear()
        else:
            table[key] = next_code
            next_code += 1
    emit(cur)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    chunks = [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(chunks) + b"\x00"


def encode(frames: Sequence[np.ndarray], duration_ms: int) -> bytes:
    """The GIF file of ``frames`` ((H, W, 3) uint8 RGB arrays of one size),
    each shown ``duration_ms``, looping forever."""
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    height, width = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", width, height, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]      # loop count 0: forever
    delay = int(duration_ms) // 10
    for frame in frames:
        frame = np.asarray(frame)
        if frame.shape != (height, width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"frames must be ({height}, {width}, 3) uint8, got "
                             f"{frame.shape} {frame.dtype}")
        table, index = _palette(frame)
        bits = max(1, int(np.ceil(np.log2(len(table)))))
        padded = np.zeros((1 << bits, 3), np.uint8)
        padded[:len(table)] = table
        min_code_size = max(2, bits)
        # graphic control: disposal 1 (leave in place), no transparency
        out.append(b"\x21\xf9\x04" + struct.pack("<BHB", 1 << 2, delay, 0) + b"\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 0x80 | (bits - 1)))
        out.append(padded.tobytes())
        out.append(bytes([min_code_size]) + _sub_blocks(lzw_encode(index.tolist(), min_code_size)))
    out.append(b"\x3b")
    return b"".join(out)


def write(path: str, frames: Sequence[np.ndarray], duration_ms: int) -> None:
    with open(path, "wb") as f:
        f.write(encode(frames, duration_ms))
