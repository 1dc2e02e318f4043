"""PNG files on zlib and numpy, for the dataset's camera frames and map rasters.

The collection config writes frames as PNG (``image_ext: png``), and the JAX
package reads and writes them through PIL. The port keeps its own codec so
that it needs neither PIL nor cv2, and so that either package reads the
other's raw trees:

- :func:`encode` / :func:`write`: 8-bit gray, RGB or RGBA, not interlaced.
  Each row takes the filter (None, Sub or Up) whose filtered bytes, read as
  signed, have the least absolute sum, the heuristic PIL uses; one IDAT.
- :func:`decode` / :func:`read`: 8-bit gray, RGB or RGBA, not interlaced,
  with all five filter types and any number of IDAT chunks, which covers
  what PIL writes. Every chunk's CRC is checked.

Anything else (other bit depths, palette or gray-alpha images, interlacing,
a truncated or corrupt file) raises ``ValueError`` naming what it found; the
decoder never returns a guess. The files need not equal PIL's byte for byte:
their pixels do, both ways.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> channels (8 bits each)
COLOUR_TYPES = {1: 0, 3: 2, 4: 6}      # channels -> colour type
COMPRESS_LEVEL = 6                      # zlib's default, and PIL's


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(pixels: np.ndarray, bpp: int) -> np.ndarray:
    """(h, w * c) uint8 -> (h, 1 + w * c) filtered scanlines, each row with
    the filter of None, Sub and Up whose bytes have the least absolute sum
    as signed values (ties: the lower filter type)."""
    sub = pixels.copy()
    sub[:, bpp:] -= pixels[:, :-bpp]
    up = pixels.copy()
    up[1:] -= pixels[:-1]
    candidates = np.stack([pixels, sub, up])                     # (3, h, n)
    cost = np.abs(candidates.view(np.int8).astype(np.int64)).sum(axis=2)
    kind = np.argmin(cost, axis=0)                               # (h,)
    rows = candidates[kind, np.arange(pixels.shape[0])]
    return np.concatenate([kind.astype(np.uint8)[:, None], rows], axis=1)


def encode(image: np.ndarray) -> bytes:
    """An (h, w), (h, w, 1), (h, w, 3) or (h, w, 4) uint8 array as PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8 pixels, not {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in COLOUR_TYPES:
        raise ValueError(f"PNG encode takes gray, RGB or RGBA, not shape {image.shape}")
    h, w, c = image.shape
    if h == 0 or w == 0:
        raise ValueError(f"PNG encode takes a non-empty image, not shape {image.shape}")
    rows = _filter_rows(np.ascontiguousarray(image).reshape(h, w * c), c)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOUR_TYPES[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), COMPRESS_LEVEL))
            + _chunk(b"IEND", b""))


def write(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(image))


def _chunks(data: bytes):
    """(kind, payload) of each chunk, CRCs checked, up to and with IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG file: no IEND chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG file: chunk {kind!r} runs past the end")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if crc != zlib.crc32(kind + payload) & 0xFFFFFFFF:
            raise ValueError(f"corrupt PNG file: CRC mismatch in chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _unfilter_sequential(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the one ``bpp`` to its
    left after reconstruction, so these go byte by byte."""
    f, b = row.tolist(), prior.tolist()
    out = [0] * len(f)
    for i, fi in enumerate(f):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            pred = (a + b[i]) >> 1
        else:
            c = b[i - bpp] if i >= bpp else 0
            p = a + b[i] - c
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        out[i] = (fi + pred) & 255
    return np.array(out, dtype=np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (h, w) uint8 for gray, (h, w, 3) for RGB, (h, w, 4) for RGBA."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file without an IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour} "
                         "(only 8-bit gray, RGB and RGBA are read)")
    if interlace != 0:
        raise ValueError("unsupported PNG: interlaced")
    if compression != 0 or filtering != 0:
        raise ValueError(f"unsupported PNG: compression {compression}, filter method {filtering}")
    c = CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) != h * (1 + w * c):
        raise ValueError(f"corrupt PNG image data: {len(raw)} bytes for {w}x{h}x{c}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prior = np.zeros(w * c, np.uint8)
    for r in range(h):
        kind, row = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            out[r] = row
        elif kind == 1:
            out[r] = np.cumsum(row.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r] = row + prior
        elif kind in (3, 4):
            out[r] = _unfilter_sequential(kind, row, prior, c)
        else:
            raise ValueError(f"corrupt PNG image data: filter type {kind} in row {r}")
        prior = out[r]
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
