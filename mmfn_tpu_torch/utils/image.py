"""numpy counterparts of the OpenCV calls the port's tools make.

The JAX package's scripts draw with cv2, which the port does not use (the
GPU machine has none). Each function here equals the cv2 call named in its
docstring on the inputs the tools give it, pixel for pixel
(``tests/test_torch_scripts.py`` holds them to cv2):

- :func:`resize`: ``cv2.resize`` with ``INTER_LINEAR`` (half-pixel centres,
  border replication, each pass ``p + (q - p) * w`` rounded once to float32
  as cv2's fused multiply-add rounds it: exact at whole upscaling factors,
  as the attention heat maps have, and within a few float32 ulps at other
  factors) and ``INTER_NEAREST`` (``floor(dst * src / dst_size)``, not the
  half-pixel rule);
- :func:`apply_color_map`: ``cv2.applyColorMap`` with ``COLORMAP_JET`` or
  ``COLORMAP_VIRIDIS``, each a 256-entry BGR table copied from cv2;
- :func:`add_weighted`: ``cv2.addWeighted`` on uint8, float32 arithmetic
  ``a * alpha + (b * beta + gamma)`` with each multiply-add rounded once,
  then rounded half to even and saturated;
- :func:`gray_to_bgr`: ``cv2.cvtColor(..., COLOR_GRAY2BGR)``.

Colour images are (H, W, 3) numpy arrays in cv2's BGR channel order.
"""

from __future__ import annotations

import numpy as np

INTER_NEAREST = 0
INTER_LINEAR = 1
COLORMAP_JET = 2
COLORMAP_VIRIDIS = 16

# cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], ...)[:, 0]: BGR
_JET_BGR = bytes.fromhex("""
    8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000
    b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000
    e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00
    ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00
    ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00
    ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00
    ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00
    ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00
    feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e
    ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e
    9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e
    6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe
    3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee
    0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff
    00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff
    00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff
    007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff
    004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff
    001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0
    0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0
    0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090
    00008c000088000084000080
""")
_VIRIDIS_BGR = bytes.fromhex("""
    5401445602445704455905455a07465c08465d0a465e0b46600d47610e47631047641147
    6513476714486816486917486a18486c1a486d1b486e1c486f1d48701f48712048732148
    7423487524487625487726487828487929487a2a477a2c477b2d477c2e477d2f477e3046
    7e32467f3346803446813545813745823845833944833a44843b44843d43853e43853f42
    86404286414287424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d
    8a4e3d8a4f3c8b503c8b513b8b523b8b533a8c543a8c55398c56398c58388c59388c5a37
    8d5b378d5c368d5d368d5e358d5f358d60348d61348d62338d63338e64328e65328e6631
    8e67318e68318e69308e6a308e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c
    8e722c8e732c8e742b8e752b8e762a8e772a8e782a8e79298e7a298e7b298e7c288e7d28
    8e7e278e7f278e80278e81268e82268e82268e83258e84258e85258e86248e87248e8823
    8e89238d8a238d8b228d8c228d8d228d8e218d8f218d90218c91218c92208c92208c9320
    8c941f8b951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f
    88a01f88a11f87a11f87a21f86a32086a42085a52185a62185a72284a82283a92383aa24
    82ab2582ac2581ad2681ad2780ae287faf297fb02a7eb12c7db22d7cb32e7cb42f7bb531
    7ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d73bc3f72bd4071be4270bf44
    6fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c
    62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d177
    51d17a50d27c4ed37f4dd3814bd48449d58648d58946d68b45d68e43d79041d79340d895
    3ed8983cd99b3bd99d39daa037daa236dba534dba832dcaa30dcad2fddb02dddb22bdeb5
    29deb828deba26dfbd25dfc023dfc221e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d5
    19e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef1de5f11ee6f4
    20e6f621e6f823e7fb25e7fd
""")
_TABLES = {COLORMAP_JET: _JET_BGR, COLORMAP_VIRIDIS: _VIRIDIS_BGR}


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR source indices and float32 weight of the second
    tap, per destination index (half-pixel centres, borders replicated)."""
    fx = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    fx[(sx < 0) | (sx >= src - 1)] = 0.0
    sx = np.clip(sx, 0, src - 1)
    return sx, np.minimum(sx + 1, src - 1), fx


def _lerp(p: np.ndarray, q: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float32 ``p + (q - p) * w`` with the multiply-add rounded once."""
    diff = (q - p).astype(np.float32)
    return (p.astype(np.float64) + diff.astype(np.float64) * w).astype(np.float32)


def resize(src: np.ndarray, size, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(src, size, interpolation=...)`` of a (H, W) image;
    ``size`` is (width, height) as in cv2. INTER_LINEAR takes float32 (the
    tools resize float heat maps); INTER_NEAREST any dtype."""
    w, h = int(size[0]), int(size[1])
    src = np.asarray(src)
    if src.ndim != 2:
        raise ValueError(f"resize takes a (H, W) image, got {src.shape}")
    H, W = src.shape
    if interpolation == INTER_NEAREST:
        ys = np.minimum(np.floor(np.arange(h) * (H / h)).astype(np.int64), H - 1)
        xs = np.minimum(np.floor(np.arange(w) * (W / w)).astype(np.int64), W - 1)
        return src[ys][:, xs]
    if interpolation != INTER_LINEAR:
        raise ValueError(f"interpolation {interpolation} not supported")
    if src.dtype != np.float32:
        raise TypeError(f"INTER_LINEAR takes float32, got {src.dtype}")
    x0, x1, wx = _linear_taps(W, w)
    y0, y1, wy = _linear_taps(H, h)
    rows = _lerp(src[:, x0], src[:, x1], wx)
    return _lerp(rows[y0], rows[y1], wy[:, None])


def apply_color_map(gray: np.ndarray, colormap: int) -> np.ndarray:
    """``cv2.applyColorMap(gray, colormap)`` for a uint8 (H, W) image:
    (H, W, 3) uint8, BGR."""
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise TypeError(f"expected a (H, W) uint8 image, got {gray.dtype} {gray.shape}")
    table = np.frombuffer(_TABLES[colormap], np.uint8).reshape(256, 3)
    return table[gray]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` for uint8 images."""
    if a.dtype != np.uint8 or b.dtype != np.uint8 or a.shape != b.shape:
        raise TypeError("add_weighted takes two uint8 images of one shape")
    alpha, beta, gamma = np.float32(alpha), np.float32(beta), np.float32(gamma)
    inner = (b.astype(np.float64) * beta + gamma).astype(np.float32)
    out = (a.astype(np.float64) * alpha + inner).astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def gray_to_bgr(gray: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)``."""
    return np.repeat(np.asarray(gray)[..., None], 3, axis=-1)
