"""The port's ops (mmfn_tpu_torch.ops) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
port counterpart. The JAX Pallas kernels run in interpret mode, as
tests/test_ops.py runs them. The BEV histogram must match exactly; attention
within rtol/atol 1e-5 (f32 sums taken in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmfn_tpu.ops import image as jimage, pool as jpool, radar as jradar, resize as jresize
from mmfn_tpu.ops import lidar as jlidar
from mmfn_tpu.ops.attention import _fused_attention

from mmfn_tpu_torch.ops import attention as tattn, image as timage, lidar as tlidar
from mmfn_tpu_torch.ops import pool as tpool, radar as tradar, resize as tresize

F32_BELOW_16 = float(np.nextafter(np.float32(16.0), np.float32(0.0)))
F32_BELOW_8 = float(np.nextafter(np.float32(8.0), np.float32(0.0)))


def _cloud(rng, n):
    return rng.uniform(low=[-18, -26, -4], high=[18, 10, 2], size=(n, 3)).astype(np.float32)


def _edges():
    """Points on every bin edge the grid has: both left and right edges,
    interior bin boundaries, the height split, and just outside."""
    xs = [-16.0, 16.0, -16.125, 16.125, -0.125, 0.0, 15.875, 3.5]
    ys = [-24.0, 8.0, -24.125, 8.125, -0.125, 0.0, 7.875, -12.25]
    zs = [-2.0, -2.0001, -1.9999, 0.5]
    pts = np.array([[x, y, z] for x in xs for y in ys for z in zs], np.float32)
    return np.concatenate([pts, pts[:40]])      # repeats exercise the clip at 5


def _case(name):
    rng = np.random.default_rng(17)
    if name == "two_sweeps_2048":
        return tlidar.pad_points(_cloud(rng, 3500), 2 * 2048)
    if name == "edges":
        return tlidar.pad_points(_edges(), 1024)
    if name == "ragged_3000":
        return tlidar.pad_points(_cloud(rng, 3000), 3000)
    if name == "ragged_5001":
        return tlidar.pad_points(_cloud(rng, 4000), 5001)
    if name == "no_valid_rows":
        p = tlidar.pad_points(_cloud(rng, 2000), 2048)
        p[:, 3] = 0.0
        return p
    raise KeyError(name)


BEV_CASES = ["two_sweeps_2048", "edges", "ragged_3000", "ragged_5001", "no_valid_rows"]


@pytest.mark.parametrize("case", BEV_CASES)
def test_bev_plain_matches_pallas_xla_and_numpy(case):
    points4 = _case(case)
    got = tlidar.bev_histogram_plain(torch.from_numpy(points4)[None])[0].numpy()
    pallas = np.asarray(jlidar._bev_hist_pallas(jnp.asarray(points4), interpret=True))
    xla = np.asarray(jlidar._bev_hist_xla(jnp.asarray(points4)))
    oracle = jlidar.lidar_to_histogram_features_np(points4[points4[:, 3] > 0, :3])
    assert got.shape == (256, 256, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, oracle)
    # the wrapper takes the plain version for a CPU tensor, with or without a batch dim
    np.testing.assert_array_equal(
        tlidar.lidar_to_histogram_features(torch.from_numpy(points4)).numpy(), got)


def test_bev_plain_f16_transport_matches_pallas():
    """The serving pipeline ships the cloud in f16; bins are computed in f32
    from the f16 values on both sides."""
    points4 = _case("two_sweeps_2048").astype(np.float16)
    got = tlidar.bev_histogram_plain(torch.from_numpy(points4)[None])[0].numpy()
    pallas = np.asarray(jlidar._bev_hist_pallas(jnp.asarray(points4), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, tlidar.bev_histogram_plain(torch.from_numpy(points4.astype(np.float32))[None])[0])


def test_bev_plain_batched_matches_per_cloud():
    empty = np.zeros((4096, 4), np.float32)
    clouds = np.stack([_case("two_sweeps_2048"), empty, tlidar.pad_points(_edges(), 4096)])
    got = tlidar.bev_histogram_plain(torch.from_numpy(clouds)).numpy()
    for b in range(clouds.shape[0]):
        want = np.asarray(jlidar._bev_hist_pallas(jnp.asarray(clouds[b]), interpret=True))
        np.testing.assert_array_equal(got[b], want)


def test_bev_f32_rounding_edge_is_dropped():
    """The largest f32 below x=16 (or y=8) makes (x + 16) (or y + 24) round
    to 32 in f32, i.e. bin 256. The port drops such a point, as the JAX
    package's XLA path does; the float64 numpy oracle keeps it in bin 255.
    The JAX Pallas kernel drops the x case, but its one-hot over the stacked
    [below | above] y-bins routes a below-split point with y-bin 256 into
    the ABOVE channel's y-bin 0."""
    pts = np.array([[F32_BELOW_16, 0.0, 0.0], [0.0, F32_BELOW_8, -3.0],
                    [1.0, 1.0, 1.0]], np.float32)
    points4 = tlidar.pad_points(pts, 8)
    got = tlidar.bev_histogram_plain(torch.from_numpy(points4)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jlidar._bev_hist_xla(jnp.asarray(points4))))
    assert np.argwhere(got).tolist() == [[136, 200, 1]]      # only the interior point
    pallas = np.asarray(jlidar._bev_hist_pallas(jnp.asarray(points4), interpret=True))
    assert np.argwhere(pallas != got).tolist() == [[128, 0, 1]]
    oracle = jlidar.lidar_to_histogram_features_np(pts)
    assert oracle[255, 192, 1] == pytest.approx(0.2) and oracle[128, 255, 0] == pytest.approx(0.2)


def test_bev_kernel_normalizes_by_multiplying_exactly():
    """csrc/bev_hist.cu writes min(count, 5) * 0.2f, not min(count, 5) / 5:
    for every count a cell can hold the two are the same f32, so the kernel
    still equals bev_histogram_plain bit for bit."""
    counts = np.arange(0, 70000, dtype=np.int64)
    clipped = np.minimum(counts, int(tlidar.HIST_MAX_PER_PIXEL)).astype(np.float32)
    kernel = clipped * np.float32(0.2)
    plain = (torch.from_numpy(counts).clamp(max=int(tlidar.HIST_MAX_PER_PIXEL))
             .to(torch.float32) / tlidar.HIST_MAX_PER_PIXEL).numpy()
    np.testing.assert_array_equal(kernel, plain)


def test_bev_cluster_size_follows_the_batch():
    """One cloud gets a cluster of 16 blocks, more clouds 8 each: the faster
    size at batch 1 and at batch 8 on the GPU."""
    assert tlidar.cluster_size(1) == 16
    assert [tlidar.cluster_size(b) for b in (2, 8, 64)] == [8, 8, 8]
    assert {tlidar.cluster_size(b) for b in range(1, 9)} == set(tlidar.CLUSTERS)


def test_bev_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    pts = np.concatenate([_cloud(rng, 3000), _edges()])
    np.testing.assert_array_equal(tlidar.bev_counts_np(pts), jlidar.bev_counts_np(pts))
    np.testing.assert_array_equal(tlidar.pad_points(pts, 4096), jlidar.pad_points(pts, 4096))
    np.testing.assert_array_equal(tlidar.pad_points(pts, 100), jlidar.pad_points(pts, 100))


def test_transform_2d_points_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(500, 4)).astype(np.float32) * 20
    args = (0.3, 1.5, -2.0, -1.1, 4.0, 0.5)
    got = tlidar.transform_2d_points(torch.from_numpy(xyz), *args).numpy()
    want = np.asarray(jlidar.transform_2d_points(jnp.asarray(xyz), *args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[:, 2:], xyz[:, 2:])


def _torch_heads(a, layout):
    """(B, H, T, D) numpy -> a torch tensor of the same values, contiguous, or
    in the projection layout: the view(b, t, h, d).transpose(1, 2) of a
    contiguous (B, T, H*D) Linear output, as models/gpt.py hands it over."""
    if layout == "contiguous":
        return torch.from_numpy(a)
    b, h, t, d = a.shape
    proj = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(b, t, h * d))
    return proj.view(b, t, h, d).transpose(1, 2)


# every (T, D) of the fusion stages, T = 128 (three token groups of the
# TransFuser baseline's two), and a ragged T
ATTN_CASES = [(192, 16), (192, 32), (192, 64), (256, 128), (128, 32), (200, 64)]


@pytest.mark.parametrize("layout", ["contiguous", "projection"])
@pytest.mark.parametrize("t,d", ATTN_CASES)
def test_attention_plain_matches_pallas(t, d, layout):
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.normal(size=(2, 4, t, d)).astype(np.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           interpret=True))
    tq, tk, tv = (_torch_heads(x, layout) for x in (q, k, v))
    assert tq.is_contiguous() == (layout == "contiguous")
    # the kernel would read this layout in place
    strides = (t * 4 * d, d, 4 * d) if layout == "projection" else (4 * t * d, t * d, d)
    assert tattn._kernel_strides(tq, tk, tv) == (strides,) * 3
    got = tattn.attention_plain(tq, tk, tv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(tattn.fused_attention(tq, tk, tv).numpy(), got)


def test_attention_kernel_strides_accept_the_projection_layout_and_reject_the_rest():
    b, h, t, d = 2, 4, 200, 32
    proj = torch.zeros(b, t, h * d).view(b, t, h, d).transpose(1, 2)
    cont = torch.zeros(b, h, t, d)
    assert tattn._kernel_strides(proj, proj, proj) == ((t * h * d, d, h * d),) * 3
    assert tattn._kernel_strides(cont, cont, cont) == ((h * t * d, t * d, d),) * 3
    assert tattn._kernel_strides(proj, cont, proj)[1] == (h * t * d, t * d, d)
    with pytest.raises(ValueError, match="last dimension"):
        tattn._kernel_strides(cont, torch.zeros(b, h, d, t).transpose(2, 3), cont)
    shifted = torch.zeros(b, t, h * d + 1)[:, :, 1:].view(b, t, h, d).transpose(1, 2)
    assert shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte"):
        tattn._kernel_strides(cont, cont, shifted)
    odd_rows = torch.zeros(b, t, h * d + 2)[:, :, :h * d].view(b, t, h, d).transpose(1, 2)
    assert odd_rows.data_ptr() % 16 == 0 and odd_rows.stride(2) % 4 == 2
    with pytest.raises(ValueError, match="16-byte"):
        tattn._kernel_strides(odd_rows, cont, cont)
    bad_d = torch.zeros(b, h, t, 48)
    with pytest.raises(ValueError, match="head dim"):
        tattn._kernel_strides(bad_d, bad_d, bad_d)
    for bad_t in (0, tattn.MAX_TOKENS + 1):
        x = torch.zeros(1, 1, 1, d).expand(1, 1, bad_t, d)
        with pytest.raises(ValueError, match="range"):
            tattn._kernel_strides(x, x, x)
    with pytest.raises(ValueError, match="float32"):
        tattn._kernel_strides(cont, cont.double(), cont)
    with pytest.raises(ValueError, match="shape"):
        tattn._kernel_strides(cont, cont[:, :, :128], cont)
    with pytest.raises(ValueError, match="expected"):
        tattn._kernel_strides(cont[0], cont[0], cont[0])


def test_image_and_radar_ops_match_jax():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, size=(2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(timage.normalize_imagenet(torch.from_numpy(x)).numpy(),
                               np.asarray(jimage.normalize_imagenet(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    img = rng.integers(0, 256, size=(300, 400, 3), dtype=np.uint8)
    for scale, crop in ((1, 256), (2, 128)):
        np.testing.assert_array_equal(timage.scale_and_crop_image(img, scale, crop),
                                      jimage.scale_and_crop_image(img, scale, crop))
    radar = rng.normal(size=(3, 81, 5)).astype(np.float32)
    np.testing.assert_array_equal(tradar.radar_adjacency(torch.from_numpy(radar)).numpy(),
                                  np.asarray(jradar.radar_adjacency(jnp.asarray(radar))))
    np.testing.assert_array_equal(tradar.radar_adjacency_np(radar[0]),
                                  jradar.radar_adjacency_np(radar[0]))
    for n in (50, 81, 120):
        raw = rng.normal(size=(n, 5))
        np.testing.assert_array_equal(tradar.radar_to_size_np(raw), jradar.radar_to_size_np(raw))


@pytest.mark.parametrize("size", [64, 32, 16, 8, 12, 4])
def test_adaptive_pool_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 6)).astype(np.float32)
    want = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), (8, 8)))
    got = tpool.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), (8, 8))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((8, 8), (64, 64)), ((8, 8), (2, 2)),
                                     ((5, 7), (1, 1)), ((8, 8), (8, 8))])
def test_resize_matches_jax(src, dst):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2,) + src + (4,)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear_align_corners(jnp.asarray(x), dst))
    got = tresize.resize_bilinear_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
