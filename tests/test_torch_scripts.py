"""The port's last tools and their helpers against the JAX package's scripts,
cv2 and PIL, on the CPU: ``utils/image.py`` against the cv2 calls the scripts
make, ``data/gif.py`` against PIL's decoder, and ``tools/viz_attention``,
``tools/render_birdview_samples`` and ``tools/record_episode`` against
``scripts/viz_attention.py``, ``scripts/render_birdview_samples.py`` and
``scripts/record_episode.py``.

Tolerances: every uint8 result exact, PNGs and GIF frames pixel for pixel.
The float ``INTER_LINEAR`` resize is exact at the heat maps' whole
upscaling factors (8 to 64 and to 256 pixels) and within rtol 1e-5 at other
factors. ``viz_attention`` is compared through the script's own ``overlay``
and drawing calls on the same attention maps (the maps themselves are held
to the JAX package's in tests/test_torch_tools.py); records are compared
without ``meta.duration_system``, the only wall-clock field.
"""

import importlib.util
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import mmfn_tpu.harness.result_writer as jax_result_writer
import mmfn_tpu.mapping.rough_map as jax_rough_map
from mmfn_tpu.utils.introspection import token_attention_image as jax_token_attention_image

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data import gif, png
from mmfn_tpu_torch.data.synthetic import synthetic_batch
from mmfn_tpu_torch.models import build_model
from mmfn_tpu_torch.tools import record_episode, render_birdview_samples, viz_attention
from mmfn_tpu_torch.utils import image
from mmfn_tpu_torch.utils.introspection import attention_weights, forward_with_intermediates
from tests.test_harness import STRAIGHT_XODR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layer=1, input_resolution=64, max_lanes=16)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def map_tool(tmp_path_factory):
    """native/rough_map_node.cpp built into this module's own directory."""
    path = tmp_path_factory.mktemp("rough_map_node") / "rough_map_node"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(path),
                    os.path.join(ROOT, "native", "rough_map_node.cpp")],
                   check=True, capture_output=True, timeout=300)
    return str(path)


def _script(name):
    """One of the JAX package's scripts/, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------------- #
# utils/image.py against cv2
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [64, 256])
def test_resize_linear_matches_cv2_at_the_heatmap_shapes(size):
    rng = np.random.default_rng(size)
    for scale in (1e-3, 1.0, 300.0):
        heat = (rng.random((8, 8)) * scale).astype(np.float32)
        want = cv2.resize(heat, (size, size), interpolation=cv2.INTER_LINEAR)
        got = image.resize(heat, (size, size), interpolation=image.INTER_LINEAR)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_resize_linear_at_other_factors_within_1e_5():
    rng = np.random.default_rng(1)
    for (h, w), (H, W) in (((13, 7), (50, 90)), ((8, 8), (96, 128)), ((50, 40), (20, 10))):
        src = rng.random((h, w)).astype(np.float32)
        np.testing.assert_allclose(image.resize(src, (W, H)),
                                   cv2.resize(src, (W, H), interpolation=cv2.INTER_LINEAR),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("src", [64, 192, 256])
def test_resize_nearest_matches_cv2(src):
    tokens = np.random.default_rng(src).integers(0, 256, (src, src)).astype(np.uint8)
    np.testing.assert_array_equal(
        image.resize(tokens, (512, 512), interpolation=image.INTER_NEAREST),
        cv2.resize(tokens, (512, 512), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("name", ["JET", "VIRIDIS"])
def test_color_map_table_matches_cv2(name):
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        image.apply_color_map(gray, getattr(image, f"COLORMAP_{name}")),
        cv2.applyColorMap(gray, getattr(cv2, f"COLORMAP_{name}")))


def test_add_weighted_and_gray_to_bgr_match_cv2():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(256, 256)
    b = np.ascontiguousarray(a.T)
    for alpha, beta, gamma in ((0.5, 0.5, 0), (0.3, 0.7, 0), (0.7, 0.6, -3.0)):
        np.testing.assert_array_equal(image.add_weighted(a, alpha, b, beta, gamma),
                                      cv2.addWeighted(a, alpha, b, beta, gamma))
    rgb = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(image.add_weighted(rgb, 0.5, rgb[::-1].copy(), 0.5, 0),
                                  cv2.addWeighted(rgb, 0.5, rgb[::-1].copy(), 0.5, 0))
    np.testing.assert_array_equal(image.gray_to_bgr(a), cv2.cvtColor(a, cv2.COLOR_GRAY2BGR))


# --------------------------------------------------------------------------- #
# data/gif.py against PIL
# --------------------------------------------------------------------------- #

def test_gif_decodes_in_pil_to_the_exact_frames():
    """Frames of 1 to 256 colours, long runs and noise (which fills the LZW
    table and makes the coder clear it): PIL's decode gives every frame, its
    duration and the loop back exactly."""
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    frames = [palette[rng.integers(0, n, (120, 97))] for n in (1, 2, 3, 17, 200, 256, 256)]
    frames.append(palette[(np.arange(120 * 97) // 7 % 4).reshape(120, 97)])
    with Image.open(io.BytesIO(gif.encode(frames, 200))) as im:
        assert im.n_frames == len(frames) and im.info["loop"] == 0
        for i, frame in enumerate(frames):
            im.seek(i)
            assert im.info["duration"] == 200
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), frame)


def test_gif_refuses_more_than_256_colours():
    frame = np.zeros((16, 17, 3), np.uint8)
    frame[..., 0] = np.arange(16 * 17).reshape(16, 17) % 256
    frame[..., 1] = np.arange(16 * 17).reshape(16, 17) // 256
    with pytest.raises(ValueError, match="at most 256 colours; this one has 272"):
        gif.encode([frame], 100)


# --------------------------------------------------------------------------- #
# the tools against the JAX package's scripts
# --------------------------------------------------------------------------- #

def test_render_birdview_samples_matches_the_jax_script(map_tool, tmp_path, monkeypatch):
    """The three panels, pixel for pixel, against the script's ``render``
    (its ``main`` writes into docs/img)."""
    script = _script("render_birdview_samples")
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    assert render_birdview_samples.STRAIGHT_XODR == STRAIGHT_XODR
    out = tmp_path / "port"
    assert render_birdview_samples.main(["--out", str(out), "--rmap-tool", map_tool]) == 0
    maps = {"straight": (STRAIGHT_XODR, (30.0, 1.75, 0.0))}
    for name, pose in (("loop", (30.0, 1.75, 0.0)), ("cross", (-14.0, 1.75, 0.0))):
        with open(os.path.join(ROOT, "data", "maps", f"fake_town_{name}.xodr")) as f:
            maps[name] = (f.read(), pose)
    assert sorted(os.listdir(out)) == sorted(f"birdview_{n}.png" for n in maps)
    for name, (xodr, pose) in maps.items():
        want = tmp_path / f"jax_{name}.png"
        script.render(xodr, pose, str(want))
        got = png.read(str(out / f"birdview_{name}.png"))
        assert got.shape == (256, 1024, 3)
        np.testing.assert_array_equal(got, png.read(str(want)))


def test_viz_attention_matches_the_jax_script(tmp_path):
    """The port's tool at n_layer 1 (64 px, 16 lanes, random weights from
    seed 0, on the CPU) against the script's drawing on the same maps and
    camera: the same files, pixel for pixel."""
    script = _script("viz_attention")
    cfg = GlobalConfig(**SMALL)
    out = tmp_path / "port"
    assert viz_attention.main(["--variant", "rad", "--out", str(out), "--device", "cpu"],
                              config=cfg) == 0

    model = build_model(cfg, "rad", torch.Generator().manual_seed(0), device="cpu")
    batch = synthetic_batch(1, max_lanes=cfg.max_lanes, seed=0, resolution=64, device="cpu")
    _, tree = forward_with_intermediates(
        model, batch, filter_fn=lambda m, name: type(m).__name__ == "SelfAttention")
    maps = attention_weights(tree)
    assert len(maps) == 4
    # scripts/viz_attention.py:main's drawing, with its own overlay
    want_dir = tmp_path / "jax"
    want_dir.mkdir()
    names = script.MODALITY_NAMES["rad"]
    cam = batch.image[0].numpy()
    cam = (255 * (cam - cam.min()) / (np.ptp(cam) + 1e-9)).astype(np.uint8)
    for path, att in sorted(maps.items()):
        stage = path.replace("/", "_")
        full = att.mean(axis=(0, 1))
        full_img = (255 * full / (full.max() + 1e-9)).astype(np.uint8)
        cv2.imwrite(str(want_dir / f"{stage}_tokens.png"), cv2.applyColorMap(
            cv2.resize(full_img, (512, 512), interpolation=cv2.INTER_NEAREST),
            cv2.COLORMAP_VIRIDIS))
        n_groups = att.shape[-1] // 64
        for qg in range(min(n_groups, len(names))):
            for kg in range(min(n_groups, len(names))):
                if qg != kg:
                    heat = jax_token_attention_image(att, qg, kg)
                    cv2.imwrite(str(want_dir / f"{stage}_{names[qg]}_to_{names[kg]}.png"),
                                script.overlay(cam, heat))
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(out)) == files and len(files) == 3 * 7 + 13
    for name in files:
        np.testing.assert_array_equal(png.read(str(out / name)),
                                      png.read(str(want_dir / name)), err_msg=name)


def test_record_episode_matches_the_jax_script(map_tool, tmp_path, monkeypatch):
    """The expert over a 30 m route of the cross town: the same route
    record and the same GIF frames (PIL's decode of both files), and the
    port's file holds the frames the tool drew."""
    script = _script("record_episode")
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    route = tmp_path / "route.xml"
    route.write_text('<routes><route id="7" town="TownCross">'
                     '<waypoint x="-80.0" y="1.75" z="0.0"/>'
                     '<waypoint x="-50.0" y="1.75" z="0.0"/></route></routes>')
    cross = os.path.join(ROOT, "data", "maps", "fake_town_cross.xodr")
    records = []
    fmt = jax_result_writer.format_route_record
    monkeypatch.setattr(jax_result_writer, "format_route_record",
                        lambda rec, title="": records.append(rec) or fmt(rec, title))
    monkeypatch.setattr(sys, "argv", ["record_episode.py", "--route", str(route), "--map", cross,
                                      "--out", str(tmp_path / "jax.gif")])
    script.main()

    record, frames = record_episode.record_episode(str(route), cross, rmap_tool=map_tool)
    port_gif = tmp_path / "port.gif"
    assert record_episode.main(["--route", str(route), "--map", cross, "--out", str(port_gif),
                                "--rmap-tool", map_tool]) == 0

    def comparable(rec):
        d = dict(rec.to_dict())
        d["meta"] = {k: v for k, v in d["meta"].items() if k != "duration_system"}
        return d
    assert record.status == "Completed", record.status
    assert comparable(record) == comparable(records[0])

    def decoded(path):
        """Each decoded frame once for every 200 ms it shows (PIL's writer
        merges equal consecutive frames into one of a longer duration)."""
        with Image.open(path) as im:
            out = []
            for i in range(im.n_frames):
                im.seek(i)
                assert im.info["duration"] % 200 == 0
                out += [np.asarray(im.convert("RGB"))] * (im.info["duration"] // 200)
            return out
    got, want = decoded(port_gif), decoded(tmp_path / "jax.gif")
    assert len(got) == len(want) == len(frames) >= 10
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(g, w)
    with Image.open(port_gif) as im:
        assert im.n_frames == len(frames) and im.info["loop"] == 0
