"""The port's raw-data path against the JAX package's, on the CPU: the PNG
codec, the numpy LiDAR helpers, ``CarlaDataset``, ``preprocess_to_pickles``,
``check_data`` and the phase1 CLI, then the port's phase2 on its output.

- ``data/png.py`` against PIL both ways, exact pixels: gray, RGB and RGBA at
  odd widths; the filter types PIL writes (None, Sub, Up, Paeth) and all
  five; several IDAT chunks. Unsupported files raise ``ValueError``.
- ``data/host_ops.py:resize_bicubic_pil`` (the port's PIL-free downscale) equals
  PIL's ``resize``, exact.
- ``transform_2d_points_np`` and ``lidar_to_histogram_features_np`` equal the
  JAX package's, exact, with points on the grid's last edges.
- Two raw trees, one written by the JAX expert (PIL PNGs), one by the port's
  (``data/png.py``): each package's ``CarlaDataset`` reads both to equal
  samples, exact; the pickles are byte-equal; a spawned pool of 2 writes the
  serial pool's bytes, and its workers load no torch; ``check_data`` flags
  truncated frames as the JAX package's does.
- The port's phase1 CLI writes the JAX phase1 CLI's pools byte for byte,
  and the port's phase2 trains one epoch on them (n_layer 1, batch 4, CPU).
"""

import importlib.util
import io
import json
import os
import pickle
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data import dataset as jax_dataset
from mmfn_tpu.harness import replay as jreplay
from mmfn_tpu.harness.experts.agent import ExpertCollectionAgent as JaxExpert
from mmfn_tpu.harness.route import RouteConfig as JaxRouteConfig
from mmfn_tpu.mapping import rough_map as jax_rough_map
from mmfn_tpu.ops import lidar as jax_lidar

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data import dataset, host_ops, png
from mmfn_tpu_torch.data import phase1
from mmfn_tpu_torch.harness import replay
from mmfn_tpu_torch.harness.experts.agent import ExpertCollectionAgent
from mmfn_tpu_torch.harness.route import RouteConfig
from mmfn_tpu_torch.mapping.rough_map import RoughMap, build_rmap
from mmfn_tpu_torch.train import phase2
from tests.test_harness import STRAIGHT_XODR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAML = os.path.join(ROOT, "run_steps", "config", "train.yaml")
TICKS = 150                     # 14 frames a route: 8 samples


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread here: the test workers share the CPU, and
    torch's own thread pool oversubscribes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# the PNG codec
# --------------------------------------------------------------------------- #

CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}
SHAPES = ((1, 1), (7, 13), (31, 5), (300, 401))


def _image(rng, shape, channels):
    """Random pixels with flat, striped and gradient bands, so that every
    filter type wins some rows."""
    h, w = shape
    img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    img[h // 4:h // 2] = 40
    img[h // 2:3 * h // 4] = (np.arange(w)[None, :, None] * 3 + np.arange(channels)) % 256
    img[3 * h // 4:] = (np.arange(h - 3 * h // 4)[:, None, None] * 5
                        + np.arange(w)[None, :, None] * 2 + np.arange(channels)) % 256
    return img[:, :, 0] if channels == 1 else img


def _pil_png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="png")
    return buf.getvalue()


def _filter_types(data: bytes) -> set:
    """The filter type of every row of a PNG, read off its IDAT stream."""
    w, h, _, colour = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw[::1 + w * png.CHANNELS[colour]][:h].tolist())


@pytest.mark.parametrize("kind", list(CHANNELS))
def test_png_encodes_what_pil_reads(kind):
    rng = np.random.default_rng(3)
    for shape in SHAPES:
        img = _image(rng, shape, CHANNELS[kind])
        data = png.encode(img)
        got = np.asarray(Image.open(io.BytesIO(data)))
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("kind", list(CHANNELS))
def test_png_decodes_what_pil_writes(kind):
    rng = np.random.default_rng(4)
    seen, chunks = set(), 0
    noise = rng.integers(0, 256, (300, 401, CHANNELS[kind]), dtype=np.uint8)
    noise = noise[:, :, 0] if kind == "gray" else noise
    for img in [_image(rng, shape, CHANNELS[kind]) for shape in SHAPES] + [noise]:
        data = _pil_png(img)
        seen |= _filter_types(data)
        chunks = max(chunks, data.count(b"IDAT"))
        got = png.decode(data)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, img)
    assert {0, 1, 2, 4} <= seen, seen        # PIL's choices: no Average here
    assert chunks > 1, "a file with several IDAT chunks"


def _filtered(img, kinds):
    """Rows of ``img`` filtered with the given PNG filter types (the
    specification's definitions, byte by byte)."""
    h = img.shape[0]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for r, kind in enumerate(kinds):
        cur = rows[r]
        up = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _png_file(ihdr: bytes, raw: bytes, split: int = 1) -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    body = zlib.compress(raw)
    step = -(-len(body) // split)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + b"".join(chunk(b"IDAT", body[i:i + step]) for i in range(0, len(body), step))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", list(CHANNELS))
def test_png_decodes_every_filter_type(kind):
    """Rows filtered with each of the five types in turn, over 3 IDAT chunks:
    PIL and the port read the same pixels."""
    rng = np.random.default_rng(5)
    img = _image(rng, (40, 23), CHANNELS[kind])
    colour = png.COLOUR_TYPES[CHANNELS[kind]]
    data = _png_file(struct.pack(">IIBBBBB", 23, 40, 8, colour, 0, 0, 0),
                     _filtered(img, [r % 5 for r in range(40)]), split=3)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(png.decode(data), img)


def _unsupported():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    good = png.encode(img)
    raw = _filtered(img, [0] * 6)
    cases = {
        "16-bit": (Image.fromarray(img[:, :, 0].astype(np.uint16) * 257), "bit depth 16"),
        "palette": (Image.fromarray(img).convert("P"), "colour type 3"),
        "gray-alpha": (Image.fromarray(img).convert("LA"), "colour type 4"),
        "1-bit": (Image.fromarray(img[:, :, 0] > 128), "bit depth 1"),
    }
    out = {}
    for name, (pil, match) in cases.items():
        buf = io.BytesIO()
        pil.save(buf, format="png")
        out[name] = (buf.getvalue(), match)
    out["interlaced"] = (_png_file(struct.pack(">IIBBBBB", 5, 6, 8, 2, 0, 0, 1), raw),
                         "interlaced")
    out["truncated"] = (good[:len(good) - 20], "truncated")
    out["bad crc"] = (good[:40] + bytes([good[40] ^ 1]) + good[41:], "CRC")
    out["not png"] = (b"GIF89a" + good[6:], "signature")
    return out


@pytest.mark.parametrize("case", list(_unsupported()))
def test_png_refuses_what_it_cannot_read(case):
    data, match = _unsupported()[case]
    with pytest.raises(ValueError, match=match):
        png.decode(data)


def test_png_refuses_to_encode_what_it_cannot_write():
    with pytest.raises(ValueError, match="uint8"):
        png.encode(np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="gray, RGB or RGBA"):
        png.encode(np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_resize_matches_pil(kind):
    """The port's PIL-free downscale (scale_and_crop_image with scale > 1)."""
    rng = np.random.default_rng(7)
    for shape, size in (((300, 400), (200, 150)), ((301, 403), (134, 100)),
                        ((17, 9), (4, 8)), ((20, 30), (33, 41))):
        img = _image(rng, shape, CHANNELS[kind])
        want = np.asarray(Image.fromarray(img).resize(size))
        np.testing.assert_array_equal(host_ops.resize_bicubic_pil(img, *size), want)
    with pytest.raises(ValueError, match="RGBA"):
        host_ops.resize_bicubic_pil(np.zeros((4, 4, 4), np.uint8), 2, 2)


# --------------------------------------------------------------------------- #
# the numpy LiDAR helpers
# --------------------------------------------------------------------------- #

def test_lidar_numpy_helpers_match_jax():
    rng = np.random.default_rng(8)
    pts = np.concatenate([rng.uniform(-30, 30, (4000, 2)), rng.uniform(-4, 1, (4000, 1)),
                          rng.uniform(0, 1, (4000, 1))], axis=1)
    # the grid's edges: both lower edges, both last edges (which histogramdd
    # counts into the last bin), and just outside each
    edges = np.array([[-16.0, -24.0, -3.0, 1.0], [16.0, 8.0, -3.0, 1.0], [16.0, 8.0, 0.5, 1.0],
                      [16.0, 0.0, -3.0, 1.0], [0.0, 8.0, 0.5, 1.0],
                      [np.nextafter(16.0, 20.0), 0.0, -3.0, 1.0], [0.0, np.nextafter(8.0, 9.0),
                                                                   0.5, 1.0]])
    pts = np.concatenate([pts, edges, edges])
    for pose in ((0.3, 10.0, -4.0, 1.2, -3.0, 7.0), (np.pi / 2, 0.0, 0.0, np.pi / 2, 0.0, 0.0)):
        got = host_ops.transform_2d_points_np(pts, *pose)
        want = jax_lidar.transform_2d_points_np(pts, *pose)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    got, want = host_ops.lidar_to_histogram_features_np(pts), \
        jax_lidar.lidar_to_histogram_features_np(pts)
    assert got.dtype == want.dtype == np.float32 and got.shape == (256, 256, 2)
    np.testing.assert_array_equal(got, want)
    assert got[255, 255, 0] == got[255, 255, 1] == 0.4     # two on the corner, each channel


# --------------------------------------------------------------------------- #
# raw trees written by both experts
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """<root>/mmfn/{Port,Jax}Town_short/route_00: one straight-road route
    collected by each package's expert (PNG frames, 3 background vehicles),
    and the map tool (built with g++ into this module's own directory)."""
    base = tmp_path_factory.mktemp("raw")
    tool = str(base / "rough_map_node")
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", tool,
                    os.path.join(ROOT, "native", "rough_map_node.cpp")],
                   check=True, capture_output=True, timeout=300)
    od = base / "straight" / "opendrive"
    od.mkdir(parents=True)
    (od / "opstr.txt").write_text(STRAIGHT_XODR)
    assert not build_rmap([str(od)], tool_path=tool)
    trajectory = [(0.0, 1.75, 0.0), (150.0, 1.75, 0.0)]
    for name, mod, expert, route, rough, cfg in (
            ("Port", replay, ExpertCollectionAgent, RouteConfig, RoughMap, GlobalConfig()),
            ("Jax", jreplay, JaxExpert, JaxRouteConfig, jax_rough_map.RoughMap, JaxConfig())):
        signals, background = mod.route_environment(rough().read(str(od / "a.rmap")),
                                                    trajectory, traffic=3, seed=1)
        agent = expert({"rmap_tool": tool, "tmp_dir": str(base / f"{name}_map"),
                        "config": cfg, "seed": 2, "image_ext": "png",
                        "save_path": str(base / "mmfn" / f"{name}Town_short" / "route_00")})
        mod.ClosedLoopRunner(max_wall_seconds=600).run_route(
            agent, route(route_id="0", town="T", trajectory=trajectory, index=0),
            STRAIGHT_XODR, max_ticks=TICKS, signals=signals, background=background)
    return base


def _town(raw_root, name):
    return str(raw_root / "mmfn" / f"{name}Town_short")


def _assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("writer", ["Port", "Jax"])
def test_carla_dataset_matches_jax(raw_root, writer):
    """Each package's CarlaDataset reads the tree either expert wrote to the
    same samples."""
    town = _town(raw_root, writer)
    got = dataset.CarlaDataset([town], GlobalConfig(), use_preload=False)
    want = jax_dataset.CarlaDataset([town], JaxConfig(), use_preload=False)
    assert got.frames == want.frames
    assert len(got) == 8
    for i in range(len(want)):
        _assert_samples_equal(got[i], want[i])
    sample = got[len(got) - 1]
    assert sample["image"].shape == (256, 256, 3) and sample["lidar_bev"].max() > 0
    assert sample["map_img"].max() > 0 and sample["waypoints"][-1, 1] < -0.5


def test_preload_index_reads_in_both_packages(raw_root, tmp_path):
    """The index one package caches next to the routes loads in the other."""
    for writer_cls, reader_cls, cfgs in (
            (dataset.CarlaDataset, jax_dataset.CarlaDataset, (GlobalConfig(), JaxConfig())),
            (jax_dataset.CarlaDataset, dataset.CarlaDataset, (JaxConfig(), GlobalConfig()))):
        town = str(tmp_path / writer_cls.__module__ / "PortTown_short")
        shutil.copytree(_town(raw_root, "Port"), town)
        written = writer_cls([town], cfgs[0])
        assert os.path.exists(os.path.join(town, "preload_index_1_4.json"))
        shutil.rmtree(os.path.join(town, "route_00", "rgb_front"))   # indexing must not look
        assert reader_cls([town], cfgs[1]).frames == written.frames


@pytest.mark.parametrize("writer", ["Port", "Jax"])
def test_pickles_match_jax(raw_root, tmp_path, writer):
    town = _town(raw_root, writer)
    got_n = dataset.preprocess_to_pickles(
        dataset.CarlaDataset([town], GlobalConfig(), use_preload=False), str(tmp_path / "port"))
    want_n = jax_dataset.preprocess_to_pickles(
        jax_dataset.CarlaDataset([town], JaxConfig(), use_preload=False), str(tmp_path / "jax"))
    assert got_n == want_n == 8
    _assert_pools_equal(tmp_path / "port", tmp_path / "jax")


def _assert_pools_equal(got_dir, want_dir):
    names = sorted(n for n in os.listdir(want_dir) if n.endswith(".pkl"))
    assert sorted(n for n in os.listdir(got_dir) if n.endswith(".pkl")) == names and names
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as f, \
                open(os.path.join(want_dir, name), "rb") as g:
            assert f.read() == g.read(), name


def test_pool_matches_serial(raw_root, tmp_path):
    """Two spawned workers write the serial run's bytes."""
    ds = dataset.CarlaDataset([_town(raw_root, "Port"), _town(raw_root, "Jax")],
                              GlobalConfig(), use_preload=False)
    assert dataset.preprocess_to_pickles(ds, str(tmp_path / "serial")) == 16
    assert dataset.preprocess_to_pickles(ds, str(tmp_path / "pool"), workers=2) == 16
    _assert_pools_equal(tmp_path / "pool", tmp_path / "serial")


def test_phase1_workers_start_without_torch():
    """A spawned phase1 worker imports the CLI's module as its ``__main__``
    and, through it, the dataset and its numpy helpers: none of that loads
    torch."""
    code = "import sys, mmfn_tpu_torch.data.phase1; sys.exit('torch' in sys.modules)"
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0


def test_check_data_flags_truncated_frames(raw_root, tmp_path):
    """A truncated camera PNG and a truncated LiDAR file: check_data names
    the samples that read them, as the JAX package's does."""
    town = str(tmp_path / "PortTown_short")
    shutil.copytree(_town(raw_root, "Port"), town)
    ds = dataset.CarlaDataset([town], GlobalConfig(), use_preload=False)
    assert dataset.check_data(ds) == []
    for sample, sub, ext in ((2, "rgb_front", "png"), (5, "lidar", "npy")):
        path = os.path.join(town, "route_00", sub, f"{ds.frames[sample]['ids'][0]:04d}.{ext}")
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    assert dataset.check_data(ds) == [2, 5]
    assert jax_dataset.check_data(jax_dataset.CarlaDataset(
        [town], JaxConfig(), use_preload=False)) == [2, 5]


# --------------------------------------------------------------------------- #
# the phase1 CLI, then phase2
# --------------------------------------------------------------------------- #

def test_phase1_cli_matches_jax_and_feeds_phase2(raw_root, tmp_path, monkeypatch):
    """Both phase1 CLIs on copies of the same raw trees write byte-equal
    pools; the port's phase2 then trains one epoch on the port's."""
    roots = {}
    for who in ("port", "jax"):
        roots[who] = tmp_path / who / "mmfn"
        shutil.copytree(raw_root / "mmfn", roots[who])
    args = ["--config", TRAIN_YAML, "train_towns=[PortTown]", "val_towns=[JaxTown]"]
    assert phase1.main(args + [f"data_folder={roots['port']}", "workers=0"]) == 0
    spec = importlib.util.spec_from_file_location(
        "jax_phase1_preprocess_data", os.path.join(ROOT, "run_steps",
                                                   "phase1_preprocess_data.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(sys, "argv", ["phase1_preprocess_data.py"] + args
                        + [f"data_folder={roots['jax']}"])
    jax_cli.main()
    for split in ("train", "eval"):
        _assert_pools_equal(tmp_path / "port" / f"pro_{split}_fmmfn",
                            tmp_path / "jax" / f"pro_{split}_fmmfn")
    with open(tmp_path / "port" / "pro_train_fmmfn" / "0.pkl", "rb") as f:
        assert pickle.load(f)["image"].shape == (256, 256, 3)

    logdir = tmp_path / "log"
    assert phase2.main(["--config", TRAIN_YAML, f"data_folder={roots['port']}",
                        f"logdir={logdir}", "device=cpu", "batch_size=4", "epochs=1",
                        "val_every=1", "train_agent.entry_point=mmfn_rad", "model.n_layer=1",
                        "wandb_mode=disabled"]) == 0
    log = json.loads((logdir / "recent.log").read_text())
    assert (log["epoch"], log["iter"], len(log["val_loss"])) == (1, 2, 1)
    assert all(np.isfinite(log["train_loss"] + log["val_loss"]))
    assert (logdir / "best_model.pth").exists()
    shutil.rmtree(logdir)       # about 1 GB of checkpoints
