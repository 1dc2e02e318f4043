"""The serving pipeline's graph cache (``harness/agents/graphs.py``) on the
CPU, where no CUDA graph can run.

A stub stands in for the capture: its "graph" reruns the captured forward
into the same static output tensor, and counts no kernel launch, as a
replay on the card runs no Python. Against it the tests hold the cache's
bookkeeping: one capture per key, a new one when TF32, autocast, an
``attn_impl`` or a patched op function changes, launch counters that move
by the captured counts at each replay, replies that a later call does not
overwrite, a bounded cache, and a capture error that raises. A CPU pipeline
captures nothing; it is held to the JAX package's float64 waypoints stored
in ``benchmark/golden_rad_seed0.npz`` (recomputed from the JAX package by
``tests/test_torch_benchmark_golden.py``), at the benchmark's tolerance.

MMFN-rad at the golden file's size: n_layer 1, 64 px, 8 lanes; the stub
tests bin the LiDAR to a 32 x 32 grid (every 8th cell of the 256 x 256
one), which keeps them cheap on a loaded CPU.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from benchmark import golden
from benchmark.serve import WAYPOINT_TOL, compare, tf32
from mmfn_tpu_torch import ops
from mmfn_tpu_torch.harness.agents import TorchPipeline
from mmfn_tpu_torch.harness.agents import graphs
from mmfn_tpu_torch.harness.agents import pipeline as tpipe
from mmfn_tpu_torch.models import build_model, gpt
from mmfn_tpu_torch.ops import image as timage
from mmfn_tpu_torch.ops.attention import attention_plain
from mmfn_tpu_torch.ops.lidar import bev_histogram_plain

PPS = 512


class StubGraphs(graphs.ForwardGraphs):
    """``ForwardGraphs`` whose capture keeps the forward and whose replay
    reruns it into the static output, launch counters left as they were."""

    def _record(self, forward, static):
        output = forward(*static)

        def replay():
            before = graphs.launch_counts()
            output.copy_(forward(*static))
            for name, n in before.items():
                ops.KERNELS[name].launches = n

        return replay, output


def small_bev(points4):
    return bev_histogram_plain(points4)[:, ::8, ::8].contiguous()


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def cheap_bev(monkeypatch):
    monkeypatch.setattr(tpipe, "lidar_to_histogram_features", small_bev)


@pytest.fixture(scope="module")
def model():
    return build_model(golden.golden_config(), "rad",
                       torch.Generator().manual_seed(golden.SEED), device="cpu")


def stub_pipeline(model, stub=StubGraphs, **kw):
    pipe = TorchPipeline(model, model.config, points_per_sweep=PPS, device="cpu", **kw)
    assert pipe.graphs == [None]
    pipe.graphs = [stub(pipe.device, functools.partial(tpipe.device_inputs, device=pipe.device))]
    return pipe


def eager_pipeline(model, **kw):
    return TorchPipeline(model, model.config, points_per_sweep=PPS, device="cpu", **kw)


def payloads(seed, n):
    rng = np.random.default_rng(seed)
    cfg = golden.golden_config()
    out = []
    for _ in range(n):
        lanes = (rng.normal(size=(cfg.max_lanes, 10, 5)) * 10).astype(np.float32)
        out.append({"image": rng.integers(0, 256, (64, 64, 3)).astype(np.uint8),
                    "points": rng.uniform([-20, -30, -4], [20, 12, 2], (700, 3)).astype(np.float32),
                    "lanes": lanes, "lane_num": int(rng.integers(1, cfg.max_lanes + 1)),
                    "radar": rng.normal(size=(81, 5)).astype(np.float32), "map_img": None,
                    "target_point": (rng.normal(size=2) * 5).astype(np.float32),
                    "speed": float(abs(rng.normal()) * 3)})
    return out


def args(p):
    return (p["image"], p["points"], p["lanes"], p["lane_num"], p["radar"], p["map_img"],
            p["target_point"], p["speed"])


@contextlib.contextmanager
def attn_impl(model, impl):
    mods = [m for m in model.modules() if isinstance(m, gpt.SelfAttention)]
    for m in mods:
        m.attn_impl = impl
    try:
        yield
    finally:
        for m in mods:
            m.attn_impl = "pallas"


def test_one_capture_per_key_and_replies_outlive_later_calls(model):
    """Each reply, a warm-up's or a replay's, still holds the eager reply
    after every later call."""
    pipe, eager = stub_pipeline(model), eager_pipeline(model)
    ps = payloads(0, 3)
    singles = [pipe.dispatch(*args(p)) for p in ps]
    assert (pipe.graphs[0].captures, len(pipe.graphs[0])) == (1, 1)
    fleets = [pipe.dispatch_fleet(ps[:2]), pipe.dispatch_fleet(ps[1:])]
    assert (pipe.graphs[0].captures, len(pipe.graphs[0])) == (2, 2)
    for p, r in zip(ps, singles):
        np.testing.assert_array_equal(r.numpy(), eager(*args(p)))
    for f, part in zip(fleets, (ps[:2], ps[1:])):
        np.testing.assert_array_equal(f.numpy(), eager.dispatch_fleet(part).numpy())


def _patched(monkeypatch, owner, name, fn):
    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setattr(owner, name, fn)
            yield
    return ctx()


CHANGES = {
    "tf32": lambda model, mp: tf32(True),
    "autocast": lambda model, mp: torch.autocast("cpu", dtype=torch.bfloat16),
    "attn_impl": lambda model, mp: attn_impl(model, "xla"),
    "bev_function": lambda model, mp: _patched(
        mp, tpipe, "lidar_to_histogram_features", lambda x: small_bev(x)),
    "attention_function": lambda model, mp: _patched(mp, gpt, "fused_attention", attention_plain),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_state_change_captures_anew(model, monkeypatch, change):
    """Under the change the reply is the eager one under it, from a graph of
    its own; back outside, the first graph replays again. (bf16 on the CPU
    rounds by the inputs' alignment, so the autocast replies agree within
    the benchmark's waypoint limit, which a bf16 reply fails against f32.)"""
    pipe, eager = stub_pipeline(model), eager_pipeline(model)
    p = payloads(1, 1)[0]

    def reply(pipe):                         # bf16 under autocast
        return pipe.dispatch(*args(p)).float().numpy()

    first = reply(pipe)
    with CHANGES[change](model, monkeypatch):
        got, again, want = reply(pipe), reply(pipe), reply(eager)
    assert pipe.graphs[0].captures == 2
    np.testing.assert_array_equal(got, again)
    if change == "autocast":
        assert compare(got, want, WAYPOINT_TOL)["ok"]
        assert not compare(got, first, WAYPOINT_TOL)["ok"]
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reply(pipe), first)
    assert (pipe.graphs[0].captures, len(pipe.graphs[0])) == (2, 2)


def test_replays_advance_the_launch_counters(model, monkeypatch):
    """Each forward counts one BEV launch and 4 * n_layer attention launches
    (stand-ins that count as the CUDA wrappers do): the warm-up by running,
    each replay by the counts its graph recorded; the capture counts none."""
    def bev(x):
        ops.BEV_HIST.launches += 1
        return small_bev(x)

    def attention(q, k, v):
        ops.ATTENTION.launches += 1
        return attention_plain(q, k, v)

    monkeypatch.setattr(tpipe, "lidar_to_histogram_features", bev)
    monkeypatch.setattr(gpt, "fused_attention", attention)
    pipe, ps = stub_pipeline(model), payloads(2, 2)
    ops.reset_launch_counts()
    for p in ps + ps[:1]:
        pipe(*args(p))
    for _ in range(2):
        pipe.dispatch_fleet(ps)
    per_forward = {"bev_hist": 1, "fused_attention": 4 * model.config.n_layer}
    assert graphs.launch_counts() == {k: 5 * n for k, n in per_forward.items()}
    assert [g.launches for g in pipe.graphs[0]._graphs.values()] == [per_forward] * 2


def test_the_cache_is_bounded(model):
    """At most ``capacity`` graphs, the least recently replayed dropped with
    its layout's static inputs."""
    pipe, ps = stub_pipeline(model), payloads(4, 3)
    g = pipe.graphs[0]
    g.capacity = 2

    def widths():
        return sorted(layout[0][0][0] for layout, _ in g._graphs)

    for n in (1, 2, 3):
        pipe.dispatch_fleet(ps[:n])
    assert (g.captures, widths(), len(g._inputs)) == (3, [2, 3], 2)
    pipe.dispatch_fleet(ps[:2])                               # replayed: most recent
    pipe.dispatch_fleet(ps[:1])                               # drops 3
    assert (g.captures, widths(), len(g._inputs)) == (4, [1, 2], 2)
    pipe.dispatch_fleet(ps[:2])
    assert g.captures == 4


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_inputs_reach_the_static_set(model, packed):
    """Packed, ``_to_device`` writes the static inputs in place; unpacked,
    or given other tensors, ``_apply_batched`` copies them in first."""
    pipe, eager = stub_pipeline(model, packed=packed), eager_pipeline(model, packed=packed)
    ps = payloads(5, 2)
    rows = [[eager._host_args(*args(p))] for p in ps]
    first, second = pipe._to_device(rows[0]), pipe._to_device(rows[1])
    assert all(a is b for a, b in zip(first, second)) == packed
    want = eager._apply_batched(*eager._to_device(rows[1])).numpy()
    for given in (second, eager._to_device(rows[1])):
        np.testing.assert_array_equal(pipe._apply_batched(*given).numpy(), want)
    assert pipe.graphs[0].captures == 1


def test_a_capture_error_raises(model):
    class Refused(StubGraphs):
        def _record(self, forward, static):
            forward(*static)
            raise RuntimeError("capture refused")

    pipe = stub_pipeline(model, stub=Refused)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="capture refused"):
        pipe(*args(payloads(6, 1)[0]))
    assert len(pipe.graphs[0]) == 0 and set(graphs.launch_counts().values()) == {0}


def test_cpu_pipeline_captures_nothing_and_meets_the_jax_golden_file(model):
    """On the CPU ``cuda_graphs`` changes nothing: the forward runs eagerly,
    and meets the JAX package's float64 waypoints of the file's two
    samples, served as one fleet with the BEV counts shipped as
    ``host_bev`` ships them."""
    with np.load(golden.GOLDEN_FILE) as f:
        g = dict(f)
    pipes = [TorchPipeline(model, model.config, host_bev=host_bev, device="cpu", cuda_graphs=c)
             for host_bev in (True, False) for c in (True, False)]
    assert all(p.graphs == [None] for p in pipes)
    rows = [(g["image"][i], g["bev_counts"][i], g["lanes"][i], g["lane_num"][i],
             g["radar"][i], None, g["target_point"][i], g["velocity"][i]) for i in range(2)]
    for pipe in pipes[:2]:
        got = pipe._apply_batched(*pipe._to_device(rows)).numpy()
        check = compare(got, g["eval_waypoints"], golden.GOLDEN_TOL)
        assert check["ok"], check


def test_imagenet_constants_are_built_once_and_exact():
    """One (mean, std) pair per (device, dtype), normal tensors even when
    first built under inference mode, and the affine unchanged bit for
    bit."""
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 255, (2, 5, 5, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        got = timage.normalize_imagenet(x)
    mean, std = timage.imagenet_constants(x.device, torch.float32)
    again = timage.imagenet_constants(torch.device("cpu"), torch.float32)
    assert again[0] is mean and again[1] is std
    assert not mean.is_inference() and not std.is_inference()
    want = (x - torch.tensor((0.485, 0.456, 0.406))) / torch.tensor((0.229, 0.224, 0.225))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    y = x.clone().requires_grad_()
    timage.normalize_imagenet(y).sum().backward()
    np.testing.assert_array_equal(y.grad[0, 0, 0].numpy(), (1 / std).numpy())
