"""The port's tail of tools against the JAX package, on the CPU: attention
introspection, the ImageNet graft (and phase 2's pretrained keys),
localization, sensor validation, the game clock and the human agent.

Tolerances: attention maps and the rollout 1e-5 (the same weights,
carried by the JAX package's ``convert_mmfn``); the graft, localization
(numpy float64 in both), validation, the clock and the human agent exact.
"""

import json
import math
import os
import pickle
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmfn_tpu.mapping.rough_map as jax_rough_map
import mmfn_tpu_torch.mapping.rough_map as port_rough_map
from mmfn_tpu.control import localization as jax_loc
from mmfn_tpu.data.batch import Batch as JaxBatch
from mmfn_tpu.harness.agents.base import Track as JaxTrack
from mmfn_tpu.harness.agents.human import HumanAgent as JaxHuman
from mmfn_tpu.harness.agents.human import KeyboardReader as JaxReader
from mmfn_tpu.harness.game_time import GameTime as JaxGameTime
from mmfn_tpu.harness.replay import ClosedLoopRunner as JaxRunner
from mmfn_tpu.harness.route import RouteConfig as JaxRouteConfig
from mmfn_tpu.harness.sensor_interface import SensorConfigurationInvalid as JaxInvalid
from mmfn_tpu.harness.validation import validate_sensor_configuration as jax_validate
from mmfn_tpu.models.gpt import FusionTransformer as JaxFusion
from mmfn_tpu.utils import introspection as jax_intro
from mmfn_tpu.utils.weights import CONVERTERS
from mmfn_tpu.utils.weights import load_imagenet_backbones as jax_graft

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.control import localization as port_loc
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.data.synthetic import synthetic_samples
from mmfn_tpu_torch.harness.agents.base import Track
from mmfn_tpu_torch.harness.agents.base import VehicleControl
from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent
from mmfn_tpu_torch.harness.agents.human import HumanAgent, KeyboardReader
from mmfn_tpu_torch.harness.game_time import GameTime
from mmfn_tpu_torch.harness.replay import ClosedLoopRunner
from mmfn_tpu_torch.harness.route import RouteConfig
from mmfn_tpu_torch.harness.sensor_interface import SensorConfigurationInvalid
from mmfn_tpu_torch.harness.validation import validate_sensor_configuration
from mmfn_tpu_torch.models.gpt import FusionTransformer
from mmfn_tpu_torch.models.registry import get_entry_point
from mmfn_tpu_torch.train import phase2
from mmfn_tpu_torch.utils import introspection as intro
from mmfn_tpu_torch.utils import weights as tw
from tests.test_harness import STRAIGHT_XODR
from tests.test_torch_models import _inputs
from tests.test_torch_serving import map_stem, port_and_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# --------------------------------------------------------------------------- #
# introspection
# --------------------------------------------------------------------------- #

def test_attention_maps_and_rollout_match_jax():
    port, jmodel, variables = port_and_jax("rad", 1, 6, "xla")
    data = _inputs(np.random.default_rng(6), 2, 64, 6)
    _, want = jax_intro.forward_with_intermediates(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}))
    out, got = intro.forward_with_intermediates(
        port, Batch(**{k: torch.from_numpy(v) for k, v in data.items()}))
    assert out.shape == (2, 4, 2)
    maps, want_maps = intro.attention_weights(got), jax_intro.attention_weights(want)
    assert sorted(maps) == sorted(want_maps) and len(maps) == 4
    for key, att in want_maps.items():
        assert maps[key].shape == att.shape
        np.testing.assert_allclose(maps[key], att, rtol=1e-5, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(maps[key].sum(-1), 1.0, atol=1e-5)
    for stage in ("transformer1", "transformer4"):
        r = intro.attention_rollout(got, stage)
        np.testing.assert_allclose(r, jax_intro.attention_rollout(want, stage),
                                   rtol=1e-5, atol=1e-5)
    img = intro.token_attention_image(maps["encoder/transformer4/block_0/attn"], 0, 3)
    np.testing.assert_allclose(img, jax_intro.token_attention_image(
        want_maps["encoder/transformer4/block_0/attn"], 0, 3), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fusion_transformer_maps_as_in_jax(impl):
    """The fused path forms no maps, in either package; the plain path's
    agree key for key."""
    jft = JaxFusion(n_embd=32, n_head=4, block_exp=2, n_layer=2, n_groups=3,
                    attn_impl=impl, precision=jax.lax.Precision.HIGHEST)
    grids = [np.random.default_rng(i).normal(size=(2, 8, 8, 32)).astype(np.float32)
             for i in range(3)]
    vel = np.ones((2,), np.float32)
    jv = jft.init(jax.random.PRNGKey(0), [jnp.asarray(g) for g in grids], vel, False)
    _, state = jft.apply(jv, [jnp.asarray(g) for g in grids], vel, False,
                         capture_intermediates=lambda m, _: type(m).__name__ == "SelfAttention")
    want = jax_intro.attention_weights(state["intermediates"])
    ft = FusionTransformer(32, 4, 2, 2, 3, attn_impl=impl).eval()
    ft.load_state_dict(tw.fusion_transformer_from_flax(jax.tree.map(np.asarray, jv["params"]),
                                                       2))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ft = ft

        def forward(self, batch):
            return self.ft([torch.from_numpy(g).permute(0, 3, 1, 2) for g in grids],
                           torch.from_numpy(vel))

    _, tree = intro.forward_with_intermediates(Wrap(), None)
    got = {k.removeprefix("ft/"): v for k, v in intro.attention_weights(tree).items()}
    assert sorted(got) == sorted(want)
    assert len(got) == (2 if impl == "xla" else 0)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# the ImageNet graft
# --------------------------------------------------------------------------- #

def _fake_resnet_sd(stage_sizes, seed):
    """A torchvision-keyed ResNet state dict (tests/test_parity_torch.py's)."""
    g = torch.Generator().manual_seed(seed)
    sd = {"conv1.weight": torch.randn(64, 3, 7, 7, generator=g),
          "fc.weight": torch.randn(1000, 512, generator=g),
          "fc.bias": torch.randn(1000, generator=g)}
    widths = (64, 128, 256, 512)
    for i, blocks in enumerate(stage_sizes):
        w, w_in = widths[i], widths[max(i - 1, 0)]
        for j in range(blocks):
            pre = f"layer{i + 1}.{j}"
            cin = w_in if j == 0 else w
            sd[f"{pre}.conv1.weight"] = torch.randn(w, cin, 3, 3, generator=g)
            sd[f"{pre}.conv2.weight"] = torch.randn(w, w, 3, 3, generator=g)
            for b in ("bn1", "bn2"):
                sd[f"{pre}.{b}.weight"] = torch.randn(w, generator=g)
                sd[f"{pre}.{b}.bias"] = torch.randn(w, generator=g)
                sd[f"{pre}.{b}.running_mean"] = torch.randn(w, generator=g)
                sd[f"{pre}.{b}.running_var"] = torch.rand(w, generator=g) + 0.5
                sd[f"{pre}.{b}.num_batches_tracked"] = torch.tensor(7)
            if j == 0 and i > 0:
                sd[f"{pre}.downsample.0.weight"] = torch.randn(w, cin, 1, 1, generator=g)
                for s in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{pre}.downsample.1.{s}"] = torch.randn(w, generator=g)
    for s in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{s}"] = torch.randn(64, generator=g)
    return sd


@pytest.fixture(scope="module")
def imagenet_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    torch.save(_fake_resnet_sd((3, 4, 6, 3), 0), d / "resnet34.pth")
    torch.save(_fake_resnet_sd((2, 2, 2, 2), 1), d / "resnet18.pth")
    return str(d / "resnet34.pth"), str(d / "resnet18.pth")


def _jax_tree(variant, sd):
    sd = {k: v.numpy() for k, v in sd.items()}
    if variant in ("vec", "rad"):
        sd.update(map_stem())
    return CONVERTERS[variant](sd, 1)


@pytest.mark.parametrize("variant", ["rad", "vec", "img", "aim", "transfuser"])
def test_graft_matches_jax(variant, imagenet_files):
    """The port's graft of a model's state dict equals the JAX package's graft
    of the same tree, carried back by from_flax_variables."""
    r34, r18 = imagenet_files
    entry = variant if variant in ("aim", "transfuser") else f"mmfn_{variant}"
    sd = get_entry_point(entry)(GlobalConfig(n_layer=1), device="cpu").state_dict()
    got = tw.load_imagenet_backbones(sd, resnet34_path=r34, resnet18_path=r18)
    tree = _jax_tree(variant, sd)
    params, stats = jax_graft(tree["params"], tree["batch_stats"], r34, r18)
    want = tw.from_flax_variables({"params": params, "batch_stats": stats}, variant, 1)
    assert set(want) <= set(got)
    changed = 0
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], w, rtol=0, atol=0, msg=k)
            changed += not torch.equal(got[k], sd[k])
    assert changed > 100
    lidar = [k for k in sd if "lidar_encoder._model.conv1." in k]
    for k in lidar:       # the 2-channel conv1 keeps its init
        assert torch.equal(got[k], sd[k])
    assert all(torch.equal(got[k], sd[k]) for k in sd if k.endswith("num_batches_tracked"))


def test_cilrs_takes_the_resnet18(imagenet_files):
    """CILRS's ResNet18 takes the ResNet18 file (the JAX package grafts the
    ResNet34's fitting blocks there); the controller is untouched."""
    r34, r18 = imagenet_files
    sd = get_entry_point("cilrs")(GlobalConfig(), device="cpu").state_dict()
    got = tw.load_imagenet_backbones(sd, resnet34_path=r34, resnet18_path=r18)
    tv = torch.load(r18, weights_only=True)
    prefix = "encoder.features."
    grafted = [k for k in sd if k.startswith(prefix) and not k.endswith("num_batches_tracked")]
    assert len(grafted) == 100
    for k in grafted:
        assert torch.equal(got[k], tv[k[len(prefix):]]), k
    for k in sd:
        if not k.startswith(prefix) or k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], sd[k]), k
    # only the ResNet34 file given: CILRS is unchanged
    only34 = tw.load_imagenet_backbones(sd, resnet34_path=r34)
    assert all(torch.equal(only34[k], sd[k]) for k in sd)


def test_phase2_grafts_the_pretrained_files(imagenet_files, tmp_path, monkeypatch):
    """phase2's pretrained_resnet34/18 keys graft before training (CILRS: the
    ResNet18); epochs=0 saves the grafted weights untrained."""
    r34, r18 = imagenet_files
    for split, seed in (("pro_train_fmmfn", 1), ("pro_eval_fmmfn", 2)):
        os.makedirs(tmp_path / split)
        for i, s in enumerate(synthetic_samples(4, 8, seed=seed, resolution=64)):
            with open(tmp_path / split / f"{i:04d}.pkl", "wb") as f:
                pickle.dump(s, f)
    assert phase2.main([
        "--config", os.path.join(ROOT, "run_steps", "config", "train.yaml"),
        f"data_folder={tmp_path / 'mmfn'}", f"logdir={tmp_path / 'log'}",
        "train_agent.entry_point=cilrs", "batch_size=2", "epochs=0", "device=cpu",
        "wandb_mode=disabled", f"pretrained_resnet34={r34}",
        f"pretrained_resnet18={r18}"]) == 0
    saved = torch.load(tmp_path / "log" / "model.pth", weights_only=True)
    tv = torch.load(r18, weights_only=True)
    assert torch.equal(saved["encoder.features.layer3.1.conv2.weight"], tv["layer3.1.conv2.weight"])
    assert torch.equal(saved["encoder.features.bn1.running_var"], tv["bn1.running_var"])


# --------------------------------------------------------------------------- #
# localization, validation, the game clock
# --------------------------------------------------------------------------- #

def test_localization_matches_jax_exactly():
    rng = np.random.default_rng(0)
    ops = (port_loc.LocalizationOperator(var_gnss=1.0), jax_loc.LocalizationOperator(var_gnss=1.0))
    for i in range(200):
        t = i * 0.05
        truth = np.array([10.0 * t, 0.5 * math.sin(t), 0.0])
        gnss = truth + rng.normal(scale=0.8, size=3)
        accel = np.array([0.0, 0.0, 9.81]) + rng.normal(scale=0.2, size=3)
        gyro = rng.normal(scale=0.05, size=3)
        rot = (10 * math.sin(t), 20 * t, -5.0)
        poses = []
        for loc, op in zip((port_loc, jax_loc), ops):
            imu = loc.IMUReading(accelerometer=accel, gyroscope=gyro,
                                 compass=math.pi / 2, timestamp=t)
            poses.append(op.update_pose(gnss, 10.0, imu, yaw_deg=rot[1],
                                        rotation=loc.Rotation(*rot), use_ekf=True))
        got, want = poses
        np.testing.assert_array_equal(got.location, want.location)
        np.testing.assert_array_equal(got.velocity, want.velocity)
        assert got.rotation.as_numpy_array().tolist() == want.rotation.as_numpy_array().tolist()
    for compass in (0.3, 5.0, float("nan")):
        assert port_loc.compass_to_yaw(compass, 2.0) == jax_loc.compass_to_yaw(compass, 2.0)
    q = port_loc.Quaternion.from_rotation(port_loc.Rotation(10, 45, -20))
    jq = jax_loc.Quaternion.from_rotation(jax_loc.Rotation(10, 45, -20))
    np.testing.assert_array_equal(q.matrix, jq.matrix)


def _suite():
    return MMFNAgent.sensors(object.__new__(MMFNAgent))


VALIDATION_CASES = {
    "mmfn_on_map": (_suite, "MAP", "MAP"),
    "opendrive_on_sensors": (_suite, "SENSORS", "SENSORS"),
    "wrong_track": (_suite, "MAP", "SENSORS"),
    "too_many_lidars": (lambda: [{"type": "sensor.lidar.ray_cast", "id": f"l{i}",
                                  "x": 0, "y": 0, "z": 0} for i in range(2)], "MAP", "MAP"),
    "too_far": (lambda: [{"type": "sensor.camera.rgb", "id": "c", "x": 5.0, "y": 0, "z": 0,
                          "width": 100, "height": 100, "fov": 90}], "MAP", "MAP"),
    "duplicated": (lambda: [{"type": "sensor.other.imu", "id": "a", "x": 0, "y": 0, "z": 0},
                            {"type": "sensor.other.gnss", "id": "a", "x": 0, "y": 0,
                             "z": 0}], "MAP", "MAP"),
    "illegal_type": (lambda: [{"type": "sensor.camera.depth", "id": "d"}], "MAP", "MAP"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_matches_jax(case):
    suite, track, selected = VALIDATION_CASES[case]
    outcomes = []
    for validate, tracks, invalid in ((validate_sensor_configuration, Track,
                                       SensorConfigurationInvalid),
                                      (jax_validate, JaxTrack, JaxInvalid)):
        try:
            validate(suite(), tracks[track], tracks[selected])
            outcomes.append("valid")
        except invalid as e:
            outcomes.append(str(e).replace("Track.", ""))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "valid") == (case == "mmfn_on_map")


def test_game_time_matches_jax():
    ticks = [(5, 0.25), (6, 0.30), (6, 0.35), (4, 0.1), (9, 0.45)]
    for clock in (GameTime, JaxGameTime):
        clock.restart()
    for tick in ticks:
        GameTime.on_carla_tick(tick)
        JaxGameTime.on_carla_tick(tick)
        assert (GameTime.get_time(), GameTime.get_frame()) == \
               (JaxGameTime.get_time(), JaxGameTime.get_frame())
    assert GameTime.get_time() == 0.45 and GameTime.get_frame() == 9
    GameTime.restart()
    JaxGameTime.restart()
    assert GameTime.get_time() == JaxGameTime.get_time() == 0.0


# --------------------------------------------------------------------------- #
# the human agent
# --------------------------------------------------------------------------- #

def test_human_agent_replay_drives_as_in_jax(map_tool, tmp_path, monkeypatch):
    monkeypatch.setattr(port_rough_map, "default_tool_path", lambda: map_tool)
    monkeypatch.setattr(jax_rough_map, "default_tool_path", lambda: map_tool)
    log = ([{"steer": 0.0, "throttle": 0.8, "brake": 0.0, "reverse": False}] * 30
           + [{"steer": 0.05, "throttle": 0.5, "brake": 0.0, "reverse": False}] * 10)
    path = tmp_path / "log.json"
    path.write_text(json.dumps(log))
    records = []
    for agent_cls, runner, config in ((HumanAgent, ClosedLoopRunner, RouteConfig),
                                      (JaxHuman, JaxRunner, JaxRouteConfig)):
        agent = agent_cls({"replay": str(path)})
        route = config(route_id="0", town="TownTest",
                       trajectory=[(0.0, 1.75, 0.0), (25.0, 1.75, 0.0)], index=0)
        records.append(runner(max_wall_seconds=120).run_route(agent, route, STRAIGHT_XODR,
                                                              max_ticks=60))
        c = agent.run_step({}, 0.0)        # past the log: the brake
        assert (c.brake, c.throttle) == (1.0, 0.0)
    got, want = records
    assert got.scores == want.scores and got.status == want.status
    assert got.scores["score_route"] > 0.0


class _StubReader:
    def render(self, rgb):
        pass

    def parse(self):
        return VehicleControl(steer=0.25, throttle=0.5)


def test_human_agent_records_as_in_jax(tmp_path):
    saved = []
    for agent_cls, name in ((HumanAgent, "port.json"), (JaxHuman, "jax.json")):
        agent = agent_cls({"record": str(tmp_path / name)})
        agent._reader = _StubReader()
        for _ in range(3):
            assert agent.run_step({"rgb": (0, np.zeros((300, 400, 4), np.uint8))},
                                  0.0).throttle == 0.5
        agent.destroy()
        saved.append((tmp_path / name).read_text())
    assert saved[0] == saved[1] and len(json.loads(saved[0])) == 3
    assert HumanAgent({}).sensors() == JaxHuman({}).sensors()


def test_keyboard_reader_headless_as_in_jax(monkeypatch):
    pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    controls = []
    for reader_cls in (KeyboardReader, JaxReader):
        reader = reader_cls()
        reader.render(np.zeros((300, 400, 3), np.uint8))
        c = reader.parse()
        controls.append((c.steer, c.throttle, c.brake, c.reverse))
    assert controls[0] == controls[1] == (0.0, 0.0, 0.0, False)


def test_profiling_timeit_and_trace(tmp_path):
    from mmfn_tpu_torch.utils.profiling import timeit, trace

    x = torch.ones(8, 8)
    dt = timeit(lambda a: (a * 2 + 1, {"n": 1}), x, iters=3, warmup=1)
    assert 0.0 < dt < 5.0
    with trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("aten::mm" in e.key for e in prof.key_averages())
