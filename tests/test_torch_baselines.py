"""The port's baselines (AIM, CILRS, TransFuser) against the JAX package's,
on the CPU: models, weight names, one train step, the phase2 CLI, the
closed-loop BaselineAgent and the host-side control code it copies.

Weights. Each JAX baseline's variable tree comes from ``jax.eval_shape`` of
its ``init``, and every leaf is drawn with numpy in the family of the JAX
init (kaiming-normal convs, uniform Dense and GRU kernels); its
constant-initialised leaves (norm scales and biases, BN statistics,
position embeddings) are then randomised with ``_randomise`` of
tests/test_torch_models.py. A jitted flax ``init`` takes 10-20 s per
baseline on a CPU, the shapes alone about 1 s. The tree is carried across
with ``from_flax_variables``; JAX runs at matmul_precision "highest". Sizes:
n_layer 1, 64-px camera, 8 lanes, unless a test says otherwise.

Tolerances: waypoints rtol 1e-4 / atol 2e-3 (tests/test_torch_models.py);
CILRS steer, throttle, brake and velocity rtol 1e-4 / atol 1e-5; vehicle
controls 1e-4. One f32 train step: the loss at rtol 1e-5, each gradient
tensor at its module's relative-L2 bound in TRAIN_GRAD_BOUNDS, about twice
the JAX package's own f32 error against its float64 step there, floored at
1e-6 of the largest gradient element (the method of
tests/test_torch_train_parity.py). Measured at these settings, the JAX f32
error against float64 is: AIM image encoder 1.9e-2, join 4.6e-5, GRU 8.0e-6,
output 2.3e-6; CILRS encoder 1.3e-2, velocity input 5.2e-7, velocity head
2.9e-5, branches 1.6e-5; the port differs from JAX f32 by 0.97-1.17 times
that in every module.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.control.pid import WaypointController as JaxWaypointController
from mmfn_tpu.control.planner import GPS_SCALE as JAX_GPS_SCALE
from mmfn_tpu.control.planner import RoutePlanner as JaxRoutePlanner
from mmfn_tpu.data.batch import Batch as JaxBatch
from mmfn_tpu.harness.agents.baseline import BaselineAgent as JaxBaselineAgent
from mmfn_tpu.harness.events import RoadOption as JaxRoadOption
from mmfn_tpu.harness.route import downsample_route as jax_downsample_route
from mmfn_tpu.models import get_entry_point as jax_entry_point
from mmfn_tpu.train.engine import TrainState as JaxTrainState
from mmfn_tpu.train.engine import make_train_step as jax_make_train_step
from mmfn_tpu.utils.weights import convert_aim, convert_cilrs, convert_transfuser

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.control.pid import WaypointController
from mmfn_tpu_torch.control.planner import GPS_SCALE, RoutePlanner
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.data.synthetic import synthetic_samples
from mmfn_tpu_torch.harness.agents import BaselineAgent
from mmfn_tpu_torch.harness.route import RoadOption, downsample_route
from mmfn_tpu_torch.models import build_baseline, get_entry_point
from mmfn_tpu_torch.models.baselines import BASELINES, MODELS
from mmfn_tpu_torch.models.gpt import SelfAttention
from mmfn_tpu_torch.train import create_train_state, make_train_step
from mmfn_tpu_torch.utils import weights as tw
from tests.test_torch_models import _inputs, _randomise
from tests.test_torch_train import _phase2_twice, _pool

N_LAYER, RES, LANES, PPS = 1, 64, 8, 2048
WAYPOINT_TOL = dict(rtol=1e-4, atol=2e-3)
CONTROL_TOL = dict(rtol=1e-4, atol=1e-5)
CONVERTERS = {"aim": convert_aim, "cilrs": convert_cilrs,
              "transfuser": lambda sd: convert_transfuser(sd, N_LAYER)}
TRAIN_GRAD_BOUNDS = {
    "aim": {"image_encoder": 4e-2, "join": 1e-4, "decoder": 2e-5, "output": 5e-6},
    "cilrs": {"encoder": 3e-2, "controller.vel_in": 2e-6, "controller.vel_out": 6e-5,
              "controller.branches": 4e-5},
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    kw = dict(n_layer=N_LAYER, max_lanes=LANES, input_resolution=RES, **kw)
    return JaxConfig(matmul_precision="highest", **kw), GlobalConfig(**kw)


def _draw(shapes, rng):
    """numpy leaves for a tree of ShapeDtypeStructs, in the JAX init's
    families; the constant-initialised leaves start at their constants."""
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = _draw(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel" and len(shape) == 4:          # conv (kh, kw, I, O), fan-out
            a = rng.normal(0, np.sqrt(2.0 / (shape[0] * shape[1] * shape[3])), shape)
        elif k == "kernel" or k.startswith(("weight_", "bias_")):
            a = rng.uniform(-1, 1, shape) / np.sqrt(shape[0] if k == "kernel" else 64)
        elif k in ("scale", "var"):
            a = np.ones(shape)
        else:                                           # bias, mean, pos_emb
            a = np.zeros(shape)
        out[k] = a.astype(np.float32)
    return out


def _command(b):
    return np.arange(b, dtype=np.int32) % 6 + 1


def _model_args(name, jbatch, command):
    return (jbatch, jnp.asarray(command)) if name == "cilrs" else (jbatch,)


class Pair:
    """One baseline's JAX model, randomised variables and port model on the
    same weights, and a batch of 2 inputs."""

    def __init__(self, name, seed=0):
        attn = "pallas" if name == "transfuser" else "xla"
        self.name = name
        self.jcfg, self.cfg = _configs(attn_impl="xla")
        self.jmodel = jax_entry_point(name)(self.jcfg)
        self.data = _inputs(np.random.default_rng(seed), 2, RES, LANES)
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in self.data.items()})
        shapes = jax.eval_shape(
            lambda: self.jmodel.init({"params": jax.random.PRNGKey(seed),
                                      "dropout": jax.random.PRNGKey(seed + 1)},
                                     *_model_args(name, jbatch, _command(2)), False))
        rng = np.random.default_rng(seed + 2)
        self.variables = {"params": _randomise(_draw(shapes["params"], rng), rng),
                          "batch_stats": _randomise(_draw(shapes["batch_stats"], rng), rng,
                                                    stats=True)}
        with torch.device("meta"):          # no weights drawn: all are assigned
            self.port = MODELS[name](self.cfg.replace(attn_impl=attn))
        self.port.load_state_dict(tw.from_flax_variables(self.variables, name, N_LAYER),
                                  strict=True, assign=True)
        self.port.eval()
        self.cache = {}


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(name):
        if name not in made:
            made[name] = Pair(name)
        return made[name]
    return get


def _jax_forward(pair, data, command):
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    out = jax.jit(pair.jmodel.apply, static_argnums=(3 if pair.name == "cilrs" else 2,))(
        pair.variables, *_model_args(pair.name, jbatch, command), False)
    return [np.asarray(o) for o in out] if pair.name == "cilrs" else np.asarray(out)


def _port_forward(model, data, command):
    batch = Batch(**{k: torch.from_numpy(v) for k, v in data.items()})
    with torch.no_grad():
        if model.variant == "cilrs":
            return [o.numpy() for o in model(batch, torch.from_numpy(command))]
        return model(batch).numpy()


# --------------------------------------------------------------------------- #
# models and weights
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", BASELINES)
def test_baseline_forward_matches_jax(pairs, name):
    pair = pairs(name)
    command = _command(2)
    want = _jax_forward(pair, pair.data, command)
    got = _port_forward(pair.port, pair.data, command)
    if name == "cilrs":
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **CONTROL_TOL)
        assert [g.shape for g in got] == [(2,), (2,), (2,), (2, 1)]
    else:
        assert got.shape == want.shape == (2, 4, 2) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **WAYPOINT_TOL)


def test_transfuser_fused_attention_path_equals_the_plain_one(pairs):
    """attn_impl "pallas" (on the CPU the kernel's plain version) gives the
    "xla" path's waypoints, and every fusion stage takes it (T = 128)."""
    pair = pairs("transfuser")
    attn = [m for m in pair.port.modules() if isinstance(m, SelfAttention)]
    assert len(attn) == 4 * N_LAYER and all(m.attn_impl == "pallas" for m in attn)
    assert {m.pos_emb.shape[1] for m in (getattr(pair.port.encoder, f"transformer{i}")
                                         for i in range(1, 5))} == {128}
    fused = _port_forward(pair.port, pair.data, None)
    for m in attn:
        m.attn_impl = "xla"
    try:
        plain = _port_forward(pair.port, pair.data, None)
    finally:
        for m in attn:
            m.attn_impl = "pallas"
    np.testing.assert_allclose(fused, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", BASELINES)
def test_reference_names_round_trip_through_the_jax_converter(pairs, name):
    """The port's state_dict, read by JAX's convert_{aim,cilrs,transfuser},
    gives the JAX tree, and back through from_flax_variables the same
    state_dict: key for key, exactly."""
    pair = pairs(name)
    sd = pair.port.state_dict()
    back = CONVERTERS[name]({k: v.numpy() for k, v in sd.items()})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(pair.variables))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat_got) == set(flat_want)
    for path, want in flat_want.items():
        np.testing.assert_array_equal(flat_got[path], want, err_msg=str(path))
    again = tw.from_flax_variables(back, name, N_LAYER)
    assert list(again) == list(sd)
    for k, v in sd.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k


@pytest.mark.parametrize("name", BASELINES)
def test_reference_state_dict_loads_strictly(pairs, name):
    pair = pairs(name)
    sd = {f"module.{k}": v.clone() for k, v in pair.port.state_dict().items()}
    fresh = get_entry_point(name)(pair.cfg, torch.Generator().manual_seed(9), device="cpu")
    tw.load_reference_state_dict(fresh, sd)
    for k, v in pair.port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(RuntimeError):
        tw.load_reference_state_dict(fresh, {**sd, "bogus.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError):
        tw.load_reference_state_dict(fresh, dict(list(sd.items())[1:]))


def test_cilrs_command_selects_the_branch(pairs):
    """Command 0 selects no branch (zero control: steer -1, throttle and
    brake 0); in a mixed batch each row takes its own command's branch."""
    pair = pairs("cilrs")
    data = _inputs(np.random.default_rng(7), 6, RES, LANES)
    mixed = _port_forward(pair.port, data, np.array([3, 0, 6, 1, 5, 2], np.int32))
    for row, c in enumerate([3, 0, 6, 1, 5, 2]):
        alone = _port_forward(pair.port, data, np.full(6, c, np.int32))
        for m, a in zip(mixed[:3], alone[:3]):
            np.testing.assert_allclose(m[row], a[row], rtol=1e-6, atol=1e-7)
    zero = _port_forward(pair.port, data, np.zeros(6, np.int32))
    np.testing.assert_array_equal(zero[0], -1.0)
    np.testing.assert_array_equal(zero[1], 0.0)
    np.testing.assert_array_equal(zero[2], 0.0)
    assert np.ptp(np.stack(mixed[1])) > 0            # the branches differ
    np.testing.assert_allclose(mixed[3], zero[3], rtol=1e-6)   # velocity: no command


def test_baselines_run_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GlobalConfig(n_layer=N_LAYER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_baseline("cilrs", cfg)
    model = build_baseline("cilrs", cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BaselineAgent({"kind": "cilrs", "model": model, "config": cfg})
    with pytest.raises(ValueError, match="kind 'aim' but the model is 'cilrs'"):
        BaselineAgent({"kind": "aim", "model": model, "config": cfg, "device": "cpu"})
    with pytest.raises(ValueError, match="baseline must be one of"):
        build_baseline("mmfn_rad", cfg, device="cpu")


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

def _gradient_keeper():
    """An optax transformation whose state is the last gradient tree and
    whose update is zero: JAX's own train step then hands back its grads."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _train_run(pair):
    """One f32 train step of both packages from the pair's weights on one
    batch of 4: (JAX loss, JAX grads, port loss, port grads), the grads in
    the port's keys."""
    if "train" not in pair.cache:
        rng = np.random.default_rng(10)
        data = _inputs(rng, 4, RES, LANES)
        data.update(waypoints=rng.normal(size=(4, 4, 2)).astype(np.float32),
                    command=np.array([1, 3, 4, 6], np.int32),
                    action=rng.uniform(0, 1, size=(4, 3)).astype(np.float32))
        tx = _gradient_keeper()
        params, stats = (jax.tree.map(jnp.asarray, pair.variables[c])
                         for c in ("params", "batch_stats"))
        state = JaxTrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32))
        new, jloss = jax_make_train_step(pair.jmodel, tx)(
            state, JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()}),
            jax.random.PRNGKey(3))
        jgrads = tw.from_flax_variables(jax.tree.map(np.asarray, {
            "params": new.opt_state, "batch_stats": new.batch_stats}), pair.name, N_LAYER)
        port = copy.deepcopy(pair.port)
        loss = make_train_step()(create_train_state(port, pair.cfg),
                                 Batch(**{k: torch.from_numpy(v) for k, v in data.items()}), 0)
        pair.cache["train"] = (float(jloss), jgrads, float(loss),
                               {k: p.grad for k, p in port.named_parameters()})
    return pair.cache["train"]


@pytest.mark.parametrize("name", ["aim", "cilrs"])
def test_train_step_loss_matches_jax(pairs, name):
    """The L1 waypoint loss for AIM, the CILRS control loss on the command
    and action labels for CILRS."""
    jloss, _, loss, _ = _train_run(pairs(name))
    assert np.isfinite(loss) and loss == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("name", ["aim", "cilrs"])
def test_train_step_gradients_match_jax(pairs, name):
    _, want, _, got = _train_run(pairs(name))
    bounds = TRAIN_GRAD_BOUNDS[name]
    assert set(got) <= set(want) and len(got) > 50
    floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
    over = {}
    for k, g in got.items():
        bound = bounds[next(p for p in bounds if k.startswith(p))]
        err = float((g.double() - want[k].double()).norm()) / max(
            float(want[k].double().norm()), floor)
        if not err <= bound:
            over[k] = (err, bound)
    assert not over, over


def test_phase2_cli_trains_cilrs_and_resumes(tmp_path):
    """train_agent.entry_point=cilrs through the CLI: 2 epochs on tiny pools
    from the device cache, then a resumed third epoch; the control loss
    needs the command and action columns, which the cache keeps."""
    _pool(tmp_path / "pro_train_fmmfn", synthetic_samples(8, LANES, seed=1, resolution=RES))
    _pool(tmp_path / "pro_eval_fmmfn", synthetic_samples(4, LANES, seed=2, resolution=RES))
    _phase2_twice(tmp_path / "log", tmp_path, entry="cilrs")


# --------------------------------------------------------------------------- #
# the closed-loop agent
# --------------------------------------------------------------------------- #

def _plan(options):
    """A straight 100 m route along x, its road option changing every 15 m:
    (gps plan, world plan) in the evaluator's linear GPS convention."""
    kinds = (options.LANEFOLLOW, options.LEFT, options.STRAIGHT, options.RIGHT)
    world = [((float(i), 0.0), kinds[(i // 15) % 4]) for i in range(100)]
    gps = [({"lat": x / GPS_SCALE[0], "lon": y / GPS_SCALE[1], "z": 0.0}, o)
           for (x, y), o in world]
    return gps, world


def _sensor_ticks(n, lidar, seed=0):
    rng = np.random.default_rng(seed)
    ticks = []
    for i in range(n):
        x, y = 7.0 * i + rng.uniform(-1, 1), rng.uniform(-1, 1)
        tick = {"rgb": (i, rng.integers(0, 256, size=(300, 400, 4)).astype(np.uint8)),
                "gps": (i, np.array([x / GPS_SCALE[0], y / GPS_SCALE[1], 0.0])),
                "imu": (i, np.array([0.0, 0.0, 9.81, 0.0, 0.0, 0.0, rng.uniform(-0.3, 0.3)])),
                "speed": (i, {"speed": float(rng.uniform(0.0, 6.0))})}
        if lidar:
            tick["lidar"] = (i, rng.uniform([-20, -30, -4, 0], [20, 12, 2, 1],
                                            size=(1500, 4)).astype(np.float32))
        ticks.append(tick)
    return ticks


def _recording(agent, to_numpy):
    """Wrap ``agent._forward`` to keep each tick's raw model output."""
    outputs, forward = [], agent._forward

    def wrapped(*args):
        out = forward(*args)
        outputs.append(to_numpy(out))
        return out
    agent._forward = wrapped
    return outputs


def _flat_np(out):
    if isinstance(out, (tuple, list)):
        return np.concatenate([np.asarray(o).reshape(-1) for o in out])
    return np.asarray(out)


@pytest.mark.parametrize("name", BASELINES)
def test_agent_matches_jax_tick_for_tick(pairs, name):
    """Both BaselineAgents on the same weights and the same sensor ticks:
    the same vehicle controls, and every tick's raw output (TransFuser from
    its second tick, after the LiDAR double-buffering) within tolerance of
    the JAX agent's forward of that tick's inputs in float64, as the JAX
    agent's own f32 output is. Random weights drive AIM's waypoints to
    hundreds of metres, where each package's f32 rounding alone comes to
    half the tolerance (0.48 and 0.56 of it on the first tick at two
    threads), so the two f32 outputs are held to the exact value rather
    than to each other."""
    pair = pairs(name)
    jcfg, cfg = _configs()
    jax_agent = JaxBaselineAgent({"kind": name, "model": pair.jmodel, "config": jcfg,
                                  "variables": pair.variables, "points_per_sweep": PPS})
    port_agent = BaselineAgent({"kind": name, "model": pair.port, "config": cfg,
                                "points_per_sweep": PPS, "device": "cpu"})
    jax_agent.set_global_plan(*_plan(JaxRoadOption))
    port_agent.set_global_plan(*_plan(RoadOption))
    forward, calls = jax_agent._forward, []

    def recorded(variables, *inputs):
        calls.append([np.asarray(a) for a in inputs])
        return forward(variables, *inputs)
    jax_agent._forward = recorded
    jax_out = _recording(jax_agent, _flat_np)
    got_out = _recording(port_agent, lambda o: _flat_np([t.numpy() for t in o])
                         if name == "cilrs" else o.numpy())
    ticks = _sensor_ticks(5, lidar=name == "transfuser")
    for t, tick in enumerate(ticks):
        want, got = jax_agent.run_step(tick, 0.05 * t), port_agent.run_step(tick, 0.05 * t)
        for field in ("steer", "throttle", "brake"):
            assert abs(getattr(got, field) - getattr(want, field)) <= 1e-4, (t, got, want)
    assert len(got_out) == len(jax_out) == len(calls) == (4 if name == "transfuser" else 5)
    assert port_agent.step == jax_agent.step == 4
    # the cloud stays f32, so that both precisions bin the same points
    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), pair.variables)
        exact = [_flat_np(forward(variables, *(a.astype(np.float64) if a.dtype == np.float32
                                               and i != 1 else a for i, a in enumerate(c))))
                 for c in calls]
    tol = CONTROL_TOL if name == "cilrs" else WAYPOINT_TOL
    for got, f32, want in zip(got_out, jax_out, exact):
        assert want.dtype == np.float64
        np.testing.assert_allclose(f32.reshape(want.shape), want, **tol)
        np.testing.assert_allclose(got.reshape(want.shape), want, **tol)
    assert [s["id"] for s in port_agent.sensors()] == [s["id"] for s in jax_agent.sensors()]


def test_agent_loads_a_reference_state_dict(pairs):
    pair = pairs("aim")
    sd = {f"module.{k}": v for k, v in pair.port.state_dict().items()}
    agent = BaselineAgent({"kind": "aim", "model": sd, "config": pair.cfg, "device": "cpu"})
    assert agent.model is not pair.port and not agent.model.training
    for k, v in pair.port.state_dict().items():
        assert torch.equal(agent.model.state_dict()[k], v), k


@pytest.mark.parametrize("name", BASELINES)
def test_agent_drives_the_fake_world(pairs, name):
    """The port's agent in the JAX package's ClosedLoopRunner on the
    straight fake-world road, 5 ticks."""
    from mmfn_tpu.harness.replay import ClosedLoopRunner
    from mmfn_tpu.harness.route import RouteConfig
    from tests.test_harness import STRAIGHT_XODR

    pair = pairs(name)
    agent = BaselineAgent({"kind": name, "model": pair.port, "config": _configs()[1],
                           "points_per_sweep": PPS, "device": "cpu"})
    config = RouteConfig(route_id="0", town="TownTest",
                         trajectory=[(0.0, 1.75, 0.0), (60.0, 1.75, 0.0)], index=0)
    record = ClosedLoopRunner(max_wall_seconds=120).run_route(
        agent, config, STRAIGHT_XODR, max_ticks=5)
    assert agent.step >= 4
    assert np.isfinite(record.scores["score_composed"])


# --------------------------------------------------------------------------- #
# the port's own copies of the host-side control code
# --------------------------------------------------------------------------- #

def test_waypoint_controller_matches_jax():
    rng = np.random.default_rng(11)
    jcfg, cfg = _configs()
    want, got = JaxWaypointController(jcfg), WaypointController(cfg)
    for i in range(60):
        waypoints = (rng.normal(size=(4, 2)) * (3.0 if i % 7 else 0.0)).astype(np.float32)
        speed = float(rng.uniform(0, 8)) if i % 5 else 0.0
        assert got.control_pid(waypoints, speed) == want.control_pid(waypoints, speed)


def test_route_planner_matches_jax():
    rng = np.random.default_rng(12)
    np.testing.assert_array_equal(GPS_SCALE, JAX_GPS_SCALE)
    xy = np.cumsum(rng.uniform(0.5, 3.0, size=(80, 2)), axis=0)
    commands = rng.integers(1, 7, size=80)
    for gps in (True, False):
        plan = [({"lat": x / GPS_SCALE[0], "lon": y / GPS_SCALE[1]} if gps else (x, y), int(c))
                for (x, y), c in zip(xy, commands)]
        want, got = JaxRoutePlanner(4.0, 50.0), RoutePlanner(4.0, 50.0)
        want.set_route(plan, gps=gps)
        got.set_route(plan, gps=gps)
        for pos in xy[::3] + rng.normal(size=(27, 2)):
            (wp_w, c_w), (wp_g, c_g) = want.run_step(pos), got.run_step(pos)
            np.testing.assert_array_equal(wp_g, wp_w)
            assert c_g == c_w and len(got.route) == len(want.route)


def test_downsample_route_matches_jax():
    rng = np.random.default_rng(13)
    for _ in range(20):
        n = int(rng.integers(1, 300))
        xy = np.cumsum(rng.uniform(0.2, 2.0, size=(n, 2)), axis=0)
        values = rng.choice([4, 4, 4, 4, 1, 2, 3, 5, 6, -1], size=n)
        got = downsample_route([((x, y), RoadOption(v)) for (x, y), v in zip(xy, values)], 50)
        want = jax_downsample_route([((x, y), JaxRoadOption(v))
                                     for (x, y), v in zip(xy, values)], 50)
        assert got == want
    assert {o.name: o.value for o in RoadOption} == {o.name: o.value for o in JaxRoadOption}


@pytest.mark.slow
def test_full_width_transfuser_matches_jax():
    """Full-width TransFuser, the served configuration: n_layer 8, a 256-px
    camera, the fused attention on both sides."""
    kw = dict(attn_impl="pallas")
    jmodel = jax_entry_point("transfuser")(JaxConfig(matmul_precision="highest", **kw))
    data = _inputs(np.random.default_rng(0), 2, 256, LANES)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                                                 "dropout": jax.random.PRNGKey(1)},
                                                jbatch, False))
    rng = np.random.default_rng(2)
    variables = {"params": _randomise(_draw(shapes["params"], rng), rng),
                 "batch_stats": _randomise(_draw(shapes["batch_stats"], rng), rng, stats=True)}
    want = np.asarray(jax.jit(jmodel.apply, static_argnums=(2,))(variables, jbatch, False))
    port = build_baseline("transfuser", GlobalConfig(**kw), device="cpu")
    port.load_state_dict(tw.from_flax_variables(variables, "transfuser"), strict=True)
    got = _port_forward(port, data, None)
    assert got.shape == (2, 4, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **WAYPOINT_TOL)
