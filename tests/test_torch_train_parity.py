"""The port's training (mmfn_tpu_torch.train, .data) against the JAX
package's, on the CPU.

Two train steps of MMFN-rad at n_layer 1, 64 px, batch 4, 8 lanes, all
dropouts 0, from the same weights (the JAX init, randomised and carried
across with from_flax_variables; JAX at matmul_precision "highest"). JAX's
gradients come from jax.value_and_grad of the engine's loss with the batch
stats mutable, its update from optax.adamw; the port's from its train step.

In f32 (tier 1) the comparison is limited by the JAX package's own f32
error, not the port's: on this randomised network (raw 0-255 pixels through
the ImageNet affine into train-mode BatchNorms, flax's E[x^2] - E[x]^2
variance, LayerNorms over zero-padded lanes) JAX's f32 gradients are up to
5.2e-2 off its own float64 step in the relative L2 norm of a tensor, and
its f32 BN statistics miss rtol 1e-5 / atol 1e-6. The port differs from
JAX f32 by 0.98-1.21 times that error in every module. So:

- loss of the first step: rtol 1e-5; of the second, which starts from
  parameters up to 2 * lr apart: rtol 1e-3;
- each gradient tensor: relative L2 error within its module's bound in
  GRAD_BOUNDS, twice the JAX package's own f32 error there (1.3e-5 at the
  output layer, 0.11 in VectorNet), floored at 1e-6 of the model's largest
  gradient element (the key biases' gradients are zero up to rounding,
  since softmax ignores them). test_float64_step_matches_jax measures the
  JAX error these bounds come from, and holds both packages to each other
  in float64 at 1e-6 on every tensor;
- BN running mean and variance after the first step: STATS_TOL per
  backbone, again about twice JAX's own f32 error. This pins the biased
  running-variance update: stock torch BN updates with the unbiased
  variance, larger by n/(n-1), which misses these tolerances at the BNs
  with few values a channel (a test below shows it failing);
- the AdamW state after the first step: the port's exp_avg against optax's
  mu at the gradient bounds, exp_avg_sq against nu at twice them, the step
  count exactly (after both steps);
- the first update, on the elements whose JAX gradient exceeds 20 times
  the tensor's largest gradient difference (so both signs agree): rtol
  1e-4 plus two f32 ulps of the parameter. The second step's gradients
  differ more (the first update flips where a gradient is rounding noise),
  so the second step's moments and update are held to optax.adamw applied
  to the port's own gradients: exact up to rounding, which an optimizer
  that drops or resets its moments misses by orders of magnitude.

The first step also runs over 2 gloo ranks of the port
(tests/_torch_parallel_worker.py): DDP at data 2 with global-batch BN, and
model_parallel 2 at data 1. Each is held to both packages' one-process
step at the JAX mesh's own bounds (tests/test_train.py: |Δloss| < 1e-4,
parameters within 2.5·lr, BN statistics within relative 1e-3) and, since
every element of a first AdamW update moves by about lr whatever its
gradient, its exp_avg (0.1 g) at the gradient bounds above.

One compile of the JAX gradient serves every f32 step test (module
fixture), and the ranks run while it compiles. The losses and the data helpers are compared on random arrays,
exactly or at 1e-6.
"""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mmfn_tpu.config import GlobalConfig as JaxConfig
from mmfn_tpu.data.batch import Batch as JaxBatch
from mmfn_tpu.data.collate import collate_samples as jax_collate
from mmfn_tpu.data.collate import data_loader as jax_data_loader
from mmfn_tpu.data.device_cache import estimate_cache_bytes as jax_estimate
from mmfn_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from mmfn_tpu.data.synthetic import synthetic_samples as jax_synthetic_samples
from mmfn_tpu.models import build_model as jax_build_model
from mmfn_tpu.train.engine import cilrs_loss as jax_cilrs_loss
from mmfn_tpu.train.engine import create_optimizer as jax_create_optimizer
from mmfn_tpu.train.engine import waypoint_l1_loss as jax_l1

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.data.collate import collate_samples, data_loader
from mmfn_tpu_torch.data.device_cache import estimate_cache_bytes
from mmfn_tpu_torch.data.synthetic import synthetic_batch, synthetic_samples
from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline
from mmfn_tpu_torch.models import build_model
from mmfn_tpu_torch.models import resnet as port_resnet
from mmfn_tpu_torch.models.gpt import SelfAttention
from mmfn_tpu_torch.train import cilrs_loss, create_train_state, make_train_step
from mmfn_tpu_torch.train import waypoint_l1_loss
from mmfn_tpu_torch.utils.weights import from_flax_variables, load_reference_state_dict
from tests import _torch_parallel_worker as worker
from tests.test_torch_models import _inputs, _randomise
from tests.test_torch_pipeline import PPS, _payload

N_LAYER, RES, BATCH, LANES = 1, 64, 4, 8
NO_DROPOUT = dict(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
# relative L2 bound of a gradient tensor, by module (first matching prefix)
GRAD_BOUNDS = {
    "output": 2e-5, "decoder": 3e-5, "join": 5e-5,
    "encoder.transformer4": 4e-3, "encoder.transformer3": 2e-2,
    "encoder.transformer2": 3e-2, "encoder.transformer1": 5e-2,
    "encoder.radar_encoder": 6e-3, "encoder.lidar_encoder": 1e-2,
    "encoder.image_encoder": 4e-2, "encoder.img_map_encoder": 5e-2,
    "encoder.vectornet_encoder": 0.11,
}
STATS_TOL = {"encoder.image_encoder": dict(rtol=1e-4, atol=1e-5),
             "encoder.lidar_encoder": dict(rtol=1e-4, atol=1e-6),
             "encoder.img_map_encoder": dict(rtol=5e-5, atol=1e-6)}
F64_GRAD_BOUND = 1e-6
ADAM_EPS = 1e-8
F64_STATS_TOL = dict(rtol=1e-5, atol=1e-6)
_FIELDS = ("image", "lidar_bev", "map_img", "lanes", "lane_num", "radar", "radar_adj",
           "target_point", "velocity", "waypoints", "command", "action")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs: the tests run beside
    other workers, and a worker's default of one thread per core
    oversubscribes the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _module(key, table):
    return next(prefix for prefix in table if key.startswith(prefix))


def _np_batch(seed):
    rng = np.random.default_rng(seed)
    data = _inputs(rng, BATCH, RES, LANES)
    data["waypoints"] = rng.normal(size=(BATCH, 4, 2)).astype(np.float32)
    return data


def _cast(data, floating):
    """A numpy batch with its float fields as ``floating``."""
    return {k: v.astype(floating) if v.dtype == np.float32 else v for k, v in data.items()}


def _to_port(tree, stats):
    """A JAX params-shaped tree (params, gradients or AdamW moments) + batch
    stats -> the port's keys and layouts."""
    return from_flax_variables(jax.tree.map(np.asarray, {"params": tree,
                                                         "batch_stats": stats}),
                               "rad", N_LAYER)


def _start(batch):
    """The JAX model, its randomised params and batch stats, and the same
    weights as a port state_dict."""
    jcfg = JaxConfig(matmul_precision="highest", n_layer=N_LAYER, max_lanes=LANES,
                     **NO_DROPOUT)
    jmodel = jax_build_model(jcfg, "rad")
    init = jax.jit(jmodel.init, static_argnums=(2,))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        JaxBatch(**{k: jnp.asarray(v) for k, v in batch.items()}), False)
    rng = np.random.default_rng(2)
    params = _randomise(init["params"], rng)
    stats = _randomise(init["batch_stats"], rng, stats=True)
    return jcfg, jmodel, params, stats, _to_port(params, stats)


def _jax_steps(jcfg, jmodel, params, stats, batches, floating=np.float32):
    """JAX's train steps (value_and_grad + optax.adamw) in ``floating``: the
    loss, gradients, state and AdamW moments after each, in the port's
    layout."""
    params, stats = (jax.tree.map(lambda a: jnp.asarray(a, floating), t)
                     for t in (params, stats))

    @jax.jit
    def grad_fn(params, stats, batch):
        def loss_fn(p):
            out, mutated = jmodel.apply({"params": p, "batch_stats": stats}, batch, True,
                                        rngs={"dropout": jax.random.PRNGKey(3)},
                                        mutable=["batch_stats"])
            return jax_l1(out, batch.waypoints), mutated["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    tx = jax_create_optimizer(jcfg)
    opt_state = tx.init(params)
    steps = []
    for b in batches:
        jb = JaxBatch(**{k: jnp.asarray(v) for k, v in _cast(b, floating).items()})
        (loss, stats), grads = grad_fn(params, stats, jb)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        adam = opt_state[0]
        steps.append({"loss": float(loss), "grads": _to_port(grads, stats),
                      "after": _to_port(params, stats), "mu": _to_port(adam.mu, stats),
                      "nu": _to_port(adam.nu, stats), "count": {int(adam.count)}})
    return steps


def _port_steps(cfg, start, batches, floating=np.float32):
    """The port's train steps from ``start`` in ``floating``: the loss, the
    gradients, the state_dict and the AdamW state after each."""
    port = build_model(cfg, "rad", device="cpu")
    port.load_state_dict(start)
    port.to({np.float32: torch.float32, np.float64: torch.float64}[floating])
    state = create_train_state(port, cfg)
    step = make_train_step()
    out = []
    for b in batches:
        loss = step(state, Batch(**{k: torch.from_numpy(v)
                                    for k, v in _cast(b, floating).items()}), 0)
        named = list(port.named_parameters())
        adam = [state.optimizer.state[p] for _, p in named]
        out.append({"loss": float(loss),
                    "grads": {k: p.grad.clone() for k, p in named},
                    "after": {k: v.clone() for k, v in port.state_dict().items()},
                    "mu": {k: s["exp_avg"].clone() for (k, _), s in zip(named, adam)},
                    "nu": {k: s["exp_avg_sq"].clone() for (k, _), s in zip(named, adam)},
                    "count": {int(s["step"]) for s in adam}})
    return out


def write_rank_spec(out, data, weights, **extra):
    """The worker's ``spec.pt``: the start weights, the batch, the config
    and three serving payloads at ``LANES``."""
    payloads = [_payload(np.random.default_rng(40 + i)) for i in range(3)]
    for p in payloads:
        p["lanes"] = p["lanes"][:LANES]
        p["lane_num"] = min(p["lane_num"], LANES)
    torch.save({"start": weights, "batch": {k: torch.from_numpy(v) for k, v in data.items()},
                "config": dict(n_layer=N_LAYER, max_lanes=LANES, **NO_DROPOUT),
                "payloads": payloads, "pps": PPS, **extra}, out / "spec.pt")


@pytest.fixture(scope="module")
def start():
    """The two batches, and the JAX model with its randomised weights."""
    batches = [_np_batch(seed) for seed in (10, 11)]
    return batches, _start(batches[0])


@pytest.fixture(scope="module")
def launched(start, tmp_path_factory):
    """The ``mmfn`` scenario of tests/_torch_parallel_worker.py (2 gloo
    ranks: DDP at data 2, then model_parallel 2 at data 1) on the first
    batch, from the same weights. The ranks start before JAX compiles its
    step, and run while it does."""
    batches, (_, _, _, _, weights) = start
    out = tmp_path_factory.mktemp("ranks")
    write_rank_spec(out, batches[0], weights)
    procs = worker.launch("mmfn", 2, out)
    yield procs, out
    for p in procs:
        p.kill()
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def run(start, launched):
    """Two f32 train steps of both packages from the same weights: JAX
    through value_and_grad + optax.adamw (one compile), the port through
    its train step."""
    batches, (jcfg, jmodel, params, stats, weights) = start
    cfg = GlobalConfig(n_layer=N_LAYER, max_lanes=LANES, **NO_DROPOUT)
    return {"cfg": cfg, "jcfg": jcfg, "start": weights, "batches": batches,
            "jax": _jax_steps(jcfg, jmodel, params, stats, batches),
            "port": _port_steps(cfg, weights, batches)}


@pytest.fixture(scope="module")
def ranks(launched):
    procs, out = launched
    return {"out": out, "ranks": worker.join(procs, "mmfn", out),
            "payloads": torch.load(out / "spec.pt", weights_only=False)["payloads"]}


def _grad_floor(grads):
    """1e-6 of the model's largest gradient element: the floor of a
    tensor's norm in a relative error."""
    return 1e-6 * max(float(g.abs().max()) for g in grads.values())


def _relative_errors(got, want, floor):
    """Relative L2 error of each tensor of ``got`` against ``want``, the
    norm of ``want`` floored at ``floor``."""
    return {k: float((g.double() - want[k].double()).norm())
            / max(float(want[k].double().norm()), floor) for k, g in got.items()}


def _assert_within(errors, scale=1.0):
    over = {k: (e, scale * GRAD_BOUNDS[_module(k, GRAD_BOUNDS)]) for k, e in errors.items()
            if not e <= scale * GRAD_BOUNDS[_module(k, GRAD_BOUNDS)]}
    assert not over, over


def test_train_step_loss_matches_jax(run):
    (first, second), (port_first, port_second) = run["jax"], run["port"]
    assert port_first["loss"] == pytest.approx(first["loss"], rel=1e-5)
    assert np.isfinite(port_second["loss"])
    assert port_second["loss"] == pytest.approx(second["loss"], rel=1e-3)


def test_train_step_gradients_match_jax(run):
    want, got = run["jax"][0]["grads"], run["port"][0]["grads"]
    assert set(got) <= set(want) and len(got) > 300
    _assert_within(_relative_errors(got, want, _grad_floor(want)))


def _running_stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _stats_mismatches(got, want, tolerances):
    return [k for k in got if not np.allclose(got[k].numpy(), want[k].numpy(),
                                              **tolerances[_module(k, tolerances)])]


def test_batchnorm_running_stats_match_jax(run):
    """After the step the port's running_var holds the biased batch
    variance, as flax's does, and each BN counted one update."""
    want, got = _running_stats(run["jax"][0]["after"]), _running_stats(run["port"][0]["after"])
    assert set(got) == set(want) and len(got) > 100
    assert _stats_mismatches(got, want, STATS_TOL) == []
    tracked = [v for k, v in run["port"][0]["after"].items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(t) == 1 for t in tracked)


def test_stock_torch_batchnorm_would_not_match_jax(run, monkeypatch):
    """The running-stat comparison catches torch's unbiased update of
    running_var (at the BNs with few values a channel); the running means
    still match."""
    monkeypatch.setattr(port_resnet.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
    stock = _port_steps(run["cfg"], run["start"], run["batches"][:1])
    want = _running_stats(run["jax"][0]["after"])
    mismatched = _stats_mismatches(_running_stats(stock[0]["after"]), want, STATS_TOL)
    assert len(mismatched) >= len(want) // 4
    assert all(k.endswith("running_var") for k in mismatched)


def test_adamw_state_matches_jax(run):
    """exp_avg against optax's mu and exp_avg_sq against nu after the first
    step, at the gradient bounds (mu is 0.1 g, nu 0.001 g^2); the step count
    after each step."""
    jax_first, port_first = run["jax"][0], run["port"][0]
    floor = _grad_floor(jax_first["grads"])
    _assert_within(_relative_errors(port_first["mu"], jax_first["mu"], 0.1 * floor))
    _assert_within(_relative_errors(port_first["nu"], jax_first["nu"], 1e-3 * floor ** 2),
                   scale=2.0)
    assert [s["count"] for s in run["port"]] == [s["count"] for s in run["jax"]] == [{1}, {2}]


def _optax_on(start, grads_by_step, jcfg):
    """optax.adamw (the JAX package's optimizer) applied to the port's own
    gradients, in the port's layout: parameters, mu and nu after each step."""
    tx = jax_create_optimizer(jcfg)
    params = {k: jnp.asarray(start[k].numpy()) for k in grads_by_step[0]}
    state = tx.init(params)
    out = []
    for grads in grads_by_step:
        updates, state = tx.update({k: jnp.asarray(g.numpy()) for k, g in grads.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        out.append({name: {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
                    for name, tree in (("after", params), ("mu", state[0].mu),
                                       ("nu", state[0].nu))})
    return out


def _assert_updates_close(got, want, start, select, rtol, ulps, atol=0.0):
    """``got`` and ``want`` parameters as updates from ``start``, on the
    elements ``select(key)`` picks: within rtol, plus atol, plus ``ulps``
    f32 ulps of the parameter (its rounding in each step)."""
    checked = 0
    for key, sel in ((k, select(k)) for k in got):
        u_got, u_want = got[key] - start[key], want[key] - start[key]
        slack = ulps * torch.finfo(torch.float32).eps * torch.maximum(start[key].abs(),
                                                                   want[key].abs())
        excess = ((u_got - u_want).abs() - slack - atol - rtol * u_want.abs())[sel]
        assert excess.numel() == 0 or float(excess.max()) <= 0, (key, float(excess.max()))
        checked += int(sel.sum())
    return checked


@pytest.mark.parametrize("index", [0, 1], ids=["one_step", "two_steps"])
def test_parameters_after_adamw_steps_match_jax(run, index):
    """One step: the update against JAX's, on the elements whose gradient is
    far above both packages' difference. Two steps: parameters, mu and nu
    against optax.adamw run on the port's own gradients (every element, the
    update within 1e-5 of itself and of lr), so the moments must carry
    across."""
    port, start = run["port"], run["start"]
    names = list(port[0]["grads"])
    if index == 0:
        jax_first = run["jax"][0]
        g_jax, g_port = jax_first["grads"], port[0]["grads"]

        def select(k):
            return g_jax[k].abs() > max(20 * float((g_port[k] - g_jax[k]).abs().max()),
                                        1e4 * ADAM_EPS)

        checked = _assert_updates_close({k: port[0]["after"][k] for k in names},
                                        jax_first["after"], start, select, rtol=1e-4,
                                        ulps=2)
        assert checked > 0.1 * sum(start[k].numel() for k in names)
        return
    want = _optax_on(start, [port[0]["grads"], port[1]["grads"]], run["jcfg"])
    for got, ref in zip(port, want):
        _assert_updates_close({k: got["after"][k] for k in names}, ref["after"], start,
                              lambda k: torch.ones_like(start[k], dtype=torch.bool),
                              rtol=1e-5, ulps=4, atol=1e-5 * run["cfg"].lr)
        for moment in ("mu", "nu"):
            for k in names:
                # 1e-6 of the tensor's largest moment, for the elements that cancel
                torch.testing.assert_close(got[moment][k], ref[moment][k], rtol=1e-6,
                                           atol=1e-6 * float(ref[moment][k].abs().max()),
                                           msg=lambda m: f"{moment} {k}: {m}")


# --------------------------------------------------------------------------- #
# the same step over 2 gloo ranks (tests/_torch_parallel_worker.py, "mmfn")
# --------------------------------------------------------------------------- #

def _param_diff(got, want):
    return max(float((got[k].double() - want[k].double()).abs().max())
               for k in want if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked")))


def _stats_rel_diff(got, want):
    return max(float(((got[k].double() - want[k].double()).abs()
                      / (1 + want[k].double().abs())).max())
               for k in want if k.endswith(("running_mean", "running_var")))


def _assert_multi_process_step(loss, mu, after, run, reference):
    """A multi-process step against ``reference``'s first step ("jax" or
    the one-process "port"): the JAX mesh bounds of tests/test_train.py
    (|Δloss| < 1e-4, parameters within 2.5·lr, BN statistics within
    relative 1e-3), and the gradient, exp_avg = 0.1 g, at the bounds of
    test_adamw_state_matches_jax. After one AdamW step every element moved
    by about lr whatever its gradient, so only the moments tell a step on
    the global batch from one on a rank's own rows or on partial sums."""
    ref = run[reference][0]
    assert abs(loss - ref["loss"]) < 1e-4, (loss, ref["loss"])
    assert set(mu) == set(run["port"][0]["mu"])
    _assert_within(_relative_errors(mu, ref["mu"], 0.1 * _grad_floor(run["jax"][0]["grads"])))
    assert _param_diff(after, ref["after"]) < 2.5 * run["cfg"].lr
    assert _stats_rel_diff(after, ref["after"]) < 1e-3


@pytest.mark.parametrize("reference", ["jax", "port"])
def test_ddp_step_matches_the_jax_mesh_and_one_process(run, ranks, reference):
    """Two data ranks (DDP over gloo, global-batch BN), each on 2 of the 4
    rows == the step on the whole batch. JAX's step over make_mesh(2) is
    its single-device step at these bounds (tests/test_train.py), and
    tests/test_torch_parallel.py holds the ranks to it directly (slow)."""
    a, b = ranks["ranks"]
    assert a["dp_loss"] == b["dp_loss"]
    _assert_multi_process_step(a["dp_loss"], a["dp_mu"], a["dp_after"], run, reference)


def test_global_batchnorm_statistics_are_not_per_shard(run, ranks):
    """The BN running statistics after the DDP step are the global batch's,
    at the tolerances of the one-process step (STATS_TOL): a per-shard
    update (stock DDP BatchNorm) would miss them."""
    want = _running_stats(run["jax"][0]["after"])
    got = _running_stats(ranks["ranks"][0]["dp_after"])
    assert _stats_mismatches(got, want, STATS_TOL) == []
    moved = [k for k in want if k.endswith("running_var")
             and not torch.allclose(want[k], run["start"][k].to(want[k].dtype))]
    assert len(moved) > 50


@pytest.mark.parametrize("reference", ["jax", "port"])
def test_tensor_parallel_step_matches_jax(run, ranks, reference):
    """One step under model_parallel 2 at data 1: 2 of the 4 heads a rank,
    the conjugate f/g operators around each sharded block. The ``.pth``
    written by rank 0 holds full tensors under the reference keys."""
    a, b = ranks["ranks"]
    assert a["tp_local_heads"] == b["tp_local_heads"] == {2}
    after = torch.load(ranks["out"] / "tp2" / "model.pth", weights_only=True)
    assert set(after) == set(run["start"])
    assert all(after[k].shape == v.shape for k, v in run["start"].items())
    assert all(torch.equal(a["tp_mu"][k], v) for k, v in b["tp_mu"].items())
    _assert_multi_process_step(a["tp_loss"], a["tp_mu"], after, run, reference)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_tensor_parallel_forward_matches_one_process(run, ranks, attn):
    """The eval forward at model_parallel 2 == the one-process forward
    within 1e-4 of the largest waypoint; ``attn_impl="pallas"`` takes each
    rank's 2 heads through ``fused_attention``. tests/test_torch_parallel.py
    holds it against JAX's tensor_parallel_sharding forward (slow)."""
    a, b = ranks["ranks"]
    assert torch.equal(a["tp_forward"][attn], b["tp_forward"][attn])
    model = build_model(run["cfg"], "rad", device="cpu")
    model.load_state_dict(run["start"])
    for m in model.modules():
        if isinstance(m, SelfAttention):
            m.attn_impl = attn
    with torch.no_grad():
        want = model.eval()(Batch(**{k: torch.from_numpy(v)
                                     for k, v in run["batches"][0].items()}))
    err = float((a["tp_forward"][attn] - want).abs().max())
    assert err < 1e-4 * float(want.abs().max()), err


def test_tp_checkpoint_serves_on_one_process(run, ranks):
    """The model.pth of the tensor-parallel run loads into a one-process
    TorchPipeline, which serves the waypoints the sharded model served."""
    model = build_model(run["cfg"], "rad", device="cpu")
    load_reference_state_dict(model, torch.load(ranks["out"] / "tp2" / "model.pth",
                                                weights_only=True))
    got = TorchPipeline(model, run["cfg"], points_per_sweep=PPS,
                        device="cpu").dispatch_fleet(ranks["payloads"]).numpy()
    np.testing.assert_allclose(got, ranks["ranks"][0]["tp_waypoints"].numpy(),
                               rtol=1e-4, atol=2e-3)


@pytest.mark.slow
def test_float64_step_matches_jax(run):
    """Both packages in float64 from the same weights: every gradient
    tensor within F64_GRAD_BOUND, the BN statistics within F64_STATS_TOL
    (rtol 1e-5 / atol 1e-6), the loss at 1e-9. Also measures the
    JAX package's own f32 error against its float64 step, which
    GRAD_BOUNDS and STATS_TOL are set at about twice."""
    batches = run["batches"][:1]
    with jax.enable_x64(True):
        jcfg, jmodel, params, stats, start = _start(batches[0])
        jax64 = _jax_steps(jcfg, jmodel, params, stats, batches, np.float64)[0]
    port64 = _port_steps(run["cfg"], start, batches, np.float64)[0]
    assert port64["loss"] == pytest.approx(jax64["loss"], rel=1e-9)
    names = list(port64["grads"])
    errors = _relative_errors(port64["grads"], jax64["grads"], _grad_floor(jax64["grads"]))
    worst = max(errors, key=errors.get)
    assert errors[worst] <= F64_GRAD_BOUND, (worst, errors[worst])
    want = _running_stats(jax64["after"])
    assert _stats_mismatches(_running_stats(port64["after"]), want,
                             {"": F64_STATS_TOL}) == []

    jax32 = run["jax"][0]
    spread = _relative_errors({k: jax32["grads"][k] for k in names}, jax64["grads"],
                              _grad_floor(jax64["grads"]))
    by_module = {}
    for k, e in spread.items():
        module = _module(k, GRAD_BOUNDS)
        by_module[module] = max(by_module.get(module, 0.0), e)
    print({m: f"{e:.3e}" for m, e in by_module.items()})
    for module, e in by_module.items():
        assert GRAD_BOUNDS[module] / 4 <= e <= GRAD_BOUNDS[module] / 1.5, (module, e)
    assert _stats_mismatches(_running_stats(jax32["after"]), want, STATS_TOL) == []


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    pred, target = (rng.normal(size=(6, 4, 2)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(waypoint_l1_loss(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jax_l1(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6, atol=1e-6)
    out = [rng.normal(size=(6, 1)).astype(np.float32) for _ in range(4)]
    action = rng.uniform(0, 1, size=(6, 3)).astype(np.float32)
    velocity = np.abs(rng.normal(size=(6,))).astype(np.float32) * 5
    want = jax_cilrs_loss([jnp.asarray(o) for o in out],
                          JaxBatch(*[None] * 3, velocity=jnp.asarray(velocity),
                                   action=jnp.asarray(action)))
    got = cilrs_loss([torch.from_numpy(o) for o in out],
                     Batch(*[None] * 3, velocity=torch.from_numpy(velocity),
                           action=torch.from_numpy(action)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def _assert_batches_equal(got, want):
    for field in _FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)


def test_synthetic_data_and_collate_match_jax_exactly():
    samples = synthetic_samples(10, max_lanes=8, seed=3)
    jax_samples = jax_synthetic_samples(10, max_lanes=8, seed=3)
    for s, js in zip(samples, jax_samples):
        assert s.keys() == js.keys()
        for k in s:
            np.testing.assert_array_equal(s[k], js[k], err_msg=k)
    _assert_batches_equal(collate_samples(samples, 8), jax_collate(jax_samples, 8))
    _assert_batches_equal(synthetic_batch(3, 8, seed=4, resolution=32, device="cpu"),
                          jax_synthetic_batch(3, 8, seed=4, resolution=32))


@pytest.mark.parametrize("num_threads", [1, 3])
def test_data_loader_matches_jax_exactly(num_threads):
    samples = synthetic_samples(11, max_lanes=8, seed=6, resolution=32)
    kw = dict(shuffle=True, seed=7, num_threads=num_threads, shard_index=1, shard_count=2)
    got = list(data_loader(samples, 2, 8, **kw))
    want = list(jax_data_loader(samples, 2, 8, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


@pytest.mark.parametrize("need_map", [True, False])
def test_estimate_cache_bytes_matches_jax(need_map):
    for n, lanes, res in ((96, 64, 256), (10, 8, 64)):
        assert estimate_cache_bytes(n, lanes, res, need_map) == jax_estimate(
            n, lanes, res, need_map)
