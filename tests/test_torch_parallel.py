"""The port's multi-process training on the CPU: ``parallel/mesh.py``, the
``"orbax"`` (DCP) checkpoint backend, the dropout seeds of the data ranks,
the phase2 CLI over 2 ranks, and (slow) the steps and the tensor-parallel
forward against the JAX package's own mesh.

Each multi-process case runs ranks started with ``torchrun``'s variables
(``tests/_torch_parallel_worker.py``, which imports no JAX) over gloo:
- ``tiny`` (2 ranks): :class:`TinyFusion`'s dropout masks and DCP
  directories written at world 2 by DDP and by model_parallel 2; then the
  phase2 CLI (CILRS, ``device=cpu``) on a pool of 7 frames, which splits
  4 / 3 over the data ranks.
- slow: ``mmfn`` (2 ranks) and ``grid`` (4 ranks) of MMFN-rad (n_layer 1,
  64 px, 8 lanes, dropouts 0) from randomised JAX weights, against JAX's
  step over ``make_mesh(2)`` and its forward over a (2, 2)
  ``tensor_parallel_sharding`` mesh. Tier 1 holds the same ``mmfn`` ranks
  to both packages' one-process step, whose JAX compile it shares
  (tests/test_torch_train_parity.py); JAX's own tests hold its mesh step to
  its single-device step.

Bounds are the JAX package's own for its mesh (``tests/test_train.py``):
|Δloss| < 1e-4, parameters within 2.5·lr after the first AdamW step, BN
running statistics within relative 1e-3; the gradient (exp_avg = 0.1 g) at
4x the one-process bounds of tests/test_torch_train_parity.py, which JAX's
own mesh step misses against its single-device step; the forward within
1e-4 of the largest waypoint.
"""

import json
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmfn_tpu.data.batch import Batch as JaxBatch
from mmfn_tpu.parallel import make_mesh, replicate, shard_batch, tensor_parallel_sharding
from mmfn_tpu.train.engine import TrainState as JaxTrainState
from mmfn_tpu.train.engine import create_optimizer as jax_create_optimizer
from mmfn_tpu.train.engine import make_train_step as jax_make_train_step

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.synthetic import synthetic_samples
from mmfn_tpu_torch.parallel import mesh as pmesh
from mmfn_tpu_torch.train import engine as port_engine
from mmfn_tpu_torch.train.engine import Engine
from tests import _torch_parallel_worker as worker
from tests.test_torch_train import ROOT, TinyNet, _batches, _pool
from tests.test_torch_train_parity import (LANES, N_LAYER, NO_DROPOUT, _assert_within,
                                           _grad_floor, _np_batch, _param_diff,
                                           _relative_errors, _start, _stats_rel_diff,
                                           _to_port, write_rank_spec)
from tests._torch_parallel_worker import TinyFusion

LR = GlobalConfig().lr
PHASE2_FRAMES = 7                 # 4 + 3 over two data ranks, at batch_size 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads while this module runs, as each rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiny")
    _pool(out / "pro_train_fmmfn", synthetic_samples(PHASE2_FRAMES, 8, seed=1, resolution=64))
    _pool(out / "pro_eval_fmmfn", synthetic_samples(4, 8, seed=2, resolution=64))
    logdir = out / "phase2_log"
    args = ["--config", f"{ROOT}/run_steps/config/train.yaml", f"data_folder={out / 'mmfn'}",
            f"logdir={logdir}", "device=cpu", "batch_size=2", "max_lanes=8", "val_every=1",
            "save_every=1", "seed=3", "epochs=2", "train_agent.entry_point=cilrs",
            "wandb_mode=disabled", "device_data_cache=false"]
    write_rank_spec(out, _np_batch(10), None, phase2_args=args, phase2_logdir=str(logdir))
    try:
        yield {"out": out, "cfg": GlobalConfig(n_layer=N_LAYER, max_lanes=LANES,
                                               **NO_DROPOUT),
               "ranks": worker.join(worker.launch("tiny", 2, out), "tiny", out)}
    finally:
        shutil.rmtree(out, ignore_errors=True)


def test_dropout_masks_differ_between_data_ranks(tiny):
    """The step's mask seed folds in the data rank: the same rows draw other
    masks on rank 1 than on rank 0."""
    a, b = tiny["ranks"]
    assert not a["masks_equal"] and not b["masks_equal"]
    assert 0.4 < a["mask_keep"] < 0.6 and 0.4 < b["mask_keep"] < 0.6
    seeds = {port_engine.step_seed(0, 0, r) for r in range(2)}
    assert len(seeds) == 2 and port_engine.step_seed(0, 0) in seeds


def test_phase2_gives_every_data_rank_the_same_batch_count(tiny):
    """7 frames over 2 data ranks at batch_size 2: the shards hold 4 and 3
    frames, and each rank takes 7 // 4 = 1 batch an epoch. With 2 and 1,
    rank 0 would wait in a DDP all-reduce that rank 1 never joins."""
    log = json.loads(tiny["ranks"][0]["phase2_log"])
    assert (log["epoch"], log["iter"]) == (2, 2)
    assert len(log["val_loss"]) == 2 and np.isfinite(log["train_loss"] + log["val_loss"]).all()


def _resume_world1(tiny, name):
    engine = Engine(TinyFusion(seed=9), tiny["cfg"].replace(checkpoint_backend="orbax"),
                    str(tiny["out"] / name))
    state = engine.initial_state()
    assert engine.resume(state) is not None
    return engine, state


@pytest.mark.parametrize("world", [1, 2])
def test_dcp_checkpoint_resumes_across_world_sizes(tiny, world):
    """The DCP directories written by two DDP ranks restore exactly at world
    2 (in the ranks) and at world 1 (here), with the step, the AdamW state
    and the bookkeeping."""
    if world == 2:
        for r in tiny["ranks"]:
            assert r["resume_world2_equal"] and r["resume_world2"] == (1, 1)
        return
    assert {p.name for p in (tiny["out"] / "dcp_dp").iterdir()} == {
        "model.orbax", "best_model.orbax", "recent.log"}
    engine, state = _resume_world1(tiny, "dcp_dp")
    assert (state.step, engine.cur_epoch, len(engine.val_loss)) == (1, 1, 1)
    want = tiny["ranks"][0]["dcp_dp_after"]
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())
    assert all(int(s["step"]) == 1 for s in state.optimizer.state.values())


def test_dcp_tensor_parallel_checkpoint_resumes_on_one_process(tiny):
    """The model_parallel 2 DCP directory (DTensor shards over ``model``)
    restores into full tensors at world 1, equal to the ranks' gathered
    state."""
    _, state = _resume_world1(tiny, "dcp_tp")
    want = tiny["ranks"][0]["dcp_tp_after"]
    assert torch.equal(want["gpt.blocks.0.attn.query.weight"],
                       tiny["ranks"][1]["dcp_tp_after"]["gpt.blocks.0.attn.query.weight"])
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())


def test_orbax_round_trip_and_commit_order(tmp_path, monkeypatch):
    """The JAX engine's orbax round trip (tests/test_train.py): the best and
    the recent directories restore through a fresh engine, a worse
    validation keeps the best. A crash between the commit and recent.log
    resumes the previous epoch's bookkeeping with the previous weights."""
    cfg = GlobalConfig(lr=1e-2, checkpoint_backend="orbax")
    batches = _batches(2)
    engine = Engine(TinyNet(), cfg, str(tmp_path))
    state = engine.initial_state()
    engine.train(state, batches, seed=0)
    engine.validate(state, batches[:1])
    assert engine.save(state)
    engine.finalize()
    first = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert {p.name for p in tmp_path.iterdir()} == {"model.orbax", "best_model.orbax",
                                                     "recent.log"}
    engine.val_loss.append(engine.val_loss[-1] + 1.0)
    engine.train(state, batches[:1], seed=0)
    assert not engine.save(state)
    second = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert not torch.equal(first["head.weight"], second["head.weight"])

    for best, want, step in ((True, first, 2), (False, second, 3)):
        fresh = Engine(TinyNet(seed=1), cfg, str(tmp_path))
        back = fresh.initial_state()
        assert fresh.resume(back, best=best) is back
        assert (fresh.cur_epoch, fresh.bestval_epoch, back.step) == (2, 1, step)
        assert all(torch.equal(v, want[k]) for k, v in back.model.state_dict().items())

    # the third save commits its directory, then dies before recent.log
    def crash():
        raise KeyboardInterrupt("crash after the commit")

    engine.train(state, batches[:1], seed=0)
    monkeypatch.setattr(engine, "_write_log", crash)
    with pytest.raises(KeyboardInterrupt):
        engine.save(state)
    assert json.loads((tmp_path / "recent.log").read_text())["epoch"] == 2
    assert json.loads((tmp_path / "model.orbax" / "epoch.json").read_text())["epoch"] == 3
    fresh = Engine(TinyNet(seed=1), cfg, str(tmp_path))
    back = fresh.initial_state()
    assert fresh.resume(back) is back
    assert (fresh.cur_epoch, back.step) == (2, 3)
    assert all(torch.equal(v, second[k]) for k, v in back.model.state_dict().items())


def test_mesh_layout_and_rendezvous():
    """The rendezvous comes from torchrun's variables, the JAX config keys
    over them; make_mesh lays ranks out as the JAX package's reshape."""
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
           "MASTER_PORT": "1234"}
    assert pmesh.torchrun_environment(env) and not pmesh.torchrun_environment({})
    assert pmesh.rendezvous({}, env) == pmesh.Rendezvous(3, 4, 1, "h", 1234)
    assert pmesh.rendezvous({"coordinator_address": "c:99", "num_processes": 2,
                             "process_id": 1}, {}) == pmesh.Rendezvous(1, 2, 1, "c", 99)
    with pytest.raises(ValueError, match="outside a world"):
        pmesh.rendezvous({}, {"RANK": "2", "WORLD_SIZE": "2"})
    assert pmesh.axis_size(None, "model") == pmesh.axis_size(None, "data") == 1
    assert pmesh.tp_dim("encoder.transformer2.blocks.0.attn.query.bias") == 0
    assert pmesh.tp_dim("encoder.transformer2.blocks.0.mlp.2.weight") == 1
    assert pmesh.tp_dim("encoder.transformer2.blocks.0.mlp.2.bias") is None
    assert pmesh.tp_dim("encoder.vectornet_encoder.lane_subgraph.layers.mlp_0.mlp.0.weight") \
        is None


# --------------------------------------------------------------------------- #
# slow: against JAX's own mesh
# --------------------------------------------------------------------------- #

def _jax_batch(data):
    return JaxBatch(**{k: jnp.asarray(v) for k, v in data.items()})


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The ``mmfn`` and ``grid`` ranks on one global batch of 4 rows, and
    JAX's step over make_mesh(2) and forward over a (2, 2)
    tensor_parallel_sharding mesh, which run while the ranks do."""
    out = tmp_path_factory.mktemp("mesh")
    data = _np_batch(10)
    jcfg, jmodel, params, stats, start = _start(data)
    write_rank_spec(out, data, start)
    procs = {"mmfn": worker.launch("mmfn", 2, out), "grid": worker.launch("grid", 4, out)}
    try:
        tx = jax_create_optimizer(jcfg)
        p0 = jax.tree.map(jnp.asarray, params)
        jstate = JaxTrainState(params=p0, batch_stats=jax.tree.map(jnp.asarray, stats),
                               opt_state=tx.init(p0), step=jnp.zeros((), jnp.int32))
        mesh = make_mesh(2)
        after, loss = jax_make_train_step(jmodel, tx)(
            replicate(jstate, mesh), shard_batch(_jax_batch(data), mesh), jax.random.PRNGKey(3))
        jax_step = {"loss": float(loss), "after": _to_port(after.params, after.batch_stats),
                    "mu": _to_port(after.opt_state[0].mu, after.batch_stats)}
        tp_mesh = make_mesh(4, axes=("data", "model"), axis_sizes=(2, 2))
        variables = tensor_parallel_sharding({"params": params, "batch_stats": stats}, tp_mesh)
        jax_forward = np.asarray(jax.jit(jmodel.apply, static_argnums=(2,))(
            variables, shard_batch(_jax_batch(data), tp_mesh), False))
        yield {"jax_step": jax_step, "jax_forward": jax_forward, "start": start,
               "mmfn": worker.join(procs["mmfn"], "mmfn", out),
               "grid": worker.join(procs["grid"], "grid", out), "out": out}
    finally:
        for p in procs["mmfn"] + procs["grid"]:
            p.kill()
        shutil.rmtree(out, ignore_errors=True)


def _assert_jax_mesh_step(loss, mu, after, run):
    """JAX's bounds for its mesh, and the gradient at 4x the one-process
    bounds of tests/test_torch_train_parity.py: JAX's mesh step itself
    misses those against its single-device step (the third fusion stage
    worst), and the port's one-process step misses them against it as
    much. A step with no gradient all-reduce, or none in f's backward,
    misses them by far more."""
    ref = run["jax_step"]
    assert abs(loss - ref["loss"]) < 1e-4, (loss, ref["loss"])
    assert set(mu) <= set(ref["mu"]) and len(mu) > 300
    _assert_within(_relative_errors(mu, ref["mu"], _grad_floor(ref["mu"])), scale=4.0)
    assert _param_diff(after, ref["after"]) < 2.5 * LR
    assert _stats_rel_diff(after, ref["after"]) < 1e-3


@pytest.mark.slow
def test_ddp_step_matches_the_jax_mesh(mesh_run):
    """Two data ranks == JAX's step over make_mesh(2) on the same batch."""
    a, b = mesh_run["mmfn"]
    assert a["dp_loss"] == b["dp_loss"]
    _assert_jax_mesh_step(a["dp_loss"], a["dp_mu"], a["dp_after"], mesh_run)


@pytest.mark.slow
@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_tensor_parallel_forward_matches_jax(mesh_run, attn):
    """model_parallel 2 at data 1, and the (2, 2) grid (each data rank's
    rows), against JAX's tensor_parallel_sharding forward; each rank holds
    2 of the 4 heads, and ``attn_impl="pallas"`` takes them through
    ``fused_attention`` at H = 2."""
    want = mesh_run["jax_forward"]
    scale = float(np.abs(want).max())
    grid = sorted(mesh_run["grid"], key=lambda r: r["rows"])
    for got in (mesh_run["mmfn"][0]["tp_forward"][attn],
                torch.cat([grid[0]["forward"][attn], grid[-1]["forward"][attn]])):
        err = float(np.abs(got.numpy() - want).max())
        assert err < 1e-4 * scale, (err, scale)


@pytest.mark.slow
def test_grid_step_matches_the_jax_mesh(mesh_run):
    """One step on the ("data", "model") = (2, 2) grid."""
    r = mesh_run["grid"][0]
    assert set(r["after"]) == set(mesh_run["start"])
    _assert_jax_mesh_step(r["loss"], r["mu"], r["after"], mesh_run)
