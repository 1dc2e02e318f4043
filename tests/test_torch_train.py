"""The port's training path (mmfn_tpu_torch.train, .data, .models.registry)
on its own, on the CPU: the engine's save/resume round trip, the
non-finite-loss abort, the bf16 and remat steps, the data cache, the
registry, the phase2 CLI end to end, and the fused attention's refusal to
drop gradients.

The bf16, remat, registry and CLI tests run MMFN-rad at n_layer 1, 64 px,
batch 4, 8 lanes, dropouts at their defaults (0.1) unless a test says
otherwise. The engine's mechanics (save, resume, abort, fit, dropout seeds)
run a small stand-in with a train-mode BatchNorm and dropout: an MMFN
checkpoint is about 0.9 GB on disk (75M parameters and two AdamW moments),
and the CLI test covers it. The MMFN step itself is held to the JAX
package's in tests/test_torch_train_parity.py.
"""

import json
import os
import pickle

import shutil

import numpy as np
import pytest
import torch
from torch import nn

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.collate import data_loader, to_batch
from mmfn_tpu_torch.data.device_cache import (DeviceDataset, estimate_cache_bytes,
                                              maybe_device_cache)
from mmfn_tpu_torch.data.synthetic import synthetic_batch, synthetic_samples
from mmfn_tpu_torch.models import build_model, get_entry_point
from mmfn_tpu_torch.models import registry
from mmfn_tpu_torch.models.common import init_weights
from mmfn_tpu_torch.models.resnet import BasicBlock, BatchNorm2d
from mmfn_tpu_torch.ops import attention
from mmfn_tpu_torch.train import Engine, create_train_state, make_eval_step, make_train_step
from mmfn_tpu_torch.train import phase2
from mmfn_tpu_torch.utils.seeding import seed_everything

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GlobalConfig(n_layer=1, max_lanes=8)
RES = 64
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


def _model(cfg=CFG, seed=0):
    return build_model(cfg, "rad", torch.Generator().manual_seed(seed), device="cpu")


class TinyNet(nn.Module):
    """Batch -> (B, 4, 2) waypoints through a conv, a train-mode BatchNorm,
    dropout 0.1 and a Linear."""

    variant = "tiny"

    def __init__(self, seed=0):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, 2, 1)
        self.bn = BatchNorm2d(8)
        self.drop = nn.Dropout(0.1)
        self.head = nn.Linear(8 + 3, 8)
        init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, batch):
        x = self.bn(self.conv(batch.image.permute(0, 3, 1, 2) / 255.0)).relu().mean((2, 3))
        x = torch.cat([x, batch.target_point, batch.velocity[:, None]], 1)
        return self.head(self.drop(x)).view(-1, 4, 2)


def _batches(n, seed=0):
    return [synthetic_batch(4, 8, seed=seed + i, resolution=RES, device="cpu")
            for i in range(n)]


def _bn_buffers(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def _assert_state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #

def _epoch(engine, state, batches):
    state = engine.train(state, batches, seed=5)
    engine.validate(state, batches[:1])
    engine.save(state)
    return state


def test_engine_save_resume_is_exact(tmp_path):
    """3 uninterrupted steps == 2 steps + save + resume into a fresh engine
    and model + 1 step, exactly, with dropout on: the masks follow (seed,
    step) and the AdamW moments come back with the weights."""
    b = _batches(3)
    straight = Engine(TinyNet(), CFG, str(tmp_path / "straight"))
    state = _epoch(straight, straight.initial_state(), b[:2])
    state = _epoch(straight, state, b[2:])

    first = Engine(TinyNet(), CFG, str(tmp_path / "split"))
    _epoch(first, first.initial_state(), b[:2])
    second = Engine(TinyNet(seed=9), CFG, str(tmp_path / "split"))
    resumed = second.resume(second.initial_state())
    assert resumed is not None and resumed.step == 2
    assert (second.cur_epoch, second.cur_iter) == (1, 2)
    resumed = _epoch(second, resumed, b[2:])

    assert resumed.step == state.step == 3
    assert second.cur_iter == straight.cur_iter == 3
    _assert_state_dicts_equal(resumed.model.state_dict(), state.model.state_dict())
    for name in ("recent.log", "model.pth", "optim.pth", "best_model.pth", "best_optim.pth"):
        assert os.path.exists(tmp_path / "split" / name), name
    logs = [json.loads((tmp_path / d / "recent.log").read_text()) for d in ("straight", "split")]
    assert logs[0] == logs[1]
    assert set(logs[0]) == {"epoch", "iter", "bestval", "bestval_epoch", "train_loss",
                            "val_loss"}
    # model.pth is the model's own state_dict
    fresh = TinyNet(seed=4)
    fresh.load_state_dict(torch.load(tmp_path / "split" / "model.pth", weights_only=True))
    _assert_state_dicts_equal(fresh.state_dict(), state.model.state_dict())


def test_resume_best_restores_the_best_checkpoint(tmp_path):
    b = _batches(2)
    engine = Engine(TinyNet(), CFG, str(tmp_path))
    state = _epoch(engine, engine.initial_state(), b[:1])
    best = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = engine.train(state, b[1:], seed=5)
    engine.val_loss.append(engine.val_loss[-1] + 1.0)      # a worse validation
    assert not engine.save(state)
    again = Engine(TinyNet(seed=9), CFG, str(tmp_path))
    restored = again.resume(again.initial_state(), best=True)
    assert restored.step == 1
    _assert_state_dicts_equal(restored.model.state_dict(), best)
    assert again.resume(again.initial_state()).step == 2
    empty = Engine(TinyNet(), CFG, str(tmp_path / "empty"))
    assert empty.resume(empty.initial_state()) is None


@pytest.mark.parametrize("log_every", [0, 1], ids=["epoch", "per_iter"])
def test_nonfinite_loss_aborts(tmp_path, log_every):
    engine = Engine(TinyNet(), CFG, str(tmp_path))
    bad = _batches(1)[0]
    bad = bad._replace(image=torch.full_like(bad.image, float("nan")))
    match = "at iter 1 " if log_every else "mean training loss in epoch 1"
    with pytest.raises(FloatingPointError, match=match):
        engine.train(engine.initial_state(), [bad], seed=0, log_every=log_every)


def test_fit_validates_saves_and_logs(tmp_path):
    logged = []
    engine = Engine(TinyNet(), CFG, str(tmp_path), log_fn=logged.append)
    b = _batches(2)
    state = engine.fit(engine.initial_state(), lambda e: b, lambda e: b[:1], epochs=3,
                       seed=1, val_every=1, save_every=2)
    assert (engine.cur_epoch, engine.cur_iter, state.step) == (3, 6, 6)
    assert len(engine.train_loss) == 3 and len(engine.val_loss) == 3
    assert json.loads((tmp_path / "recent.log").read_text())["epoch"] == 3  # saved at 0, 2
    assert {"loss", "val_loss", "epoch_minutes"} <= set().union(*logged)
    assert all(np.isfinite(engine.train_loss))


def test_engine_takes_the_orbax_backend(tmp_path):
    """checkpoint_backend="orbax" writes DCP directories under the JAX
    names (tests/test_torch_parallel.py holds them across world sizes); an
    unknown backend raises."""
    engine = Engine(TinyNet(), CFG.replace(checkpoint_backend="orbax"), str(tmp_path))
    state = engine.initial_state()
    engine.train(state, _batches(1), seed=0)
    engine.save(state)
    assert {p.name for p in tmp_path.iterdir()} == {"model.orbax", "recent.log"}
    assert (tmp_path / "model.orbax" / ".metadata").exists()
    with pytest.raises(ValueError, match="unknown checkpoint_backend"):
        Engine(TinyNet(), CFG.replace(checkpoint_backend="zarr"), str(tmp_path))


def test_dropout_masks_follow_seed_and_step():
    """The same (seed, step) draws the same masks; another seed other ones;
    the ambient generator is left as it was."""
    batch = _batches(1)[0]

    def loss(seed, step=0):
        model = TinyNet()
        state = create_train_state(model, CFG)
        state.step = step
        train_step = make_train_step()
        before = torch.get_rng_state()
        out = float(train_step(state, batch, seed))
        assert torch.equal(torch.get_rng_state(), before)
        return out

    assert loss(1) == loss(1) != loss(2)
    assert loss(1, step=1) != loss(1)


def test_eval_step_runs_in_inference_mode_and_leaves_the_model():
    model = TinyNet()
    state = create_train_state(model, CFG)
    batch = _batches(1)[0]
    make_train_step()(state, batch, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    eval_step = make_eval_step()
    a, b = eval_step(state, batch), eval_step(state, batch)
    assert not model.training and a.is_inference() and torch.equal(a, b)
    _assert_state_dicts_equal(model.state_dict(), before)
    make_train_step()(state, batch, 0)
    assert model.training


def test_bf16_step_descends_and_keeps_f32_state():
    """compute_dtype='bfloat16' (autocast) on MMFN-rad: the loss descends,
    and parameters, gradients, BN buffers and AdamW moments stay f32."""
    cfg = CFG.replace(embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, lr=1e-3)
    batch = _batches(1)[0]
    model = _model(cfg)
    state = create_train_state(model, cfg)
    step = make_train_step("bfloat16")
    losses = [float(step(state, batch, 0)) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(v.dtype in (torch.float32, torch.int64) for v in model.state_dict().values())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(s.dtype == torch.float32 for group in state.optimizer.state.values()
               for s in group.values() if s.dim())


def test_bf16_first_update_points_the_f32_way():
    """The bf16 step's first update against the f32 step's, from the same
    weights: cosine > 0.9, on the stand-in model, as the JAX package's
    test_bf16_train_step_descends_params_stay_f32 holds its own. On MMFN-rad
    the camera stream's gradients are far less faithful (cosine 0.66-0.71
    per tensor against f32, measured at these settings; 1.000 in the
    decoder): raw 0-255 pixels through the ImageNet affine reach the stem at
    up to about 1,100, where bf16 keeps under 3 significant digits."""
    cfg = CFG.replace(lr=1e-3)
    batch = _batches(1)[0]
    start = {k: v.clone() for k, v in TinyNet().state_dict().items()}
    updates = {}
    for dtype in ("float32", "bfloat16"):
        model = TinyNet()
        state = create_train_state(model, cfg)
        make_train_step(dtype)(state, batch, 0)
        updates[dtype] = torch.cat([(p.detach() - start[k]).flatten()
                                    for k, p in model.named_parameters()])
    cos = torch.nn.functional.cosine_similarity(updates["float32"], updates["bfloat16"], dim=0)
    assert float(cos) > 0.9, float(cos)


def test_remat_step_equals_the_plain_step(monkeypatch):
    """remat=True (checkpointed BasicBlocks) gives the plain step's loss,
    parameters and BN statistics, and each BN's statistics were updated
    once, though its block ran twice."""
    runs = {}
    calls = {"recomputed": 0}
    real = BatchNorm2d.forward

    def counting(self, x):
        calls["recomputed"] += int(self.training and not self.update_stats)
        return real(self, x)

    monkeypatch.setattr(BatchNorm2d, "forward", counting)
    batch = _batches(1)[0]
    for remat in (False, True):
        cfg = CFG.replace(remat=remat)
        model = _model(cfg)
        state = create_train_state(model, cfg)
        loss = make_train_step()(state, batch, 3)
        runs[remat] = (float(loss), model.state_dict(), calls["recomputed"])
    in_blocks = sum(isinstance(m, BatchNorm2d) for block in model.modules()
                    if isinstance(block, BasicBlock) for m in block.modules())
    assert runs[False][2] == 0 and runs[True][2] == in_blocks > 50
    (loss_p, sd_p, _), (loss_r, sd_r, _) = runs[False], runs[True]

    assert loss_r == pytest.approx(loss_p, rel=1e-6)
    assert sd_p.keys() == sd_r.keys()
    for k in sd_p:
        torch.testing.assert_close(sd_r[k], sd_p[k], rtol=1e-5, atol=1e-6, msg=k)
    assert all(int(v) == 1 for k, v in sd_r.items() if k.endswith("num_batches_tracked"))


def test_batchnorm_updates_running_var_with_the_biased_variance():
    bn = BatchNorm2d(3).train()
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    out = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(out, torch.nn.functional.batch_norm(
        x, None, None, bn.weight, bn.bias, True, 0.0, 1e-5))
    bn.update_stats = False
    bn(x)
    assert int(bn.num_batches_tracked) == 1


# --------------------------------------------------------------------------- #
# fused attention: no silent loss of gradients
# --------------------------------------------------------------------------- #

def test_fused_attention_refuses_when_autograd_needs_its_gradient():
    q, k, v = (torch.randn(1, 4, 8, 16) for _ in range(3))
    attention._refuse_autograd(q, k, v)                       # nothing needs a grad
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention._refuse_autograd(q, k, v)
    with torch.no_grad():
        attention._refuse_autograd(q, k, v)
    with torch.inference_mode():
        attention._refuse_autograd(q, k, v)
    # the CPU path is the plain, differentiable version
    attention.fused_attention(q, k, v).sum().backward()
    assert k.grad is not None


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #

def _assert_batches_equal(got, want):
    for field in _FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype, field
            assert torch.equal(a, b), field


@pytest.mark.parametrize("shuffle", [False, True])
def test_device_cache_matches_streaming_loader(shuffle):
    """DeviceDataset's gather-and-cast batches equal the streaming loader's,
    field by field and exactly, in the same order for the same seed; the
    uint8 transport is exact for raw 0-255 rasters and counts/5 BEV grids."""
    samples = synthetic_samples(10, max_lanes=8, seed=3, resolution=32)
    cache = DeviceDataset(samples, max_lanes=8, chunk=4, device="cpu")
    assert cache.nbytes <= estimate_cache_bytes(10, 8, resolution=32)
    want = [to_batch(b, "cpu") for b in data_loader(samples, 4, 8, shuffle=shuffle, seed=7,
                                                    num_threads=1)]
    got = list(cache.batches(4, shuffle=shuffle, seed=7))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    lean = DeviceDataset(samples, max_lanes=8, chunk=4, need_map=False, device="cpu")
    assert lean.nbytes <= estimate_cache_bytes(10, 8, resolution=32, need_map=False)
    assert lean.nbytes < cache.nbytes
    for g, w in zip(lean.batches(4, shuffle=shuffle, seed=7), want):
        assert g.map_img is None
        _assert_batches_equal(g._replace(map_img=w.map_img), w)
    assert len(list(cache.batches(4, drop_last=False))) == 3


def test_maybe_device_cache_gate():
    samples = synthetic_samples(4, max_lanes=8, seed=1, resolution=32)
    cfg = GlobalConfig(max_lanes=8)
    assert maybe_device_cache(samples, samples, cfg, False, device="cpu") is None
    assert maybe_device_cache(samples, samples, cfg, "auto", budget_bytes=1,
                              device="cpu") is None
    assert maybe_device_cache(samples, samples, cfg, "auto", world_size=2,
                              device="cpu") is None
    with pytest.raises(ValueError, match="single-process"):
        maybe_device_cache(samples, samples, cfg, True, world_size=2, device="cpu")
    train, val = maybe_device_cache(samples, samples, cfg, True, budget_bytes=1,
                                    device="cpu")
    assert train.n == val.n == 4


def test_data_helpers_run_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(2, 8, resolution=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataset(synthetic_samples(2, 8, resolution=32), max_lanes=8)


def test_seed_everything_returns_a_seeded_generator():
    a = torch.rand(4, generator=seed_everything(3))
    drawn = np.random.rand(), torch.rand(1)
    assert torch.equal(torch.rand(4, generator=seed_everything(3)), a)
    assert (np.random.rand(), torch.rand(1)) == drawn


# --------------------------------------------------------------------------- #
# registry and the phase2 CLI
# --------------------------------------------------------------------------- #

def test_registry():
    for name in ("mmfn_rad", "mmfn_utils.models.model_rad:MMFN"):
        model = get_entry_point(name)(CFG, torch.Generator().manual_seed(0), device="cpu")
        assert model.variant == "rad" and not model.training
    assert {get_entry_point(f"mmfn_{v}") for v in ("img", "vec", "rad")} <= set(
        registry.MODEL_REGISTRY.values())
    assert get_entry_point("mmfn_tpu_torch.models.mmfn:build_model") is build_model
    for name in ("aim", "cilrs", "transfuser"):
        model = get_entry_point(name)(CFG, torch.Generator().manual_seed(0), device="cpu")
        assert model.variant == name and not model.training
        assert all(p.device.type == "cpu" for p in model.parameters())
    with pytest.raises(KeyError, match="unknown model entry point"):
        get_entry_point("nonesuch")


def _pool(path, samples):
    os.makedirs(path)
    for i, s in enumerate(samples):
        with open(os.path.join(path, f"{i:04d}.pkl"), "wb") as f:
            pickle.dump(s, f)


def test_phase2_cli_trains_and_resumes(tmp_path):
    """Two epochs on tiny pickled pools (device cache on), then a rerun that
    resumes at epoch 2 and trains a third through the streaming loader."""
    _pool(tmp_path / "pro_train_fmmfn", synthetic_samples(8, 8, seed=1, resolution=RES))
    _pool(tmp_path / "pro_eval_fmmfn", synthetic_samples(4, 8, seed=2, resolution=RES))
    logdir = tmp_path / "log"
    try:
        _phase2_twice(logdir, tmp_path)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)     # about 1.7 GB of checkpoints


def _phase2_twice(logdir, tmp_path, entry="mmfn_rad"):
    """Two epochs of ``entry`` through the CLI from the device cache, then a
    rerun that resumes and trains a third through the streaming loader; the
    last ``model.pth`` loads into a fresh model."""
    args = ["--config", os.path.join(ROOT, "run_steps", "config", "train.yaml"),
            f"data_folder={tmp_path / 'mmfn'}", f"logdir={logdir}", "device=cpu",
            "batch_size=4", "max_lanes=8", "val_every=1", "save_every=1", "seed=3",
            f"train_agent.entry_point={entry}", "model.n_layer=1", "wandb_mode=disabled"]
    assert phase2.main(args + ["epochs=2", "device_data_cache=true", "log_every=1"]) == 0
    log = json.loads((logdir / "recent.log").read_text())
    assert (log["epoch"], log["iter"], len(log["val_loss"])) == (2, 4, 2)
    with open(logdir / "metrics.jsonl") as f:
        steps = [json.loads(line) for line in f if "loss_iter" in line]
    assert len(steps) == 4 and all(np.isfinite(r["loss_iter"]) for r in steps)
    for name in ("model.pth", "optim.pth", "best_model.pth", "best_optim.pth",
                 "metrics.jsonl"):
        assert (logdir / name).exists(), name
    assert torch.load(logdir / "optim.pth", weights_only=True)["step"] == 4

    assert phase2.main(args + ["epochs=3", "device_data_cache=false"]) == 0
    log2 = json.loads((logdir / "recent.log").read_text())
    assert (log2["epoch"], log2["iter"]) == (3, 6)
    assert log2["train_loss"][:2] == log["train_loss"]
    assert all(np.isfinite(log2["train_loss"]))
    served = get_entry_point(entry)(GlobalConfig(n_layer=1, max_lanes=8), device="cpu")
    served.load_state_dict(torch.load(logdir / "model.pth", weights_only=True))


def test_phase2_multi_host_trains_in_a_process_group(tmp_path, monkeypatch):
    """multi_host=true joins a gloo group from torchrun's variables (a world
    of one here), trains DDP-wrapped with the DCP backend, resumes from it,
    and destroys the group at the end."""
    import socket

    import torch.distributed as dist

    _pool(tmp_path / "pro_train_fmmfn", synthetic_samples(4, 8, seed=1, resolution=RES))
    _pool(tmp_path / "pro_eval_fmmfn", synthetic_samples(2, 8, seed=2, resolution=RES))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    logdir = tmp_path / "log"
    args = ["--config", os.path.join(ROOT, "run_steps", "config", "train.yaml"),
            f"data_folder={tmp_path / 'mmfn'}", f"logdir={logdir}", "device=cpu",
            "batch_size=2", "max_lanes=8", "val_every=1", "save_every=1", "seed=3",
            "train_agent.entry_point=cilrs", "wandb_mode=disabled", "multi_host=true", "coordinator_address=localhost:%d" % port,
            "num_processes=1", "process_id=0", "checkpoint_backend=orbax",
            "device_data_cache=false"]
    try:
        assert phase2.main(args + ["epochs=1"]) == 0
        assert not dist.is_initialized()
        assert phase2.main(args + ["epochs=2"]) == 0
        log = json.loads((logdir / "recent.log").read_text())
        assert (log["epoch"], log["iter"]) == (2, 4)
        assert (logdir / "model.orbax" / ".metadata").exists()
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


@pytest.mark.parametrize("override", ["model_parallel=2", "model_parallel=3"])
def test_phase2_refuses_a_model_axis_it_cannot_lay_out(override):
    """Without a process group there is one process, which model_parallel > 1
    cannot divide (the JAX CLI's SystemExit)."""
    with pytest.raises(SystemExit, match="does not divide 1 process"):
        phase2.main(["--config", os.path.join(ROOT, "run_steps", "config", "train.yaml"),
                     override, "device=cpu"])


def test_phase2_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phase2.main(["--config", os.path.join(ROOT, "run_steps", "config", "train.yaml")])
