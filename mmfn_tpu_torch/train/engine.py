"""Training engine, the port of the JAX package's ``train/engine.py``.

As the reference Engine (run_steps/phase2_train_net.py:35-220): AdamW (lr
1e-4, weight decay on all parameters), the mean-L1 loss over the predicted
waypoints (CILRS: its composite control loss, :func:`model_loss`),
validation every few epochs, best-model tracking, and a
``recent.log`` JSON with the epoch/iter/bestval/loss histories for resume.

State. A :class:`TrainState` holds the model, its optimizer and the integer
``step``: the counterparts of the JAX state's ``params``, ``opt_state`` and
``step``. The BatchNorm running statistics (JAX's ``batch_stats``) live in
the model's buffers and stay f32. A train step updates the state in place
and returns the loss as a device tensor, without a host sync.

Dropout. Each step draws its masks under ``torch.random.fork_rng`` from a
seed made of (seed, step), the counterpart of
``jax.random.fold_in(rng, state.step)``, so a resumed run draws the masks of
an uninterrupted one and the ambient generators are left as they were. A
data-parallel rank other than 0 folds its data rank in as well, so the
shards draw different masks; rank 0 keeps the single-process seed. The ranks
of one tensor-parallel group share the data rank and so the masks of the
replicated activations.

Data parallelism. With a ``mesh`` (``parallel/mesh.py:make_mesh``) the
train step runs the model wrapped in ``DistributedDataParallel`` over the
mesh's ``data`` group, and the ResNets' BatchNorms take global-batch
statistics over that group (``models/resnet.py``). Each rank's loss is the
mean over its equal shard, so DDP's gradient average is the gradient of the
global-batch mean, as under the JAX package's GSPMD mesh. The epoch's train
and validation losses are all-reduced over the data group, so every rank
takes the same ``save_best`` branch. Logging and the ``"msgpack"`` files
are rank 0's; a tensor-parallel model (``tensor_parallel_sharding``) is
gathered to full tensors for them first.

Checkpoint files in ``logdir``:

- ``recent.log``: the JAX package's JSON, same keys, written by rank 0
  after the checkpoint it describes has committed;
- ``checkpoint_backend="msgpack"`` (the default; its name is kept so
  configs carry across, and it writes torch files):
  ``model.pth`` / ``best_model.pth``: the model's state_dict under the
  reference checkpoint keys (full CPU tensors), loadable by
  ``utils/weights.py:load_reference_state_dict`` and ``TorchPipeline``;
  ``optim.pth`` / ``best_optim.pth``: ``{"optimizer": the AdamW state_dict,
  "step": the train step}``, the names of the reference TransFuser trainer;
- ``checkpoint_backend="orbax"``: the directories ``model.orbax`` and
  ``best_model.orbax`` (the JAX file contract), written by every rank with
  ``torch.distributed.checkpoint.async_save``: each rank writes its own
  shards, tensor-parallel parameters and their AdamW moments as DTensors,
  so :meth:`Engine.resume` restores into the current layout whatever world
  size wrote them. These are DCP's format, not orbax's: neither package
  reads the other's directories. A write goes to ``<dir>.tmp``, and the
  commit swaps it in, keeping the previous directory as ``<dir>.prev``
  until ``recent.log`` is written; each directory's ``epoch.json`` says
  which epoch it holds, and resume takes the one that ``recent.log``
  describes. So a crash between the commit and ``recent.log`` resumes the
  previous epoch's bookkeeping with the previous weights.

The JAX package's ``fast_init_train_state`` has no counterpart: it exists to
skip an XLA compile of ``init``, and ``build_model`` compiles nothing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch
from mmfn_tpu_torch.parallel import mesh as pmesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """``model`` is the bare module (its state_dict has the reference
    keys); ``wrapped`` is the module the train step calls: the DDP wrapper
    on a mesh, else None and the model itself."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    wrapped: Optional[nn.Module] = None


def create_optimizer(model: nn.Module, config: GlobalConfig) -> torch.optim.AdamW:
    """torch.optim.AdamW over all parameters, betas (0.9, 0.999), eps 1e-8,
    weight decay ``config.weight_decay`` on every parameter (the reference
    has no decay/no-decay split). The update is ``optax.adamw``'s: decay on
    the pre-update parameter, bias-corrected moments, eps outside the square
    root. torch picks the implementation (foreach on CUDA)."""
    return torch.optim.AdamW(model.parameters(), lr=config.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=config.weight_decay)


def create_train_state(model: nn.Module, config: GlobalConfig, mesh=None) -> TrainState:
    """A fresh optimizer at step 0; with a ``mesh``, the model wrapped in
    DDP over its ``data`` group and its BatchNorms on global-batch
    statistics (module docstring)."""
    wrapped = None
    if mesh is not None:
        from torch.nn.parallel import DistributedDataParallel
        from mmfn_tpu_torch.models.resnet import set_batchnorm_group

        set_batchnorm_group(model, pmesh.axis_group(mesh, "data"))
        device = next(model.parameters()).device
        group = mesh.get_group("data")
        wrapped = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            process_group=group)
    return TrainState(model, create_optimizer(model, config), 0, wrapped)


def waypoint_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean L1 over all waypoint coordinates, in f32 or wider
    (phase2_train_net.py:104)."""
    dtype = torch.promote_types(pred.dtype, torch.float32)
    return (pred.to(dtype) - target.to(dtype)).abs().mean()


def cilrs_loss(out, batch: Batch) -> torch.Tensor:
    """CILRS composite loss in f32 (benchmarks/cilrs/train.py:93-96):
    0.05·L1(velocity) + L1(steer) + L1(throttle) + L1(brake). The train and
    eval steps use it for a model whose ``variant`` is ``"cilrs"``."""
    steer, throttle, brake, velocity_pred = (t.to(torch.float32) for t in out)
    action = batch.action.to(torch.float32)
    return (0.05 * (velocity_pred.squeeze(-1) - batch.velocity).abs().mean()
            + (steer - action[:, 0]).abs().mean()
            + (throttle - action[:, 1]).abs().mean()
            + (brake - action[:, 2]).abs().mean())


def model_loss(model: nn.Module, batch: Batch) -> torch.Tensor:
    """The forward and its loss: CILRS takes the navigational command as an
    integer tensor and trains on :func:`cilrs_loss`; every other model maps
    the batch to waypoints and trains on :func:`waypoint_l1_loss`."""
    if getattr(getattr(model, "module", model), "variant", "") == "cilrs":
        return cilrs_loss(model(batch, batch.command.to(torch.int32)), batch)
    return waypoint_l1_loss(model(batch), batch.waypoints)


def compute_dtype_of(name: str) -> torch.dtype:
    """``"float32"`` | ``"bfloat16"`` -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def step_seed(seed: int, step: int, data_rank: int = 0) -> int:
    """The dropout seed of train step ``step`` of a run seeded ``seed``, on
    data-parallel rank ``data_rank`` (rank 0: the single-process seed)."""
    entropy = [seed, step] + ([data_rank] if data_rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def make_train_step(compute_dtype: str = "float32", data_rank: int = 0) -> Callable:
    """Returns ``train_step(state, batch, seed) -> loss``: forward, backward
    and one update of ``state.model`` by ``state.optimizer``, ``state.step``
    advanced; the loss is a detached device tensor, not fetched.

    ``compute_dtype="bfloat16"`` runs the forward under
    ``torch.autocast(device_type, dtype=torch.bfloat16)`` and the backward
    from it. Master weights, the optimizer state and the BN buffers stay
    f32, and the loss is reduced in f32. This is autocast's arithmetic, not
    the JAX package's: JAX casts every parameter and input to bf16, while
    autocast runs matmuls and convolutions in bf16 and keeps LayerNorm,
    softmax and the BN statistics in f32. The two bf16 runs therefore
    differ; each is held to its own f32 step.

    ``data_rank`` folds into the dropout seed (module docstring); the step
    runs ``state.wrapped`` when the state has one (DDP).
    """
    dtype = compute_dtype_of(compute_dtype)
    half = dtype != torch.float32

    def train_step(state: TrainState, batch: Batch, seed: int) -> torch.Tensor:
        model, optimizer = state.wrapped or state.model, state.optimizer
        device = next(model.parameters()).device
        if not state.model.training:
            model.train()
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                   device_type=device.type):
            torch.manual_seed(step_seed(seed, state.step, data_rank))
            with torch.autocast(device.type, dtype=dtype, enabled=half):
                loss = model_loss(model, batch)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step


def make_eval_step() -> Callable:
    """Returns ``eval_step(state, batch) -> loss``: ``state.model`` in eval
    mode under ``torch.inference_mode()``, the loss a device tensor. With
    ``attn_impl="pallas"`` on the GPU this launches the fused attention
    kernel."""

    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        state.model.eval()
        with torch.inference_mode():
            return model_loss(state.model, batch)

    return eval_step


class Engine:
    """The epoch loop, with best-model tracking, save and resume (file
    contract in the module docstring). ``mesh``: the data-parallel (and
    tensor-parallel) layout of a multi-process run; every rank builds its
    own Engine and calls each method."""

    def __init__(self, model: nn.Module, config: GlobalConfig, logdir: str,
                 log_fn: Optional[Callable[[dict], None]] = None, mesh=None):
        if config.checkpoint_backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint_backend {config.checkpoint_backend!r}")
        self.model = model
        self.config = config
        self.logdir = logdir
        self.mesh = mesh
        self.rank = dist.get_rank() if mesh is not None else 0
        self.data_group = pmesh.axis_group(mesh, "data")
        self.train_step = make_train_step(config.compute_dtype,
                                          pmesh.axis_rank(mesh, "data"))
        self.eval_step = make_eval_step()
        self.cur_epoch = 0
        self.cur_iter = 0
        self.bestval = 1e10
        self.bestval_epoch = 0
        self.train_loss = []
        self.val_loss = []
        self.log_fn = (log_fn or (lambda d: None)) if self.rank == 0 else (lambda d: None)
        self._pending = None      # the in-flight async_save future
        if self.rank == 0:
            os.makedirs(logdir, exist_ok=True)
        self._barrier()

    def initial_state(self) -> TrainState:
        """The model with a fresh optimizer, at step 0 (DDP-wrapped on a
        mesh)."""
        return create_train_state(self.model, self.config, self.mesh)

    def finalize(self) -> None:
        """Wait for the in-flight checkpoint write, if any."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def _global_mean(self, losses) -> float:
        """The mean of this rank's losses, all-reduced over the data group
        (the global-batch mean under equal shards)."""
        if not losses:
            return float("nan")
        if self.data_group is None:
            return torch.stack(losses).mean().item()
        total = torch.stack(losses).sum()
        both = torch.stack([total, total.new_tensor(float(len(losses)))])
        dist.all_reduce(both, group=self.data_group)
        return (both[0] / both[1]).item()

    # ---- epoch phases -------------------------------------------------- #

    def train(self, state: TrainState, batches: Iterable[Batch], seed: int,
              log_every: int = 0) -> TrainState:
        """One epoch. The losses stay on the device and are fetched once, at
        the end; ``log_every > 0`` also fetches and logs every
        ``log_every``-th iteration's loss (the reference's per-iteration
        wandb logging). A non-finite loss aborts at either level, the
        counterpart of the reference's ``set_detect_anomaly(True)``."""
        losses = []
        for batch in batches:
            loss = self.train_step(state, batch, seed)
            losses.append(loss)
            self.cur_iter += 1
            if log_every and self.cur_iter % log_every == 0:
                loss_host = loss.item()
                if not math.isfinite(loss_host):
                    raise FloatingPointError(f"non-finite training loss at iter "
                                             f"{self.cur_iter} (epoch {self.cur_epoch + 1})")
                self.log_fn({"loss_iter": loss_host, "iter": self.cur_iter})
        epoch_loss = self._global_mean(losses)
        if losses and not math.isfinite(epoch_loss):
            raise FloatingPointError(f"non-finite mean training loss in epoch "
                                     f"{self.cur_epoch + 1}")
        self.train_loss.append(epoch_loss)
        self.cur_epoch += 1
        self.log_fn({"loss": epoch_loss, "epoch": self.cur_epoch})
        return state

    def validate(self, state: TrainState, batches: Iterable[Batch]) -> float:
        val = self._global_mean([self.eval_step(state, b) for b in batches])
        self.val_loss.append(val)
        self.log_fn({"val_loss": val, "epoch": self.cur_epoch})
        return val

    # ---- checkpointing -------------------------------------------------- #

    def _log_table(self) -> dict:
        return {
            "epoch": self.cur_epoch,
            "iter": self.cur_iter,
            "bestval": self.bestval,
            "bestval_epoch": self.bestval_epoch,
            "train_loss": self.train_loss,
            "val_loss": self.val_loss,
        }

    def _path(self, name: str) -> str:
        return os.path.join(self.logdir, name)

    def _write_log(self) -> None:
        """Rank 0 publishes ``recent.log`` (through a rename, so a reader
        never sees half of it)."""
        if self.rank == 0:
            tmp = self._path("recent.log.tmp")
            with open(tmp, "w") as f:
                json.dump(self._log_table(), f)
            os.replace(tmp, self._path("recent.log"))

    def save(self, state: TrainState) -> bool:
        """Write the most recent checkpoint, and the best one when the last
        validation is the best so far; returns whether it was. Every rank
        calls it."""
        save_best = bool(self.val_loss) and self.val_loss[-1] <= self.bestval
        if save_best:
            self.bestval = self.val_loss[-1]
            self.bestval_epoch = self.cur_epoch
        if self.config.checkpoint_backend == "orbax":
            self._save_dcp(state, save_best)
            return save_best
        model_sd = pmesh.full_state_dict(state.model)
        optim_sd = self._full_optimizer_state(state)
        if self.rank == 0:
            torch.save({k: v.detach().cpu() for k, v in model_sd.items()},
                       self._path("model.pth"))
            torch.save({"optimizer": optim_sd, "step": state.step}, self._path("optim.pth"))
            if save_best:
                shutil.copyfile(self._path("model.pth"), self._path("best_model.pth"))
                shutil.copyfile(self._path("optim.pth"), self._path("best_optim.pth"))
            self._write_log()
        self._barrier()
        return save_best

    def _tp_params(self, state: TrainState):
        """(name, parameter, tensor-parallel dim or None) of the model."""
        tp = pmesh.layout_of(state.model)
        dims = tp.dims if tp is not None else {}
        return [(n, p, dims.get(n)) for n, p in state.model.named_parameters()]

    def _full_optimizer_state(self, state: TrainState) -> dict:
        """The AdamW state_dict with tensor-parallel moments gathered to full
        tensors (a collective under tensor parallelism)."""
        sd = state.optimizer.state_dict()
        tp = pmesh.layout_of(state.model)
        if tp is None:
            return sd
        for i, (_, _, dim) in enumerate(self._tp_params(state)):
            if dim is not None and i in sd["state"]:
                sd["state"][i] = {k: pmesh.gather_full(v, dim, tp.group, tp.size)
                                  if k in ("exp_avg", "exp_avg_sq") else v
                                  for k, v in sd["state"][i].items()}
        return sd

    # ---- the "orbax" backend: torch.distributed.checkpoint ---------------- #

    def _dcp_state(self, state: TrainState) -> dict:
        """The DCP state dict: model tensors and AdamW moments, the
        tensor-parallel ones as DTensors sharded over the model axis, and the
        train step."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        tp = pmesh.layout_of(state.model)

        def wrap(t, dim):
            if dim is None:
                return t
            placements = [Replicate()] * tp.mesh.ndim
            placements[tp.mesh.mesh_dim_names.index("model")] = Shard(dim)
            return DTensor.from_local(t, tp.mesh, placements, run_check=False)

        dims = tp.dims if tp is not None else {}
        model = {k: wrap(v, dims.get(k)) for k, v in state.model.state_dict().items()}
        optim = {}
        for name, p, dim in self._tp_params(state):
            s = state.optimizer.state.get(p)
            if s:
                optim[name] = {"step": s["step"], "exp_avg": wrap(s["exp_avg"], dim),
                               "exp_avg_sq": wrap(s["exp_avg_sq"], dim)}
        return {"model": model, "optim": optim,
                "train_step": torch.tensor(state.step, dtype=torch.int64)}

    def _dcp_write(self, name: str, state: TrainState) -> None:
        """One async write into ``<name>.tmp``, at most one in flight."""
        import torch.distributed.checkpoint as dcp

        self.finalize()
        tmp = self._path(name + ".tmp")
        if self.rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._barrier()
        self._pending = dcp.async_save(self._dcp_state(state), checkpoint_id=tmp)

    def _dcp_commit(self, name: str, epoch: int) -> None:
        """Swap ``<name>.tmp`` in, the previous directory kept as
        ``<name>.prev`` until :meth:`_dcp_drop_previous`."""
        if self.rank == 0:
            path = self._path(name)
            with open(os.path.join(path + ".tmp", "epoch.json"), "w") as f:
                json.dump({"epoch": epoch}, f)
            if os.path.exists(path):
                if os.path.exists(path + ".prev"):
                    shutil.rmtree(path + ".prev")
                os.rename(path, path + ".prev")
            os.rename(path + ".tmp", path)

    def _save_dcp(self, state: TrainState, save_best: bool) -> None:
        """The JAX engine's order: one write in flight at a time, then the
        commit, and only after it ``recent.log``."""
        names = ["model.orbax"] + (["best_model.orbax"] if save_best else [])
        for name in names:
            self._dcp_write(name, state)
            self.finalize()
        self._barrier()
        for name in names:
            self._dcp_commit(name, self.cur_epoch)
        self._barrier()
        self._write_log()
        if self.rank == 0:
            for name in names:
                if os.path.exists(self._path(name + ".prev")):
                    shutil.rmtree(self._path(name + ".prev"))
        self._barrier()

    def _dcp_dir(self, name: str, epoch: int) -> Optional[str]:
        """The committed directory of ``name`` that holds ``epoch``."""
        for path in (self._path(name), self._path(name + ".prev")):
            try:
                with open(os.path.join(path, "epoch.json")) as f:
                    if json.load(f)["epoch"] == epoch:
                        return path
            except FileNotFoundError:
                continue
        return None

    def _resume_dcp(self, state: TrainState, path: str) -> None:
        import torch.distributed.checkpoint as dcp

        for _, p, _ in self._tp_params(state):
            if p not in state.optimizer.state:
                state.optimizer.state[p] = {
                    "step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
        sd = self._dcp_state(state)      # views of the state: loaded in place
        dcp.load(sd, checkpoint_id=path)
        state.step = int(sd["train_step"])

    def resume(self, state: TrainState, best: bool = False) -> Optional[TrainState]:
        """Restore ``state`` in place and the loss history from the most
        recent checkpoint (the best one with ``best=True``, the reference's
        behaviour), into the state's current layout; None when there is
        none."""
        prefix = "best_" if best else ""
        log = self._path("recent.log")
        if not os.path.exists(log):
            return None
        with open(log) as f:
            table = json.load(f)
        if self.config.checkpoint_backend == "orbax":
            path = self._dcp_dir(f"{prefix}model.orbax",
                                 table["bestval_epoch"] if best else table["epoch"])
            if path is None:
                return None
        else:
            paths = [self._path(f"{prefix}model.pth"), self._path(f"{prefix}optim.pth")]
            if not all(os.path.exists(p) for p in paths):
                return None
        self.cur_epoch = table["epoch"]
        self.cur_iter = table.get("iter", 0)
        self.bestval = table["bestval"]
        self.bestval_epoch = table.get("bestval_epoch", 0)
        self.train_loss = table["train_loss"]
        self.val_loss = table["val_loss"]
        if self.config.checkpoint_backend == "orbax":
            self._resume_dcp(state, path)
            return state
        full = torch.load(paths[0], map_location="cpu", weights_only=True)
        state.model.load_state_dict(pmesh.local_state_dict(state.model, full))
        opt = torch.load(paths[1], map_location="cpu", weights_only=True)
        tp = pmesh.layout_of(state.model)
        for i, (_, _, dim) in enumerate(self._tp_params(state)):
            if dim is not None and i in opt["optimizer"]["state"]:
                opt["optimizer"]["state"][i] = {
                    k: v.chunk(tp.size, dim)[tp.rank] if k in ("exp_avg", "exp_avg_sq") else v
                    for k, v in opt["optimizer"]["state"][i].items()}
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = int(opt["step"])
        return state

    # ---- full loop ------------------------------------------------------ #

    def fit(self, state: TrainState, train_batches_fn, val_batches_fn, epochs: int,
            seed: int, val_every: int = 5, save_every: int = 20,
            log_every: int = 0) -> TrainState:
        """``train_batches_fn``/``val_batches_fn``: callables returning a
        fresh iterable of batches for an epoch index; ``log_every`` as in
        ``train``."""
        try:
            for epoch in range(self.cur_epoch, epochs):
                t0 = time.time()
                state = self.train(state, train_batches_fn(epoch), seed, log_every)
                self.log_fn({"epoch_minutes": (time.time() - t0) / 60, "epoch": epoch})
                if epoch % val_every == 0:
                    self.validate(state, val_batches_fn(epoch))
                    if epoch % save_every == 0:
                        self.save(state)
        finally:
            self.finalize()
        return state
