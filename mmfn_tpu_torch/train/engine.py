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
an uninterrupted one and the ambient generators are left as they were.

Checkpoint files in ``logdir`` (``checkpoint_backend="msgpack"``, the only
backend; its name is kept so configs carry across, and it writes torch
files):

- ``recent.log``: the JAX package's JSON, same keys;
- ``model.pth`` / ``best_model.pth``: the model's state_dict under the
  reference checkpoint keys (CPU tensors), loadable by
  ``utils/weights.py:load_reference_state_dict`` and ``TorchPipeline``;
- ``optim.pth`` / ``best_optim.pth``: ``{"optimizer": the AdamW state_dict,
  "step": the train step}``, the names of the reference TransFuser trainer.

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
from torch import nn

from mmfn_tpu_torch.config import GlobalConfig
from mmfn_tpu_torch.data.batch import Batch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_optimizer(model: nn.Module, config: GlobalConfig) -> torch.optim.AdamW:
    """torch.optim.AdamW over all parameters, betas (0.9, 0.999), eps 1e-8,
    weight decay ``config.weight_decay`` on every parameter (the reference
    has no decay/no-decay split). The update is ``optax.adamw``'s: decay on
    the pre-update parameter, bias-corrected moments, eps outside the square
    root. torch picks the implementation (foreach on CUDA)."""
    return torch.optim.AdamW(model.parameters(), lr=config.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=config.weight_decay)


def create_train_state(model: nn.Module, config: GlobalConfig) -> TrainState:
    return TrainState(model, create_optimizer(model, config), 0)


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
    if getattr(model, "variant", "") == "cilrs":
        return cilrs_loss(model(batch, batch.command.to(torch.int32)), batch)
    return waypoint_l1_loss(model(batch), batch.waypoints)


def compute_dtype_of(name: str) -> torch.dtype:
    """``"float32"`` | ``"bfloat16"`` -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of train step ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def make_train_step(compute_dtype: str = "float32") -> Callable:
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
    """
    dtype = compute_dtype_of(compute_dtype)
    half = dtype != torch.float32

    def train_step(state: TrainState, batch: Batch, seed: int) -> torch.Tensor:
        model, optimizer = state.model, state.optimizer
        device = next(model.parameters()).device
        if not model.training:
            model.train()
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                   device_type=device.type):
            torch.manual_seed(step_seed(seed, state.step))
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
    contract in the module docstring)."""

    def __init__(self, model: nn.Module, config: GlobalConfig, logdir: str,
                 log_fn: Optional[Callable[[dict], None]] = None):
        if config.checkpoint_backend == "orbax":
            raise NotImplementedError("checkpoint_backend='orbax' (sharded async "
                                      "checkpoints across processes) is not ported to "
                                      "mmfn_tpu_torch yet (ROADMAP queue 1 item 4, multi-process)")
        if config.checkpoint_backend != "msgpack":
            raise ValueError(f"unknown checkpoint_backend {config.checkpoint_backend!r}")
        self.model = model
        self.config = config
        self.logdir = logdir
        self.train_step = make_train_step(config.compute_dtype)
        self.eval_step = make_eval_step()
        self.cur_epoch = 0
        self.cur_iter = 0
        self.bestval = 1e10
        self.bestval_epoch = 0
        self.train_loss = []
        self.val_loss = []
        self.log_fn = log_fn or (lambda d: None)
        os.makedirs(logdir, exist_ok=True)

    def initial_state(self) -> TrainState:
        """The model with a fresh optimizer, at step 0."""
        return create_train_state(self.model, self.config)

    def finalize(self) -> None:
        """Nothing to wait for: every checkpoint write is synchronous. Kept
        so that callers written for the JAX engine's async writes work."""

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
        epoch_loss = torch.stack(losses).mean().item() if losses else float("nan")
        if losses and not math.isfinite(epoch_loss):
            raise FloatingPointError(f"non-finite mean training loss in epoch "
                                     f"{self.cur_epoch + 1}")
        self.train_loss.append(epoch_loss)
        self.cur_epoch += 1
        self.log_fn({"loss": epoch_loss, "epoch": self.cur_epoch})
        return state

    def validate(self, state: TrainState, batches: Iterable[Batch]) -> float:
        losses = [self.eval_step(state, b) for b in batches]
        val = torch.stack(losses).mean().item() if losses else float("nan")
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

    def save(self, state: TrainState) -> bool:
        """Write the most recent checkpoint, and the best one when the last
        validation is the best so far; returns whether it was."""
        save_best = bool(self.val_loss) and self.val_loss[-1] <= self.bestval
        torch.save({k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                   self._path("model.pth"))
        torch.save({"optimizer": state.optimizer.state_dict(), "step": state.step},
                   self._path("optim.pth"))
        if save_best:
            self.bestval = self.val_loss[-1]
            self.bestval_epoch = self.cur_epoch
            shutil.copyfile(self._path("model.pth"), self._path("best_model.pth"))
            shutil.copyfile(self._path("optim.pth"), self._path("best_optim.pth"))
        with open(self._path("recent.log"), "w") as f:
            json.dump(self._log_table(), f)
        return save_best

    def resume(self, state: TrainState, best: bool = False) -> Optional[TrainState]:
        """Restore ``state`` in place and the loss history from the most
        recent checkpoint (the best one with ``best=True``, the reference's
        behaviour); None when there is none."""
        prefix = "best_" if best else ""
        paths = [self._path("recent.log"), self._path(f"{prefix}model.pth"),
                 self._path(f"{prefix}optim.pth")]
        if not all(os.path.exists(p) for p in paths):
            return None
        with open(paths[0]) as f:
            table = json.load(f)
        self.cur_epoch = table["epoch"]
        self.cur_iter = table.get("iter", 0)
        self.bestval = table["bestval"]
        self.bestval_epoch = table.get("bestval_epoch", 0)
        self.train_loss = table["train_loss"]
        self.val_loss = table["val_loss"]
        state.model.load_state_dict(torch.load(paths[1], map_location="cpu",
                                               weights_only=True))
        opt = torch.load(paths[2], map_location="cpu", weights_only=True)
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = int(opt["step"])
        return state

    # ---- full loop ------------------------------------------------------ #

    def fit(self, state: TrainState, train_batches_fn, val_batches_fn, epochs: int,
            seed: int, val_every: int = 5, save_every: int = 20) -> TrainState:
        """``train_batches_fn``/``val_batches_fn``: callables returning a
        fresh iterable of batches for an epoch index."""
        try:
            for epoch in range(self.cur_epoch, epochs):
                t0 = time.time()
                state = self.train(state, train_batches_fn(epoch), seed)
                self.log_fn({"epoch_minutes": (time.time() - t0) / 60, "epoch": epoch})
                if epoch % val_every == 0:
                    self.validate(state, val_batches_fn(epoch))
                    if epoch % save_every == 0:
                        self.save(state)
        finally:
            self.finalize()
        return state
