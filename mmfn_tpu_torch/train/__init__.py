"""Training: the engine (train step, validation, save and resume) and the
phase2 CLI (``python -m mmfn_tpu_torch.train.phase2``)."""

from mmfn_tpu_torch.train.engine import (  # noqa: F401
    Engine, TrainState, cilrs_loss, create_optimizer, create_train_state,
    make_eval_step, make_train_step, waypoint_l1_loss)
