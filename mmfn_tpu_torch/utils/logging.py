"""Metrics logging: wandb when available, JSONL always.

The reference logs per-iter loss / val loss / epoch minutes to wandb
(phase2_train_net.py:113-115,180,317). wandb is not a dependency: the same
dict stream lands in ``<logdir>/metrics.jsonl``, and both sinks share one
interface.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class bcolors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKCYAN = "\033[96m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


class MetricsLogger:
    def __init__(self, logdir: str, project: str = "mmfn_tpu",
                 mode: str = "auto", config: Optional[dict] = None):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._wandb = None
        if mode != "disabled":
            try:
                import wandb

                self._wandb = wandb.init(project=project, config=config or {},
                                         mode="offline" if mode == "offline" else "online")
            except Exception:   # wandb missing or unable to start: JSONL only
                self._wandb = None

    def log(self, metrics: dict) -> None:
        record = {"t": time.time(), **metrics}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
