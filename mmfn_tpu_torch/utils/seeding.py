"""Global seeding, the ``init_torch`` analog of the reference
(run_steps/utils.py:77-84).

Seeds the ambient generators (python ``random``, legacy ``numpy.random`` and
torch's default generators on every device) and hands back an explicit CPU
``torch.Generator``, which takes the place of the JAX package's root PRNGKey:
``build_model`` draws the initial weights from it.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> torch.Generator:
    """Seed ambient RNGs and return a CPU generator seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    return torch.Generator().manual_seed(seed)
