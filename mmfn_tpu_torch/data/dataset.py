"""Phase-1 sample pools: ``PreprocessedDataset`` reads the pickled samples
that the JAX package's phase1 writes (one dict per ``.pkl``, the payload of
``CarlaDataset.__getitem__``), and hands them to ``collate.collate_samples``.

Decoding raw CARLA routes (``CarlaDataset``) and the phase-1 preprocessing
are not ported yet (ROADMAP queue 1 item 2, with the phase1 CLI).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict

import numpy as np


class PreprocessedDataset:
    """Reads phase-1 pickles (one sample per .pkl under root).

    The sorted file list is cached in ``<root>/preload_files.json`` (the
    reference PRE_Data preload): listing and sorting hundreds of thousands
    of pickles on network filesystems dominates startup otherwise. The
    pickles are trusted input, written by phase1 of this project."""

    def __init__(self, root: str, use_preload: bool = True):
        preload = os.path.join(root, "preload_files.json")
        if use_preload and os.path.exists(preload):
            with open(preload) as f:
                self.files = [os.path.join(root, f_) for f_ in json.load(f)]
            return
        names = sorted(f for f in os.listdir(root) if f.endswith(".pkl"))
        self.files = [os.path.join(root, f) for f in names]
        if use_preload:
            try:
                with open(preload, "w") as f:
                    json.dump(names, f)
            except OSError:     # a read-only pool still loads, uncached
                pass

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        with open(self.files[index], "rb") as f:
            return pickle.load(f)
