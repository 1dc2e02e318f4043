"""Model registry, the counterpart of the reference's hydra entry points.

The reference selects a model with ``train_agent.entry_point`` strings like
``mmfn_utils.models.model_vec:MMFN`` (run_steps/utils.py:68-72). The short
names (``mmfn_img``, ``mmfn_vec``, ``mmfn_rad``, and the baselines ``aim``,
``cilrs`` and ``transfuser``) and the reference's MMFN strings resolve to a
factory ``(config, generator=None, device=None) -> model``, as
``build_model`` and ``build_baseline`` take them; any other ``module:attr``
is imported.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from mmfn_tpu_torch.models.baselines import BASELINES, build_baseline
from mmfn_tpu_torch.models.mmfn import VARIANTS, build_model


def _mmfn_factory(variant: str) -> Callable:
    def build(config, generator=None, device=None):
        return build_model(config, variant, generator, device=device)
    return build


def _baseline_factory(name: str) -> Callable:
    def build(config, generator=None, device=None):
        return build_baseline(name, config, generator, device=device)
    return build


MODEL_REGISTRY: Dict[str, Callable] = {}
for _variant in VARIANTS:
    MODEL_REGISTRY[f"mmfn_{_variant}"] = _mmfn_factory(_variant)
    MODEL_REGISTRY[f"mmfn_utils.models.model_{_variant}:MMFN"] = _mmfn_factory(_variant)
for _name in BASELINES:
    MODEL_REGISTRY[_name] = _baseline_factory(_name)


def get_entry_point(name: str) -> Callable:
    """Resolve a model factory by registry name or ``module:attr`` path."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if ":" in name:
        module, attr = name.split(":")
        return getattr(importlib.import_module(module), attr)
    raise KeyError(f"unknown model entry point: {name!r}; known: {sorted(MODEL_REGISTRY)}")
