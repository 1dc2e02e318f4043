"""Model registry, the counterpart of the reference's hydra entry points.

The reference selects a model with ``train_agent.entry_point`` strings like
``mmfn_utils.models.model_vec:MMFN`` (run_steps/utils.py:68-72). Both the
short names (``mmfn_img``, ``mmfn_vec``, ``mmfn_rad``) and the reference's
strings resolve to a factory ``(config, generator=None, device=None) ->
model``, as ``build_model`` takes them; any other ``module:attr`` is
imported. The AIM, CILRS and TransFuser baselines are not ported yet
(ROADMAP item 7): their names raise ``NotImplementedError``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

from mmfn_tpu_torch.models.mmfn import VARIANTS, build_model

BASELINES = ("aim", "cilrs", "transfuser")


def _mmfn_factory(variant: str) -> Callable:
    def build(config, generator=None, device=None):
        return build_model(config, variant, generator, device=device)
    return build


MODEL_REGISTRY: Dict[str, Callable] = {}
for _variant in VARIANTS:
    MODEL_REGISTRY[f"mmfn_{_variant}"] = _mmfn_factory(_variant)
    MODEL_REGISTRY[f"mmfn_utils.models.model_{_variant}:MMFN"] = _mmfn_factory(_variant)


def get_entry_point(name: str) -> Callable:
    """Resolve a model factory by registry name or ``module:attr`` path."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in BASELINES:
        raise NotImplementedError(f"model {name!r}: the baselines are not ported to "
                                  "mmfn_tpu_torch yet (ROADMAP item 7)")
    if ":" in name:
        module, attr = name.split(":")
        return getattr(importlib.import_module(module), attr)
    raise KeyError(f"unknown model entry point: {name!r}; "
                   f"known: {sorted(MODEL_REGISTRY) + list(BASELINES)}")
