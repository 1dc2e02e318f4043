"""Tiny YAML-config + dotted-override CLI loader.

Replaces the reference's hydra stack (run_steps/config/*.yaml with CLI
overrides like ``port=2010 towns="[Town01]"``): ``load_config`` reads a YAML
file into a nested dict and applies ``key.subkey=value`` overrides with YAML
literal parsing. The port's own copy of the JAX package's loader; it reads
the same config files.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import yaml


class DotDict(dict):
    def __getattr__(self, k):
        # missing attributes must raise AttributeError, not KeyError:
        # deepcopy/hasattr/getattr-with-default probe dunder names and treat
        # KeyError as a real error
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v


def _to_dotdict(obj):
    if isinstance(obj, dict):
        return DotDict({k: _to_dotdict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_dotdict(v) for v in obj]
    return obj


def apply_override(cfg: dict, dotted: str, value: str) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, DotDict())
    node[keys[-1]] = yaml.safe_load(value)


def load_config(path: Optional[str], overrides: Optional[List[str]] = None,
                defaults: Optional[Dict] = None) -> DotDict:
    cfg: dict = dict(defaults or {})
    if path:
        with open(path) as f:
            cfg.update(yaml.safe_load(f) or {})
    cfg = _to_dotdict(cfg)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        apply_override(cfg, key, value)
    return cfg
