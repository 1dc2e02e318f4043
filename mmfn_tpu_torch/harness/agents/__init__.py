"""Serving pipelines and closed-loop agents.

The agents that need torch are imported on first use (module
``__getattr__``), so that ``python -m mmfn_tpu_torch.harness.agents.remote``
(the remote stack) and the torch-free agents start without torch.
"""

import importlib

from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, Track, VehicleControl  # noqa: F401

_LAZY = {
    "BaselineAgent": "baseline",
    "MMFNAgent": "e2e",
    "HostCopy": "pipeline",
    "HumanAgent": "human",
    "TorchPipeline": "pipeline",
    "RemoteAgent": "remote",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
