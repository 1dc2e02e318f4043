"""Serving pipelines and closed-loop agents."""

from mmfn_tpu_torch.harness.agents.base import AutonomousAgent, Track, VehicleControl  # noqa: F401
from mmfn_tpu_torch.harness.agents.baseline import BaselineAgent  # noqa: F401
from mmfn_tpu_torch.harness.agents.e2e import MMFNAgent  # noqa: F401
from mmfn_tpu_torch.harness.agents.pipeline import HostCopy, TorchPipeline  # noqa: F401
