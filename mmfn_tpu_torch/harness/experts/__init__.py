"""The rule-based experts that collect training data in the fake world."""

from mmfn_tpu_torch.harness.experts.world_view import Actor, EgoState, WorldView  # noqa: F401
from mmfn_tpu_torch.harness.experts.pilot import ExpertPilot, SimplePilot  # noqa: F401
