"""The MMFN model family (img, vec, rad) and the AIM, CILRS and TransFuser
baselines as torch modules."""

from mmfn_tpu_torch.models.baselines import build_baseline  # noqa: F401
from mmfn_tpu_torch.models.mmfn import MMFN, build_model  # noqa: F401
from mmfn_tpu_torch.models.registry import get_entry_point  # noqa: F401
