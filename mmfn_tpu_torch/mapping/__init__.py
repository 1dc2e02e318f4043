"""The vectorized map (.rmap) and its birdview raster."""

from mmfn_tpu_torch.mapping.rough_map import (  # noqa: F401
    RoughMap, build_rmap, vectorize_xodr, write_rmap)
