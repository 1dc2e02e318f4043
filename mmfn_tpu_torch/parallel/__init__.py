"""Multi-process training and serving helpers (``parallel/mesh.py``)."""

from mmfn_tpu_torch.parallel.mesh import (  # noqa: F401
    destroy_distributed, full_state_dict, init_distributed, make_mesh, replicate,
    shard_batch, tensor_parallel_sharding)
