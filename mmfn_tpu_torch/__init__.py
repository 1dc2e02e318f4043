"""mmfn_tpu_torch: the MMFN driving stack in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``mmfn_tpu`` that stands on its own: it imports
torch and numpy, never jax or ``mmfn_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on a CPU tensor each kernel's
wrapper takes its plain PyTorch version.
"""

from mmfn_tpu_torch.config import GlobalConfig  # noqa: F401
