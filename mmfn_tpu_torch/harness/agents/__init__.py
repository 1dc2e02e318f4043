"""Serving pipelines."""

from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline  # noqa: F401
