"""The port's own copies of the example metrics in ``examples/metrics/``,
each a ``BasicMetric`` of ``mmfn_tpu_torch.harness.metrics_log``. Run one
over a recording with ``python -m mmfn_tpu_torch.harness.metrics_run --log
<episode.json> --metric mmfn_tpu_torch/harness/metric_examples/<name>.py``.
"""
