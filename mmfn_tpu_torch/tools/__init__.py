"""Command-line tools of the port, run as ``python -m mmfn_tpu_torch.tools.<name>``:
``viz_attention``, ``render_birdview_samples`` and ``record_episode``, the
counterparts of the JAX package's ``scripts/`` of the same names."""
