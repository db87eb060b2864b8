"""The benchmark of grace_tpu_torch: see README.md."""
