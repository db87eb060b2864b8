"""Runnable examples of the port (``python -m grace_tpu_torch.examples.<name>``).
Importing a module here does no work."""
