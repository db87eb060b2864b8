"""Utilities; counterpart of the JAX package's ``utils`` (only
``metrics.payload_nbytes`` so far)."""

from grace_tpu_torch.utils.metrics import payload_nbytes

__all__ = ["payload_nbytes"]
