"""Front ends over the GRACE pipeline; counterpart of the JAX package's
``interop``: :class:`~grace_tpu_torch.interop.bridge.GraceBridge` (one flat
gradient buffer through the exchange) and, in
:mod:`grace_tpu_torch.interop.torch`, the ``DistributedOptimizer`` over a
``torch.optim`` optimizer with ``broadcast_parameters`` and
``broadcast_optimizer_state``."""

from grace_tpu_torch.interop.bridge import GraceBridge

__all__ = ["GraceBridge"]
