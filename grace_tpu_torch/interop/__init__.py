"""Front ends over the GRACE pipeline; counterpart of the JAX package's
``interop``: :class:`~grace_tpu_torch.interop.bridge.GraceBridge` (one flat
gradient buffer through the exchange) and, in
:mod:`grace_tpu_torch.interop.torch`, the ``DistributedOptimizer`` over a
``torch.optim`` optimizer with ``broadcast_parameters`` and
``broadcast_optimizer_state``. The TensorFlow and Keras front ends,
:mod:`grace_tpu_torch.interop.tensorflow` (``DistributedGradientTape``) and
:mod:`grace_tpu_torch.interop.keras` (``DistributedOptimizer`` and the
callbacks), are imported by name only: neither is loaded here, and neither
imports TensorFlow until it is used."""

from grace_tpu_torch.interop.bridge import GraceBridge

__all__ = ["GraceBridge"]
