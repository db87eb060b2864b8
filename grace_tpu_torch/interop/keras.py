"""Keras front end: ``DistributedOptimizer``, the callbacks and a
grace-aware ``load_model``; counterpart of the JAX package's
``interop/keras.py``.

* Keras 3 optimizers funnel every update through ``apply``
  (``apply_gradients`` delegates to it), so that is the one hook: the
  wrapped optimizer's ``apply`` first routes the gradients through the
  port's exchange (one ``tf.numpy_function`` callout over a flat buffer,
  :mod:`grace_tpu_torch.interop.tensorflow`), usable under ``model.fit``.
* ``load_model`` loads the model and wraps its optimizer in place, its
  slot variables carried over.
* ``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback`` and
  ``LearningRateWarmupCallback`` are the reference Keras example's
  callbacks; the broadcast and the average run over ``torch.distributed``.

Keras is imported only on use: the callback classes are built the first
time one is named (their base class is Keras's).
"""

from __future__ import annotations

import numpy as np

from grace_tpu_torch.interop.tensorflow import (TFExchanger, _world,
                                                broadcast_variables)

__all__ = ["DistributedOptimizer", "load_model",
           "BroadcastGlobalVariablesCallback", "MetricAverageCallback",
           "LearningRateWarmupCallback"]


def _require_keras():
    try:
        import keras
        return keras
    except ImportError as e:
        raise ImportError(
            "grace_tpu_torch.interop.keras requires the optional "
            "keras/tensorflow dependency") from e


def _distributed_subclass(base_cls, grace, group, seed: int, device):
    """Subclass a Keras optimizer class so ``apply`` first routes the
    gradients through the compressed exchange."""

    class _Distributed(base_cls):
        _grace_exchanger = None

        def apply(self, grads, trainable_variables=None):
            if self._grace_exchanger is None:
                type(self)._grace_exchanger = TFExchanger(
                    grace, group=group, seed=seed, device=device)
            grads = self._grace_exchanger.exchange(list(grads))
            return super().apply(grads, trainable_variables)

    _Distributed.__name__ = base_cls.__name__
    _Distributed.__qualname__ = f"Distributed{base_cls.__name__}"
    return _Distributed


def DistributedOptimizer(optimizer, grace, group=None, seed: int = 0,
                         device="cuda"):
    """A new optimizer of a subclass of ``type(optimizer)`` whose updates go
    through the exchange, rebuilt from ``optimizer.get_config()``
    (hyperparameters and schedules kept)."""
    keras = _require_keras()
    if not isinstance(optimizer, keras.optimizers.Optimizer):
        raise TypeError(f"expected a keras optimizer, got {type(optimizer)}")
    cls = _distributed_subclass(type(optimizer), grace, group, seed, device)
    return cls.from_config(optimizer.get_config())


def load_model(filepath, grace, group=None, seed: int = 0, device="cuda",
               **kwargs):
    """``keras.saving.load_model`` with the saved optimizer revived as a
    DistributedOptimizer: the model is loaded as saved and its optimizer
    wrapped in place, every restored slot (iterations, momenta, ...)
    copied, so a resumed run continues where the checkpoint left off."""
    keras = _require_keras()
    model = keras.saving.load_model(filepath, **kwargs)
    opt = getattr(model, "optimizer", None)
    if opt is not None:
        wrapped = DistributedOptimizer(opt, grace, group=group, seed=seed,
                                       device=device)
        if getattr(opt, "built", False):
            wrapped.build(model.trainable_variables)
            for src, dst in zip(opt.variables, wrapped.variables):
                dst.assign(src)
        model.optimizer = wrapped
    return model


# -- callbacks ---------------------------------------------------------------------

_CALLBACKS = ("BroadcastGlobalVariablesCallback", "MetricAverageCallback",
              "LearningRateWarmupCallback")


def _build_callbacks() -> dict:
    base = _require_keras().callbacks.Callback

    class BroadcastGlobalVariablesCallback(base):
        """Sync model and optimizer variables from ``root_rank`` (a rank of
        ``group``) so every rank trains from one state."""

        def __init__(self, root_rank: int = 0, group=None):
            super().__init__()
            self.root_rank = root_rank
            self.group = group
            self._done = False

        def on_batch_end(self, batch, logs=None):
            # After the first step: every variable (lazily created
            # optimizer slots too) exists by then.
            if not self._done:
                broadcast_variables(self.model.variables, self.root_rank,
                                    self.group)
                if self.model.optimizer is not None:
                    broadcast_variables(self.model.optimizer.variables,
                                        self.root_rank, self.group)
                self._done = True

    class MetricAverageCallback(base):
        """Average the epoch-end metrics over the ranks of ``group``
        (:func:`grace_tpu_torch.parallel.metric_average`); the identity at
        one rank."""

        def __init__(self, group=None):
            super().__init__()
            self.group = group

        def _average(self, logs):
            if not logs or _world(self.group) == 1:
                return logs
            from grace_tpu_torch.parallel import metric_average
            keys = sorted(k for k, v in logs.items() if isinstance(
                v, (int, float, np.floating, np.integer)))
            if not keys:
                return logs
            local = np.asarray([float(logs[k]) for k in keys], np.float32)
            mean = metric_average(local, self.group)
            for i, k in enumerate(keys):
                logs[k] = float(mean[i])
            return logs

        def on_epoch_end(self, epoch, logs=None):
            self._average(logs)

    class LearningRateWarmupCallback(base):
        """Ramp the learning rate linearly from its configured value to
        ``value × world_size`` over ``warmup_epochs``, then hold it."""

        def __init__(self, world_size: int, warmup_epochs: int = 5,
                     verbose: bool = False):
            super().__init__()
            self.world_size = int(world_size)
            self.warmup_epochs = int(warmup_epochs)
            self.verbose = verbose
            self._base_lr = None

        def on_train_begin(self, logs=None):
            self._base_lr = float(
                np.asarray(self.model.optimizer.learning_rate))

        def on_epoch_begin(self, epoch, logs=None):
            progress = min(1.0, (epoch + 1) / max(1, self.warmup_epochs))
            factor = 1.0 + (self.world_size - 1.0) * progress
            lr = self._base_lr * factor
            self.model.optimizer.learning_rate = lr
            if self.verbose:
                print(f"LearningRateWarmup: epoch {epoch}: lr -> {lr:.6g}")

    return {"BroadcastGlobalVariablesCallback":
            BroadcastGlobalVariablesCallback,
            "MetricAverageCallback": MetricAverageCallback,
            "LearningRateWarmupCallback": LearningRateWarmupCallback}


def __getattr__(name: str):
    if name in _CALLBACKS:
        classes = _build_callbacks()
        globals().update(classes)
        return classes[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
