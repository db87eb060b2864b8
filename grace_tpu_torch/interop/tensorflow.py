"""TensorFlow 2 front end: ``DistributedGradientTape`` over the port's
GRACE exchange; counterpart of the JAX package's
``interop/tensorflow.py``.

Wrap a ``tf.GradientTape`` so ``tape.gradient(...)`` returns the globally
aggregated, compressed-exchanged gradients. The exchange is the port's
:class:`~grace_tpu_torch.interop.bridge.GraceBridge` on this process's
rank of a ``torch.distributed`` group: the gradients are flattened
in-graph into one float32 buffer and carried to it by one host callout
(``tf.numpy_function``), so the wrapper works eagerly and inside
``@tf.function`` / ``model.fit``. On the card the callout copies the
buffer to the device, runs the exchange there (the chunk Top-K kernels on
the Top-K path) and copies the aggregate back.

TensorFlow is optional and imported only where it is used:
:class:`TFExchanger` and its :meth:`TFExchanger._host_exchange` (the
callout itself) run without it; :func:`DistributedGradientTape`,
:meth:`TFExchanger.exchange` and :func:`broadcast_variables` raise
``ImportError`` naming tensorflow when it is missing.

Where the JAX package takes a device ``mesh``, the port takes the process
``group`` (None: the group of the Grace's communicator) and the ``device``
the bridge's buffer lives on (the card unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch
import torch.distributed as dist

from grace_tpu_torch.parallel import resolve_device

__all__ = ["DistributedGradientTape", "TFExchanger", "broadcast_variables",
           "exchanger_for"]


def _require_tf():
    try:
        import tensorflow as tf
        return tf
    except ImportError as e:
        raise ImportError(
            "grace_tpu_torch.interop.tensorflow requires the optional "
            "tensorflow dependency") from e


class TFExchanger:
    """Embeds the port's GRACE exchange into TF graphs.

    Flattens a gradient list into one float32 buffer in-graph, routes it
    through a lazily built :class:`GraceBridge` via ``tf.numpy_function``
    (a stateful host callout, legal under ``@tf.function``), and splits the
    aggregate back to the original shapes and dtypes. ``IndexedSlices`` are
    densified first. The bridge is rebuilt when the buffer's length
    changes."""

    def __init__(self, grace, group=None, seed: int = 0, device="cuda"):
        self._grace = grace
        self._group = group
        self._seed = seed
        self._device = resolve_device(device)
        self._bridge = None
        self._pending_state = None   # restored state queued until build

    def _host_exchange(self, flat: np.ndarray) -> np.ndarray:
        """The callout: one ``(n,)`` float32 host buffer through the
        bridge on ``device`` and back to the host."""
        from grace_tpu_torch.interop.bridge import GraceBridge
        if self._bridge is None or self._bridge.n != flat.size:
            self._bridge = GraceBridge(self._grace, n=flat.size,
                                       group=self._group, seed=self._seed,
                                       device=self._device)
            if self._pending_state is not None:
                self._bridge.state = self._pending_state
                self._pending_state = None
        flat = np.asarray(flat, np.float32).reshape(-1)
        with warnings.catch_warnings():
            # TF hands the callout read-only buffers; the copy to the
            # device (or the clone on the CPU) is the only reader.
            warnings.simplefilter("ignore", UserWarning)
            local = torch.from_numpy(flat)
        local = (local.to(self._device) if self._device.type == "cuda"
                 else local.clone())
        out = self._bridge.exchange(local)
        return out.cpu().numpy().astype(np.float32, copy=False)

    @property
    def grace_state(self):
        """The compression state (None before the first exchange): include
        it in checkpoints; assign to restore. A restore before the first
        exchange is queued and applied when the bridge is built."""
        if self._bridge is None:
            return self._pending_state
        return self._bridge.state

    @grace_state.setter
    def grace_state(self, value):
        if self._bridge is None:
            self._pending_state = value
        else:
            self._bridge.state = value

    def exchange(self, grads):
        """list of tf.Tensor/IndexedSlices/None -> same-structure
        aggregated."""
        tf = _require_tf()
        dense = [None if g is None else tf.convert_to_tensor(g)
                 for g in grads]
        live = [g for g in dense if g is not None]
        if not live:
            return list(grads)
        sizes = [int(np.prod(g.shape)) for g in live]
        n = int(sum(sizes))
        flat = tf.concat(
            [tf.reshape(tf.cast(g, tf.float32), [-1]) for g in live], axis=0)
        out = tf.numpy_function(self._host_exchange, [flat], tf.float32,
                                stateful=True)
        out = tf.ensure_shape(out, [n])
        pieces = tf.split(out, sizes)
        results, it = [], iter(zip(live, pieces))
        for g in dense:
            if g is None:
                results.append(None)
            else:
                orig, piece = next(it)
                results.append(tf.cast(tf.reshape(piece, orig.shape),
                                       orig.dtype))
        return results


_EXCHANGERS: dict = {}   # id(grace) -> (weakref(grace), {key: exchanger})


def _shared_exchanger(grace, group, seed: int, device) -> TFExchanger:
    """One TFExchanger per Grace *instance* (per group, seed and device),
    process-wide.

    The reference idiom wraps the tape anew every step; a per-wrap
    exchanger would rebuild its bridge each step and reset the
    error-feedback state. Keyed by object identity (two equal configs are
    two models' states), evicted by a weakref finalizer when the Grace is
    collected. ``group=None`` is normalized to the group the bridge would
    use (the communicator's), so ``exchanger_for(grc)`` finds the
    exchanger of a tape built with that group given explicitly."""
    if group is None:
        group = grace.communicator.group
    key = id(grace)
    entry = _EXCHANGERS.get(key)
    if entry is None or entry[0]() is not grace:   # new object or id reuse
        ref = weakref.ref(grace, lambda _, k=key: _EXCHANGERS.pop(k, None))
        entry = _EXCHANGERS[key] = (ref, {})
    sub = entry[1]
    dev = resolve_device(device)
    ex = sub.get((group, seed, dev))
    if ex is None:
        ex = sub[(group, seed, dev)] = TFExchanger(grace, group=group,
                                                   seed=seed, device=dev)
    return ex


def exchanger_for(grace, group=None, seed: int = 0,
                  device="cuda") -> TFExchanger:
    """The process-wide exchanger a DistributedGradientTape with these
    arguments uses: its ``grace_state`` is the compression state to
    checkpoint and restore."""
    return _shared_exchanger(grace, group, seed, device)


def DistributedGradientTape(gradtape, grace, group=None, seed: int = 0,
                            device="cuda"):
    """Wrap ``tf.GradientTape`` so ``gradient()`` returns aggregated
    grads."""
    _require_tf()
    exchanger = _shared_exchanger(grace, group, seed, device)

    class _Wrapped(type(gradtape)):
        def __init__(self):
            self.__dict__.update(gradtape.__dict__)
            self._grace = grace
            self._exchanger = exchanger

        def gradient(self, target, sources, output_gradients=None):
            # A lone tensor source yields a lone gradient, not a list.
            single = not isinstance(sources, (list, tuple))
            grads = super().gradient(target, sources, output_gradients)
            if single:
                grads = [grads]
            results = self._exchanger.exchange(list(grads))
            return results[0] if single else results

    wrapped = _Wrapped.__new__(_Wrapped)
    _Wrapped.__init__(wrapped)
    return wrapped


# -- init-time variable sync ------------------------------------------------------

def _world(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _broadcast_arrays(arrays, root_rank: int, group=None) -> list:
    """Rank ``root_rank``'s copy of each numpy array, over ``group`` (on
    the card under NCCL); the arrays themselves at one rank or without a
    process group."""
    from grace_tpu_torch.parallel import broadcast_tree

    if _world(group) == 1:
        return list(arrays)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    tensors = [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
    return [t.cpu().numpy() for t in broadcast_tree(tensors, root_rank,
                                                    group)]


def broadcast_variables(variables, root_rank: int = 0, group=None) -> None:
    """Broadcast TF/Keras variables from ``root_rank`` to every rank of
    ``group``, in place. A no-op with no process group or at one rank."""
    _require_tf()
    if _world(group) == 1:
        return
    variables = list(variables)
    synced = _broadcast_arrays([np.asarray(v) for v in variables],
                               root_rank, group)
    for v, s in zip(variables, synced):
        v.assign(s.reshape(v.shape))
