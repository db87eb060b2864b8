"""Checkpoint and resume, GRACE state included; counterpart of the JAX
package's ``checkpoint.py``, with ``torch.save`` files in place of orbax.

A train state (``train.TrainState``: the model, the torch optimizer and
the GRACE or guard state) is flattened into named leaves: the model's
``state_dict`` under ``model/``, the optimizer's under ``optimizer/``, and
the GraceState's fields (``grace/mem/3``, ``grace/inner/telem/rings``
under a guard). A step is a directory holding

* ``replicated.pt``: the leaves every rank holds alike (the model, the
  optimizer, ``count``, ``seed``, ``fallback``, the consensus ``audit``,
  the adaptive controller's ``adapt``, the guard's counters), written
  once, by rank 0;
* ``rank<r>.pt``: rank ``r``'s per-rank leaves (``mem``, ``comp``,
  ``telem``, ``watch``: ``transform.GRACE_VARYING_FIELDS``), one file a
  rank;
* ``meta.json``: every leaf's shape and dtype, and the world size.

A save is synchronous: it copies every tensor to the host before it
returns, so the next step's in-place kernels cannot reach what it wrote.
It is staged in a hidden directory and renamed into place once every rank
has written its file. Restore checks the stored leaves against the target
first, and names the first leaf that differs (``ValueError``), or raises
:class:`WorldSizeMismatch` when the number of rank files differs from the
world. ``last_known_good.json`` records the steps saved good, in the JAX
package's schema, for :meth:`Checkpointer.restore_last_good` and
:func:`divergence_rollback`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Checkpointer", "WorldSizeMismatch", "save_checkpoint",
           "restore_checkpoint", "latest_step", "divergence_rollback",
           "state_leaves"]


class WorldSizeMismatch(ValueError):
    """A checkpoint holds per-rank state for another number of ranks than
    the group restoring it: the signature of an elastic resize. Per-rank
    state (residuals, rings) is re-initialized at a new world, never
    re-partitioned: restore at the checkpoint's own world."""


_IO_RETRIES = 3
_IO_BACKOFF_S = 0.1


def _retry_io(fn: Callable[[], Any], what: str,
              retries: int = _IO_RETRIES,
              backoff_s: float = _IO_BACKOFF_S) -> Any:
    """Run ``fn``, retrying transient ``OSError``s with exponential backoff;
    anything else raises at once."""
    for attempt in range(retries):
        try:
            return fn()
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(backoff_s * (2 ** attempt))


# -- the state as named leaves -------------------------------------------------

def _node_children(node):
    """``[(name, child, varying)]`` of a state node, or None for a leaf.
    ``varying`` marks the GraceState fields that hold per-rank data."""
    from grace_tpu_torch.resilience.adapt import AdaptState
    from grace_tpu_torch.resilience.guard import GuardState, _COUNTERS
    from grace_tpu_torch.transform import (GRACE_HOST_FIELDS,
                                           GRACE_VARYING_FIELDS, GraceState)

    if isinstance(node, torch.nn.Module):
        return [(k, v, False) for k, v in node.state_dict().items()]
    if isinstance(node, torch.optim.Optimizer):
        return [(k, v, False) for k, v in node.state_dict().items()]
    if isinstance(node, GuardState):
        return [("inner", node.inner, False)] + [
            (name, getattr(node, name), False) for name in _COUNTERS]
    if isinstance(node, GraceState):
        return [(f.name, getattr(node, f.name),
                 f.name in GRACE_VARYING_FIELDS)
                for f in dataclasses.fields(node)
                if f.name not in GRACE_HOST_FIELDS]
    if isinstance(node, AdaptState):        # its pending decision made
        return [(name, value, False)
                for name, value in node._asdict().items()]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name), False)
                for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(k, getattr(node, k), False) for k in node._fields]
    if isinstance(node, dict):
        return [(str(k), v, False) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v, False) for i, v in enumerate(node)]
    return None


def state_leaves(tree, prefix: str = "") -> Dict[str, Tuple[Any, bool]]:
    """``{path: (leaf, varying)}`` of a state tree: a ``TrainState``, a
    GraceState or guard state, or dicts, lists and tuples of tensors and
    Python values. Paths join names with ``/`` (``model/fc.w``,
    ``grace/mem/3``); ``varying`` is True for per-rank leaves."""
    out: Dict[str, Tuple[Any, bool]] = {}

    def walk(node, path, varying):
        children = _node_children(node)
        if children is None:
            out[path] = (node, varying)
            return
        for name, child, v in children:
            walk(child, f"{path}/{name}" if path else name, varying or v)

    walk(tree, prefix, False)
    return out


def _meta(leaf) -> Tuple[Optional[tuple], str]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return None, type(leaf).__name__


def _rebuild(target, path: str, values: Dict[str, Any]):
    """A state of ``target``'s structure from the stored ``values``: the
    model and the optimizer load theirs in place; tensors land on the
    target's devices."""
    from grace_tpu_torch.resilience.adapt import AdaptState
    from grace_tpu_torch.resilience.guard import GuardState, _COUNTERS
    from grace_tpu_torch.transform import GRACE_HOST_FIELDS, GraceState

    join = (lambda n: f"{path}/{n}" if path else n)   # noqa: E731
    if isinstance(target, torch.nn.Module):
        target.load_state_dict({k: values[join(k)]
                                for k in target.state_dict()})
        return target
    if isinstance(target, torch.optim.Optimizer):
        state: dict = {}
        head = join("state") + "/"
        for p, v in values.items():
            if p.startswith(head):
                idx, key = p[len(head):].split("/", 1)
                state.setdefault(int(idx), {})[key] = v
        target.load_state_dict({
            "state": state,
            "param_groups": _rebuild(target.state_dict()["param_groups"],
                                     join("param_groups"), values)})
        return target
    if isinstance(target, GuardState):
        return GuardState(
            inner=_rebuild(target.inner, join("inner"), values),
            host_step=int(values[join("step")]),     # a host tensor here
            **{name: _rebuild(getattr(target, name), join(name), values)
               for name in _COUNTERS})
    if isinstance(target, AdaptState):
        return AdaptState(**{
            name: _rebuild(value, join(name), values)
            for name, value in target._asdict().items()})
    if isinstance(target, GraceState) or (
            dataclasses.is_dataclass(target)
            and not isinstance(target, type)):
        host = GRACE_HOST_FIELDS if isinstance(target, GraceState) else ()
        return dataclasses.replace(target, **{
            f.name: _rebuild(getattr(target, f.name), join(f.name), values)
            for f in dataclasses.fields(target) if f.name not in host})
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_rebuild(getattr(target, k), join(k), values)
                              for k in target._fields))
    if isinstance(target, dict):
        return {k: _rebuild(v, join(str(k)), values)
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_rebuild(v, join(str(i)), values)
                            for i, v in enumerate(target))
    if target is None and path not in values:
        return None          # a field the writer did not have (absent)
    value = values[path]
    if isinstance(target, torch.Tensor):
        return value.to(target.device)
    return value


def _unstepped_optimizers(tree, path: str = "") -> set:
    """The paths of the optimizers in ``tree`` that hold no state yet: SGD's
    momentum and Adam's moments appear at the first step, and
    ``load_state_dict`` takes the stored state as it is, so under these
    paths the stored leaves, not the target's, define the structure."""
    if isinstance(tree, torch.optim.Optimizer):
        return set() if tree.state_dict()["state"] else {path}
    found = set()
    for name, child, _ in _node_children(tree) or ():
        found |= _unstepped_optimizers(child,
                                       f"{path}/{name}" if path else name)
    return found


# -- the checkpointer ----------------------------------------------------------

class Checkpointer:
    """Steps of a train state under ``directory``::

        ckpt = Checkpointer(dir, max_to_keep=3)
        ckpt.save(step, state, good=True)       # synchronous
        state = ckpt.restore(state)             # latest, or step=N
        state = ckpt.restore_last_good(state)   # divergence recovery
        ckpt.close()

    ``good`` records per-step health in ``last_known_good.json``: a step
    saved with ``good=True`` is a candidate for :meth:`restore_last_good`.
    The caller decides what good means, typically "the guard reported no
    skipped step since the last save" (``utils.metrics.guard_report``).
    ``group``: the process group whose ranks each write their per-rank
    file (None: the default group, when one is initialised)."""

    _GOOD_FILE = "last_known_good.json"

    def __init__(self, directory, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, group: Optional[Any] = None):
        self._dir = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.group = group

    @property
    def directory(self) -> str:
        return self._dir

    def _rank_world(self) -> Tuple[int, int]:
        if dist.is_available() and dist.is_initialized():
            return (dist.get_rank(self.group),
                    dist.get_world_size(self.group))
        return 0, 1

    def _barrier(self) -> None:
        if self._rank_world()[1] > 1:
            dist.barrier(group=self.group)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    # -- last-known-good tracking -------------------------------------------
    @property
    def _good_path(self) -> str:
        return os.path.join(self._dir, self._GOOD_FILE)

    def _read_good(self) -> list:
        try:
            with open(self._good_path) as f:
                return list(json.load(f)["good_steps"])
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return []

    def _write_good(self, steps: list) -> None:
        """Atomic, retried sidecar write by rank 0: a temp file, fsync,
        ``os.replace``; an interrupted write leaves the old record whole."""
        if self._rank_world()[0] != 0:
            return
        payload = json.dumps(
            {"good_steps": sorted(set(int(s) for s in steps))})
        tmp = self._good_path + ".tmp"

        def write():
            os.makedirs(self._dir, exist_ok=True)
            with open(tmp, "w") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._good_path)

        _retry_io(write, "last-known-good sidecar")

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, force: bool = False,
             good: Optional[bool] = None) -> bool:
        """Save ``state`` at ``step``; every rank of the group calls it.
        Returns False (and writes nothing) for a step off the save
        interval unless ``force``. ``good`` marks (True) or unmarks (False)
        the step as known-good; None leaves the record as it is."""
        if not force and step % self.save_interval_steps:
            return False
        rank, world = self._rank_world()
        leaves = state_leaves(state)
        host = {p: (v.detach().cpu().clone()
                    if isinstance(v, torch.Tensor) else v, var)
                for p, (v, var) in leaves.items()}
        tmp = os.path.join(self._dir, f".{int(step)}.tmp")
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()

        def write(name, obj):
            path = os.path.join(tmp, name)
            _retry_io(lambda: torch.save(obj, path),
                      f"checkpoint save at step {step}")

        write(f"rank{rank}.pt", {p: v for p, (v, var) in host.items()
                                 if var})
        if rank == 0:
            write("replicated.pt", {p: v for p, (v, var) in host.items()
                                    if not var})
            meta = {"world": world, "leaves": {
                p: {"shape": _meta(v)[0], "dtype": _meta(v)[1],
                    "varying": var} for p, (v, var) in host.items()}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
        self._barrier()
        if rank == 0:
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            _retry_io(lambda: os.replace(tmp, final),
                      f"checkpoint commit at step {step}")
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self._barrier()
        if good is not None:
            self.mark_good(step, good)
        return True

    def mark_good(self, step: int, good: bool = True) -> None:
        """(Un)mark a saved step as known-good."""
        steps = [s for s in self._read_good() if s != step]
        if good:
            steps.append(step)
        self._write_good(steps)

    def last_good_step(self) -> Optional[int]:
        """Newest step recorded good that still exists on disk."""
        existing = set(self.all_steps())
        good = [s for s in self._read_good() if s in existing]
        return max(good) if good else None

    def restore_last_good(self, target: Any) -> Any:
        """Restore the newest known-good step (see :meth:`save`)."""
        step = self.last_good_step()
        if step is None:
            raise FileNotFoundError(
                f"no known-good checkpoint under {self._dir} — save "
                "with good=True to record rollback candidates")
        return self.restore(target, step=step)

    # -- restore ------------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``target`` (the latest step when
        ``step`` is None): the model and optimizer load in place, the GRACE
        state comes back new, on the target's devices."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self._dir}")
        step_dir = self._step_dir(step)
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        self._check_structure(step, meta, target)
        rank, _ = self._rank_world()
        values = torch.load(os.path.join(step_dir, "replicated.pt"),
                            weights_only=False)
        values.update(torch.load(os.path.join(step_dir, f"rank{rank}.pt"),
                                 weights_only=False))
        return _rebuild(target, "", values)

    def _check_structure(self, step: int, meta: dict, target: Any) -> None:
        stored = meta["leaves"]
        leaves = state_leaves(target)
        fresh = _unstepped_optimizers(target)

        def kept(p):
            return not any(p.startswith(f"{o}/state/") for o in fresh)

        # A field that is None in the target and absent from the checkpoint
        # (``audit``, ``watch`` before they existed) matches: both are off.
        only_target = sorted(p for p in leaves if p not in stored
                             and leaves[p][0] is not None)
        only_stored = sorted(p for p in stored
                             if p not in leaves and kept(p))
        for paths, side, other in ((only_target, "target", "checkpoint"),
                                   (only_stored, "checkpoint", "target")):
            if paths:
                raise ValueError(
                    f"checkpoint structure mismatch at leaf '{paths[0]}': "
                    f"present in the {side} but not in the {other} "
                    f"(checkpoint step {step} under {self._dir}). Restore "
                    "with a target built from the same optimizer/model "
                    "config the checkpoint was written with.")
        for path in sorted(p for p in leaves if p in stored):
            t_shape, t_dtype = _meta(leaves[path][0])
            s_shape = stored[path]["shape"]
            s_shape = tuple(s_shape) if s_shape is not None else None
            s_dtype = stored[path]["dtype"]
            if t_shape is None or s_shape is None:
                continue
            if s_shape != t_shape or s_dtype != t_dtype:
                raise ValueError(
                    f"checkpoint leaf '{path}' does not match the target: "
                    f"saved shape {s_shape} dtype {s_dtype}, target shape "
                    f"{t_shape} dtype {t_dtype} (checkpoint step {step} "
                    f"under {self._dir}). Restore with a target built from "
                    "the same optimizer/model config the checkpoint was "
                    "written with.")
        world = self._rank_world()[1]
        varying = sorted(p for p, m in stored.items() if m["varying"])
        if varying and meta["world"] != world:
            raise WorldSizeMismatch(
                f"checkpoint leaf '{varying[0]}' is per-rank state saved by "
                f"{meta['world']} ranks, but this group has {world}: this "
                f"looks like a world-size change (checkpoint world "
                f"{meta['world']}, target world {world}; step {step} under "
                f"{self._dir}). Restore into a group of {meta['world']} "
                "ranks; per-rank state (mem, comp, telem) is re-initialized "
                "at a new world, never re-partitioned.")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(d) for d in os.listdir(self._dir) if d.isdecimal()
                      and os.path.isdir(os.path.join(self._dir, d)))

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        pass

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_checkpoint(directory, state: Any, step: int) -> None:
    """One-shot save (for scripts and tests)."""
    with Checkpointer(directory, max_to_keep=None) as ckpt:
        ckpt.save(step, state, force=True)


def restore_checkpoint(directory, target: Any,
                       step: Optional[int] = None) -> Any:
    """One-shot restore of the latest (or given) step into ``target``."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory at {directory}")
    with Checkpointer(directory) as ckpt:
        return ckpt.restore(target, step=step)


def latest_step(directory) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    return Checkpointer(directory).latest_step()


def divergence_rollback(ckpt: Checkpointer, target: Any, *,
                        failed_step: int, skip_window: int = 1
                        ) -> Tuple[Any, int, int]:
    """Recovery from sustained divergence: restore the last known-good
    state and skip the data window that poisoned the run. Returns
    ``(state, good_step, failed_step + skip_window)``: the state, the step
    it came from, and the data cursor to resume at."""
    state = ckpt.restore_last_good(target)
    good_step = ckpt.last_good_step()
    return state, good_step, failed_step + skip_window
