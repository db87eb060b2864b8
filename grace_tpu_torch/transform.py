"""The GRACE executors over a model's gradients.

Counterpart of the JAX package's ``grace_transform`` with ``fusion=None``
(one compress and one exchange per gradient leaf) and ``fusion='flat'``
(one pipeline over every leaf concatenated: the one-bucket case of its
bucketed executor), its ``GraceState`` and its per-leaf loop. The optax
``GradientTransformation`` becomes an object with ``init(params)`` and
``update(grads, state)``; the torch optimizer then applies the returned
updates.

Gradients and parameters are flat mappings from dotted names
(``"s0b0.conv1.w"``, as ``nn.Module.named_parameters`` gives them) to
tensors. Leaves are walked in the JAX flatten order of the same parameter
tree: sorted keys at every level of the path. Per-leaf chunk Top-K selects
over each leaf's flat order, so the two packages pick the same elements
only when they walk the same leaves in the same order with the same
layouts.

Random streams: leaf ``i`` at step ``count`` gets
``LeafKey(seed, count, i)`` (see :class:`grace_tpu_torch.core.LeafKey`),
the counterpart of ``fold_in(fold_in(key(seed), count), i)``; the flat
buffer gets bucket 0's, ``LeafKey(seed, count, 0)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from grace_tpu_torch.core import (Communicator, Compressor, LeafKey, Memory,
                                  State)


def leaf_order(names) -> List[str]:
    """``names`` in the JAX flatten order of the nested tree they spell."""
    return sorted(names, key=lambda name: tuple(name.split(".")))


def common_dtype(tensors) -> torch.dtype:
    """The dtype every tensor promotes to (the flat buffer's dtype)."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


@dataclasses.dataclass
class GraceState:
    count: int                # step counter, the same on every rank
    seed: int                 # base of the per-(step, leaf) streams
    mem: List[State]          # memory state per leaf in leaf_order, or one
    comp: List[State]         # compressor state likewise ('flat': one)


@dataclasses.dataclass(frozen=True)
class GraceTransform:
    compressor: Compressor
    memory: Memory
    communicator: Communicator
    seed: int = 0
    fusion: Optional[str] = None          # None (per leaf) or 'flat'

    def init(self, params: Mapping[str, torch.Tensor]) -> GraceState:
        leaves = [params[n] for n in leaf_order(params)]
        if self.fusion == "flat":
            leaves = [self._flatten(leaves)] if leaves else []
        return GraceState(count=0, seed=self.seed,
                          mem=[self.memory.init_state(p) for p in leaves],
                          comp=[self.compressor.init_state(p) for p in leaves])

    @staticmethod
    def _flatten(leaves) -> torch.Tensor:
        cdtype = common_dtype(leaves)
        return torch.cat([t.reshape(-1).to(cdtype) for t in leaves])

    def update(self, grads: Mapping[str, torch.Tensor], state: GraceState
               ) -> Tuple[Dict[str, torch.Tensor], GraceState]:
        """Local gradients → globally aggregated updates: one pipeline per
        leaf (``communicator.step_leaves``: each leaf's ``step`` with its
        states and stream, grouped where the communicator and codec allow),
        or with ``fusion='flat'`` one pipeline over the concatenated
        leaves."""
        names = leaf_order(grads)
        want = (1 if names else 0) if self.fusion == "flat" else len(names)
        if len(state.mem) != want:
            raise ValueError(
                f"grace state holds {len(state.mem)} buffers but this "
                f"transform (fusion={self.fusion!r}) runs {want} pipelines "
                "over these gradients: the state was built for another "
                "parameter set or fusion setting. Re-init it.")
        if self.fusion == "flat":
            return self._update_flat(grads, names, state)
        outs, new_mem, new_comp = self.communicator.step_leaves(
            [grads[n] for n in names], state.mem, state.comp, self.memory,
            self.compressor,
            [LeafKey(state.seed, state.count, i) for i in range(len(names))])
        return dict(zip(names, outs)), GraceState(
            count=state.count + 1, seed=state.seed, mem=new_mem,
            comp=new_comp)

    def _update_flat(self, grads, names, state: GraceState):
        """Concatenate the leaves in leaf order at their common dtype, run
        one ``communicator.step`` under ``LeafKey(seed, count, 0)``, and
        split the result back into the leaves."""
        outs = {}
        mem, comp = list(state.mem), list(state.comp)
        if names:
            leaves = [grads[n] for n in names]
            flat = self._flatten(leaves)
            out, ms, cs = self.communicator.step(
                flat, state.mem[0], state.comp[0], self.memory,
                self.compressor, LeafKey(state.seed, state.count, 0))
            off = 0
            for name, g in zip(names, leaves):
                size = g.numel()
                outs[name] = out[off:off + size].reshape(g.shape).to(g.dtype)
                off += size
            mem, comp = [ms], [cs]
        return outs, GraceState(count=state.count + 1, seed=state.seed,
                                mem=mem, comp=comp)


def grace_transform(compressor: Compressor, memory: Memory,
                    communicator: Communicator, seed: int = 0,
                    fusion: Optional[str] = None) -> GraceTransform:
    """Build the compressed-exchange transform. ``fusion=None`` runs one
    pipeline per leaf and ``'flat'`` one over all leaves concatenated; the
    grouped and bucketed executors are queued in ROADMAP."""
    if fusion is not None and fusion != "flat":
        raise NotImplementedError(
            f"fusion={fusion!r} is not ported yet; grace_tpu_torch runs one "
            "pipeline per leaf (fusion=None) or one over the flat buffer "
            "('flat'). 'grouped' and bucket fusion are queued in ROADMAP "
            "queue 1.")
    return GraceTransform(compressor, memory, communicator, seed=seed,
                          fusion=fusion)
