"""The per-leaf GRACE executor over a model's gradients.

Counterpart of the JAX package's ``grace_transform`` with ``fusion=None``
(one compress and one exchange per gradient leaf), its ``GraceState`` and
its per-leaf loop. The optax ``GradientTransformation`` becomes an object
with ``init(params)`` and ``update(grads, state)``; the torch optimizer
then applies the returned updates.

Gradients and parameters are flat mappings from dotted names
(``"s0b0.conv1.w"``, as ``nn.Module.named_parameters`` gives them) to
tensors. Leaves are walked in the JAX flatten order of the same parameter
tree: sorted keys at every level of the path. Per-leaf chunk Top-K selects
over each leaf's flat order, so the two packages pick the same elements
only when they walk the same leaves in the same order with the same
layouts.

Random streams: leaf ``i`` at step ``count`` gets
``LeafKey(seed, count, i)`` (see :class:`grace_tpu_torch.core.LeafKey`),
the counterpart of ``fold_in(fold_in(key(seed), count), i)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from grace_tpu_torch.core import (Communicator, Compressor, LeafKey, Memory,
                                  State)


def leaf_order(names) -> List[str]:
    """``names`` in the JAX flatten order of the nested tree they spell."""
    return sorted(names, key=lambda name: tuple(name.split(".")))


@dataclasses.dataclass
class GraceState:
    count: int                # step counter, the same on every rank
    seed: int                 # base of the per-(step, leaf) streams
    mem: List[State]          # memory state per leaf, in leaf_order
    comp: List[State]         # compressor state per leaf, in leaf_order


@dataclasses.dataclass(frozen=True)
class GraceTransform:
    compressor: Compressor
    memory: Memory
    communicator: Communicator
    seed: int = 0

    def init(self, params: Mapping[str, torch.Tensor]) -> GraceState:
        leaves = [params[n] for n in leaf_order(params)]
        return GraceState(count=0, seed=self.seed,
                          mem=[self.memory.init_state(p) for p in leaves],
                          comp=[self.compressor.init_state(p) for p in leaves])

    def update(self, grads: Mapping[str, torch.Tensor], state: GraceState
               ) -> Tuple[Dict[str, torch.Tensor], GraceState]:
        """Local gradients → globally aggregated updates, one pipeline per
        leaf: ``communicator.step`` with that leaf's states and stream."""
        names = leaf_order(grads)
        if len(names) != len(state.mem):
            raise ValueError(
                f"grace state holds {len(state.mem)} leaves but the "
                f"gradients have {len(names)}: the state was built for "
                "another parameter set. Re-init it.")
        outs, new_mem, new_comp = {}, [], []
        for i, name in enumerate(names):
            rng = LeafKey(state.seed, state.count, i)
            out, ms, cs = self.communicator.step(
                grads[name], state.mem[i], state.comp[i], self.memory,
                self.compressor, rng)
            outs[name] = out
            new_mem.append(ms)
            new_comp.append(cs)
        return outs, GraceState(count=state.count + 1, seed=state.seed,
                                mem=new_mem, comp=new_comp)


def grace_transform(compressor: Compressor, memory: Memory,
                    communicator: Communicator, seed: int = 0,
                    fusion: Optional[str] = None) -> GraceTransform:
    """Build the compressed-exchange transform. Only ``fusion=None`` (one
    pipeline per leaf) is ported; the flat, grouped and bucketed fusion
    executors are queued in ROADMAP."""
    if fusion is not None:
        raise NotImplementedError(
            f"fusion={fusion!r} is not ported yet; grace_tpu_torch runs one "
            "pipeline per leaf (fusion=None). 'flat', 'grouped' and bucket "
            "fusion are queued in ROADMAP queue 1.")
    return GraceTransform(compressor, memory, communicator, seed=seed)
