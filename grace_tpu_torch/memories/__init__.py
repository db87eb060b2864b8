"""Error-feedback memories; counterpart of the JAX ``memories/__init__.py``:
``NoneMemory``, ``ResidualMemory``, ``EFSignSGDMemory``, ``DgcMemory``
and ``PowerSGDMemory``. Each memory's per-leaf state is returned, never
kept in the object, as the transform holds it per leaf."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from grace_tpu_torch.core import (Compressor, Ctx, Memory, Payload, State,
                                  mean_scale)
from grace_tpu_torch.telemetry import counters

__all__ = ["NoneMemory", "ResidualMemory", "EFSignSGDMemory", "DgcMemory",
           "PowerSGDMemory"]

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class NoneMemory(Memory):
    """No-op memory."""


@dataclasses.dataclass(frozen=True)
class ResidualMemory(Memory):
    """Classic error feedback: compensate ``β·residual + γ·grad``; update
    ``residual = compensated − decompress(payload)``.

    ``state_dtype`` stores the residual narrower than the gradient
    (``'bfloat16'``); the compensate math still runs in the gradient's
    dtype, and a non-float32 state takes the staged pipeline.
    """

    beta: float = 1.0
    gamma: float = 1.0
    state_dtype: Optional[str] = None   # None = the gradient's dtype

    def __post_init__(self):
        if self.state_dtype is not None and self.state_dtype not in _STATE_DTYPES:
            raise ValueError(f"unknown state_dtype {self.state_dtype!r}; use "
                             f"one of {sorted(_STATE_DTYPES)}")

    @property
    def linear_feedback_coeffs(self):
        """Declares ``compensate = beta*state + gamma*x`` and ``update =
        compensated - decompress``: the contract of the fused fast path."""
        return (self.beta, self.gamma)

    def init_state(self, x: torch.Tensor) -> State:
        dt = _STATE_DTYPES[self.state_dtype] if self.state_dtype else x.dtype
        return torch.zeros(x.shape, dtype=dt, device=x.device)

    def compensate(self, x: torch.Tensor, state: State):
        return self.beta * state.to(x.dtype) + self.gamma * x, state

    def update(self, compensated: torch.Tensor, payload: Payload, ctx: Ctx,
               compressor: Compressor, state: State) -> State:
        resid = compensated - compressor.decompress(payload, ctx)
        return resid.to(state.dtype)


@dataclasses.dataclass(frozen=True)
class EFSignSGDMemory(Memory):
    """EF-SignSGD's memory: compensate ``residual + lr·grad``, update
    ``compensated − decompress``. The paired compressor's aggregate divides
    by ``lr`` again."""

    lr: float = 0.1

    @property
    def linear_feedback_coeffs(self):
        """``compensate = 1.0*state + lr*x`` (see ResidualMemory)."""
        return (1.0, self.lr)

    def init_state(self, x: torch.Tensor) -> State:
        return torch.zeros_like(x)

    def compensate(self, x: torch.Tensor, state: State):
        return state + self.lr * x, state

    def update(self, compensated: torch.Tensor, payload: Payload, ctx: Ctx,
               compressor: Compressor, state: State) -> State:
        return compensated - compressor.decompress(payload, ctx)


@dataclasses.dataclass(frozen=True)
class DgcMemory(Memory):
    """DGC's momentum-corrected memory.

    compensate: optionally clip the gradient at the root mean square of
    the group's squared sums (``sqrt(Σ_ranks Σ x² / W)``, an all-reduce
    over ``group``), then ``u = m·u + g`` and ``v = v + u``. update: zero
    both accumulators at the lanes that were sent, which decompress to a
    nonzero value (``decompress(...) == 0`` keeps a lane)."""

    momentum: float = 0.9
    gradient_clipping: bool = False
    group: Optional[Any] = None    # torch.distributed group; None = default

    def init_state(self, x: torch.Tensor) -> State:
        return {"residual": torch.zeros_like(x),
                "gradient": torch.zeros_like(x)}

    def compensate(self, x: torch.Tensor, state: State):
        if self.gradient_clipping:
            sq_sum = torch.sum(x * x)
            counters.count("all_reduce", sq_sum)
            dist.all_reduce(sq_sum, op=dist.ReduceOp.SUM, group=self.group)
            w = dist.get_world_size(self.group)
            clip = torch.sqrt(sq_sum * mean_scale(w))      # sq_sum / w
            x = torch.clamp(x, -clip, clip)
        residual = self.momentum * state["residual"] + x
        gradient = state["gradient"] + residual
        return gradient, {"residual": residual, "gradient": gradient}

    def update(self, compensated: torch.Tensor, payload: Payload, ctx: Ctx,
               compressor: Compressor, state: State) -> State:
        keep = (compressor.decompress(payload, ctx) == 0).to(
            compensated.dtype)
        return {"residual": state["residual"] * keep,
                "gradient": state["gradient"] * keep}


@dataclasses.dataclass(frozen=True)
class PowerSGDMemory(Memory):
    """PowerSGD's error feedback: the residual only (Q is the compressor's
    state); 1-D leaves bypass it."""

    def init_state(self, x: torch.Tensor) -> State:
        return None if x.dim() <= 1 else torch.zeros_like(x)

    def compensate(self, x: torch.Tensor, state: State):
        if state is None:
            return x, state
        return x + state, state

    def update(self, compensated: torch.Tensor, payload: Payload, ctx: Ctx,
               compressor: Compressor, state: State) -> State:
        if state is None:
            return state
        return compensated - compressor.decompress(payload, ctx)
