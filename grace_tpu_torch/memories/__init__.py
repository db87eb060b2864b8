"""Error-feedback memories; counterpart of the JAX ``memories/__init__.py``
(``NoneMemory`` and ``ResidualMemory``; the others are queued in ROADMAP)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from grace_tpu_torch.core import Compressor, Ctx, Memory, Payload, State

__all__ = ["NoneMemory", "ResidualMemory"]

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
