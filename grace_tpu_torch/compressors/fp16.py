"""Half-precision downcast; counterpart of the JAX ``compressors/fp16.py``.

The payload is the tensor cast to ``dtype`` (``'bfloat16'`` by default,
``'float16'`` for the reference's fp16); the ctx is the original dtype,
which ``decompress`` casts back to. A cast is linear, so payloads add
(``payload_algebra='exact'``), and the exact payload-space paths of the
ring, the reduce-scatter and the two-shot all-reduce apply.
"""

from __future__ import annotations

import dataclasses

import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class FP16Compressor(Compressor):
    dtype: str = "bfloat16"
    payload_algebra = "exact"
    # Linear codec: a requant round-trip would add nothing but work.
    supports_hop_requant = False

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown half dtype {self.dtype!r}; use one of "
                             f"{sorted(_DTYPES)}")

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        return (x.to(_DTYPES[self.dtype]),), x.dtype, state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        (x,) = payload
        return x.to(ctx)
