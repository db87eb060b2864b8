"""8-bit codebook quantisation (Dettmers 2015); counterpart of the JAX
package's ``compressors/u8bit.py``.

|x| over the largest |x| is looked up in a 127-level log-spaced codebook
(nearest level, by ``torch.searchsorted`` over the midpoints) and sent as
a signed int8 code with the scale. The codebook is the JAX package's
dynamic-tree grid, generated in numpy float32 the same way.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from grace_tpu_torch.core import Compressor, Ctx, LeafKey, Payload, State


@functools.lru_cache(maxsize=None)
def dynamic_tree_codebook() -> np.ndarray:
    """127 strictly increasing levels in (0, 1): decade ``e`` in ``[0, 6]``
    covers ``[10^-e·0.1, 10^-e)`` with ``6 − e`` linear fraction bits."""
    vals = []
    for e in range(7):
        b = 6 - e
        for m in range(2 ** b):
            frac = 0.1 + 0.9 * (m + 0.5) / 2 ** b
            vals.append(10.0 ** (-e) * frac)
    return np.sort(np.asarray(vals, np.float32))


def _book(device) -> torch.Tensor:
    return torch.from_numpy(dynamic_tree_codebook()).to(device)


@dataclasses.dataclass(frozen=True)
class U8bitCompressor(Compressor):
    # Codebook indices under a per-rank scale: no algebra.
    payload_algebra = None
    supports_hop_requant = False

    def compress(self, x: torch.Tensor, state: State, rng: LeafKey
                 ) -> tuple[Payload, Ctx, State]:
        flat = x.reshape(-1)
        book = _book(flat.device)
        scale = torch.max(flat.abs())
        normed = flat.abs() / torch.clamp_min(scale, 1e-30)
        mids = (book[1:] + book[:-1]) / 2
        idx = torch.searchsorted(mids, normed).to(torch.int8)   # [0, 126]
        code = torch.where(flat < 0, -idx, idx)
        return (code, scale), (tuple(x.shape), x.dtype), state

    def decompress(self, payload: Payload, ctx: Ctx) -> torch.Tensor:
        code, scale = payload
        shape, dtype = ctx
        wide = code.to(torch.int32)
        sign = torch.sign(wide).to(dtype)
        out = _book(code.device)[wide.abs().long()].to(dtype) * scale * sign
        return out.reshape(shape)
