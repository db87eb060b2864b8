"""Chunk Top-K with residual error feedback, and its W-rank aggregate.

Each leaf keeps ``k = max(1, int(ratio · n))`` values: its flat buffer,
zero-padded to whole rows, is viewed as ``(rows, k)``; column ``c`` is
chunk ``c``, and keeps the entry of largest magnitude (the first such
row at a tie). The compensated gradient is ``gradient + residual``; the
residual becomes what was not kept. The aggregate is the mean over the W
ranks of their kept entries, each at its place in a dense leaf.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def kept(n: int, ratio: float) -> int:
    return max(1, int(n * ratio))


def select(comp: torch.Tensor, k: int) -> torch.Tensor:
    """The kept entries of a flat tensor, in place in a dense one."""
    n = comp.numel()
    rows = -(-n // k)
    m = F.pad(comp, (0, rows * k - n)).view(rows, k)
    win = m.abs().argmax(dim=0, keepdim=True)
    dense = torch.zeros_like(m).scatter_(0, win, m.gather(0, win))
    return dense.reshape(-1)[:n]


class Codec:
    """Residual state per rank and leaf; ``exchange`` is one step."""

    has_residual = True

    def __init__(self, grace: dict, shapes: Sequence[Tuple[int, ...]],
                 world: int, device):
        self.ratio = float(grace["compress_ratio"])
        self.world = world
        self.residuals = [[torch.zeros(s, device=device) for s in shapes]
                          for _ in range(world)]

    def exchange(self, grads: List[List[torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """``grads[r][l]``: rank r's gradient of leaf l → the mean of the
        ranks' kept entries, leaf by leaf."""
        out: List[Optional[torch.Tensor]] = [None] * len(grads[0])
        for r, leaves in enumerate(grads):
            for l, g in enumerate(leaves):
                comp = (g + self.residuals[r][l]).reshape(-1)
                dense = select(comp, kept(comp.numel(), self.ratio))
                self.residuals[r][l] = (comp - dense).view(g.shape)
                dense = dense.view(g.shape)
                out[l] = dense if out[l] is None else out[l] + dense
        return [o / self.world for o in out]
