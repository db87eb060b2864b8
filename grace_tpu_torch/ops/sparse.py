"""Dense builds for sparse payloads: scatter and the chunk one-hot select.

Counterpart of the JAX package's ``ops/sparse.py``.
"""

from __future__ import annotations

import torch


def scatter_dense(values: torch.Tensor, indices: torch.Tensor, numel: int,
                  shape) -> torch.Tensor:
    """Place ``values`` at flat ``indices`` of a zero tensor of ``shape``.

    Indices are unique by construction (top-k selections), so a plain
    index write is the JAX ``.at[indices].set(values)``.
    """
    flat = torch.zeros(numel, dtype=values.dtype, device=values.device)
    flat[indices.long()] = values
    return flat.reshape(shape)


def chunkwise_dense(values: torch.Tensor, win_row: torch.Tensor, rows: int,
                    numel: int, shape) -> torch.Tensor:
    """One-hot row select for chunk-structured payloads.

    Exactly one element per column of the ``(rows, k)`` row-major view of
    the flat tensor is kept: element ``c`` lands at ``win_row[c]*k + c``.
    Padding in the last row is cut off by ``[:numel]``.
    """
    row_ids = torch.arange(rows, dtype=win_row.dtype, device=win_row.device)
    mask = row_ids[:, None] == win_row[None, :]
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    dense = torch.where(mask, values[None, :], zero)
    return dense.reshape(-1)[:numel].reshape(shape)
