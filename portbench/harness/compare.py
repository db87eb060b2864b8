"""The comparison that decides ``correct``, and the readings it compares.

A run's readings are taken from the training step that set-up builds and
hands to the window, over its first three steps, and the reference
follows the same three from the same weights and batches:

* ``loss``: each step's loss, the mean over the ranks;
* ``update``: each leaf's norm of the first update as the optimizer got
  it, worked out from its state after one step (SGD's momentum buffer;
  Adam's first moment over ``1 − β1``), every rank's;
* ``change``: each leaf's norm of the parameters' change after three
  steps, every rank's;
* ``residual``: each rank's norm of each leaf's error-feedback residual
  after three steps, where the codec keeps one.

The numbers compared, each against its cell's limit:

* ``loss_gap``: the largest over the steps of |program − reference| over
  |reference|;
* ``update_gap``, ``change_gap``, ``residual_gap``: by the worst leaf (and
  rank), the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger. ``change_gap`` leaves out leaves whose reference gradient is
  nought to rounding: under a thousandth of the median leaf's;
* ``update_median_gap``, ``change_median_gap``, ``residual_median_gap``:
  the same gaps' median over the leaves (the largest over the ranks),
  steady from seed to seed where one small leaf's gap swings.

A cell's ``limits/<cell>.json`` says which of them it compares: a number
whose limit is null is printed and not compared.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

# Leaves whose reference gradient norm is under this share of the median
# leaf's move by round-off alone.
NOUGHT = 1e-3


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``prog``: (R, L) norms of R ranks; ``ref``: (L,) or (R, L). Each
    rank's and leaf's gap, the leaves not kept left out (R, kept L)."""
    prog = prog.double()
    ref = ref.double().expand_as(prog)
    med = ref.median(dim=1, keepdim=True).values
    gap = (prog - ref).abs() / torch.maximum(ref, med)
    return gap if keep is None else gap[:, keep]


def numbers(prog: Dict, ref: Dict, names: Sequence[str]
            ) -> Dict[str, Tuple[float, str]]:
    """Each number with where it was worst."""
    out = {}
    lp = torch.tensor(prog["loss"], dtype=torch.float64)
    lr = torch.tensor(ref["loss"], dtype=torch.float64)
    rel = (lp - lr).abs() / lr.abs()
    step = int(rel.argmax()) if not torch.isnan(rel).any() else -1
    out["loss_gap"] = (float(rel.max()) if step >= 0 else float("nan"),
                       f"step {step + 1}")
    grad = ref["grad"].double()
    keep = grad >= NOUGHT * grad.median()
    kept = [n for n, k in zip(names, keep.tolist()) if k]
    for key, mask in (("update", None), ("change", keep), ("residual", None)):
        if prog.get(key) is None or ref.get(key) is None:
            continue
        gap = leaf_gaps(prog[key], ref[key], mask)
        leaves = names if mask is None else kept
        if torch.isnan(gap).any():
            out[f"{key}_gap"] = (float("nan"), "nan")
            out[f"{key}_median_gap"] = (float("nan"), "nan")
            continue
        r, leaf = divmod(int(gap.argmax()), gap.shape[1])
        out[f"{key}_gap"] = (float(gap[r, leaf]),
                             f"rank {r} leaf {leaves[leaf]}")
        med = gap.median(dim=1).values
        out[f"{key}_median_gap"] = (float(med.max()),
                                    f"rank {int(med.argmax())}")
    return out


def judge(found: Dict[str, Tuple[float, str]], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, List[Tuple[str, float, Optional[float], str]]]:
    """``correct`` and the lines that show it: every number with a limit
    must be at or under it (NaN is not); a number whose limit is null is
    shown and not compared."""
    missing = sorted(set(limits) - set(found))
    ok = not missing
    rows = []
    for name, (value, where) in found.items():
        limit = limits.get(name)
        if limit is not None and not value <= limit:
            ok = False
        rows.append((name, value, limit, where))
    for name in missing:
        rows.append((name, float("nan"), limits[name], "not read"))
    return ok, rows
