"""The numbers that decide ``correct``, from the program's readings and the
reference's.

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the followed
  steps.
* ``grad_gap`` and ``change_gap``: by the worst leaf, the gap between the
  program's norm and the reference's (not the norm of their difference),
  over the reference's norm of that leaf. Both leave out the leaves whose
  reference gradient is under a thousandth of the median leaf's: their
  gradient is nought to rounding, and AdamW moves them by round-off alone.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

SILENT = 1e-3      # a leaf's gradient under this share of the median's


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def worst_leaf(got: Sequence[float], want: Sequence[float],
               keep: Sequence[bool]) -> Tuple[float, int]:
    """(the largest ``|got - want| / want`` over the kept leaves, its
    leaf's index)."""
    return max((abs(g - w) / w, i)
               for i, (g, w, k) in enumerate(zip(got, want, keep)) if k)


def moving(ref_grad: Sequence[float]) -> List[bool]:
    med = statistics.median(ref_grad)
    return [g >= SILENT * med for g in ref_grad]


def worst(got: Dict[str, List[float]], want: Dict[str, List[float]]
          ) -> Dict[str, Tuple[float, int]]:
    """``grad_gap`` and ``change_gap`` with the index of the worst leaf."""
    keep = moving(want["grad_norm"])
    return {k: worst_leaf(got[n], want[n], keep)
            for k, n in (("grad_gap", "grad_norm"),
                         ("change_gap", "change_norm"))}


def gaps(got: Dict[str, List[float]], want: Dict[str, List[float]]
         ) -> Dict[str, float]:
    return {"loss_gap": loss_gap(got["loss"], want["loss"]),
            **{k: v for k, (v, _) in worst(got, want).items()}}
