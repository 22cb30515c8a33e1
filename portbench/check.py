"""The numbers that decide ``correct``, each against its limit.

Of the first two groups of micro-steps (the first one micro-step a call,
the second one call, as the timed window calls the step), taken the same
way from the program and from the reference (``reference.Steps``):

- ``loss_gap``: the largest |loss - reference| / |reference| of a step
  read: each of the first group's, and the second group's last;
- ``grad_gap``: the first step's gradient, by the worst leaf: the gap
  between the two norms of a leaf over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
- ``grad_diff``: the same gradient row by row: the norm of the two
  gradients' difference over the same denominator, by the worst leaf. The
  norms above average the rounding of a lower precision away; this does
  not;
- ``change_gap``: the same of the params' change over both groups,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone);
- ``rows_outside``: rows of the embedding tables that the program changed
  and the reference did not (lazy and dense adam alike leave a row no
  step touched where it is): exact, limit 0.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

NOUGHT_SHARE = 1e-3
NAMES = ("loss_gap", "grad_gap", "grad_diff", "change_gap", "rows_outside")


def _worst(gaps: List[float]) -> float:
    """The largest gap; infinite where any is not a number (``max``
    would pass a NaN over)."""
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> float:
    med = statistics.median(ref[n] for n in leaves)
    return _worst([abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                   for n in leaves])


def _diff_norm(prog, ref) -> float:
    """||prog - ref|| of one leaf's (ids, values), rows absent from one
    side counting as zero there."""
    (pid, pv), (rid, rv) = prog, ref
    if (pid is None) != (rid is None):
        return math.nan       # the program has no such rows to compare
    pv = pv.to(rv.device)
    if rid is None:
        return float((pv - rv).norm())
    pid = pid.to(rid.device)
    at = torch.searchsorted(rid, pid).clamp(max=max(rid.numel() - 1, 0))
    inside = rid[at] == pid
    full = torch.zeros_like(rv)
    full[at[inside]] = pv[inside]
    extra = float(pv[~inside].square().sum())
    return math.sqrt(float((full - rv).square().sum()) + extra)


def readings(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref``: ``reference.Steps`` of the same steps."""
    loss = _worst([abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog.losses, ref.losses)])
    if len(prog.losses) != len(ref.losses):
        loss = math.inf
    leaves = sorted(ref.grad_norms)
    med = statistics.median(ref.grad_norms.values())
    moved = [n for n in leaves if ref.grad_norms[n] >= NOUGHT_SHARE * med]
    outside = 0
    for n, ids in ref.changed.items():
        got = prog.changed[n].to(ids.device)
        outside += int(torch.isin(got, ids, invert=True).sum())
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog.grad_norms, ref.grad_norms, leaves),
            "grad_diff": _worst([
                _diff_norm(prog.first_grads[n], ref.first_grads[n])
                / max(ref.grad_norms[n], med, 1e-30) for n in leaves]),
            "change_gap": _leaf_gap(prog.change_norms, ref.change_norms,
                                    moved),
            "rows_outside": float(outside)}


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
