"""The numbers that decide `correct` for a training cell.

Both sides give (reference.train's form) each step's loss, each
parameter's gradient norm as the optimizer takes it in the first step,
and each parameter's change after the checked steps. Compared:

- `loss_gap`: the largest relative gap of a step's loss;
- `grad_gap`: by the worst parameter, the gap between the program's and
  the reference's gradient norm over the larger of the reference's norm
  of that parameter and of the median parameter;
- `change_gap`: the same for the change of the parameters, leaving out
  those whose reference gradient is under a thousandth of the median
  parameter's (they move under Adam by round-off alone).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

TINY_GRAD = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               names: Optional[List[str]] = None) -> Tuple[float, str]:
    names = sorted(ref) if names is None else names
    if set(prog) != set(ref):
        missing = sorted(set(ref) ^ set(prog))[:4]
        return math.inf, f"parameters differ: {missing}"
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap) or gap > worst:
            worst, at = (math.inf if not math.isfinite(gap) else gap), n
            if not math.isfinite(gap):
                break
    return worst, at


def moving(ref_grads: Dict[str, float]) -> List[str]:
    """Parameters whose reference gradient is at least a thousandth of
    the median parameter's."""
    med = statistics.median(ref_grads.values())
    return sorted(n for n, g in ref_grads.items() if g >= TINY_GRAD * med)


def compare(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """{number: {"value", "at"}} of one run against the reference."""
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                       for a, b in zip(prog["losses"], ref["losses"]))
    g, g_at = worst_leaf(prog["grad_norms"], ref["grad_norms"])
    c, c_at = worst_leaf(prog["change_norms"], ref["change_norms"],
                         moving(ref["grad_norms"]))
    return {"loss_gap": {"value": loss_gap, "at": "step losses"},
            "grad_gap": {"value": g, "at": g_at},
            "change_gap": {"value": c, "at": c_at}}


def judge(numbers: Dict[str, Dict], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit; a number without a limit is refused."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers[name]["value"]
        out[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, out
