"""The comparison that decides `correct`: each number compared against
its limit from the cell's `workloads/<cell>.json`, and the numbers
themselves.

Generator outputs (float32 RGB) are compared by the worst image's
relative L2 distance from the reference and the largest absolute
difference; served replies (uint8 PNG) by the worst reply's share of
values that differ from the reference's and the largest difference in
levels. A missing, misshapen or non-finite answer reads as the worst
value, 1e30, so it fails any limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

WORST = 1e30


def image_numbers(pairs) -> Dict[str, float]:
    """pairs: (program output, reference output) float arrays [H, W, 3]
    of one image each."""
    rel, mx = 0.0, 0.0
    for y, r in pairs:
        y, r = np.asarray(y, np.float64), np.asarray(r, np.float64)
        if y.shape != r.shape or not np.isfinite(y).all():
            return {"rel_l2": WORST, "max_abs": WORST}
        d = y - r
        rel = max(rel, float(np.linalg.norm(d) / max(np.linalg.norm(r),
                                                     1e-30)))
        mx = max(mx, float(np.abs(d).max()))
    return {"rel_l2": rel, "max_abs": mx}


def reply_numbers(pairs) -> Dict[str, float]:
    """pairs: (reply uint8 [h, w, 3] or None, reference uint8 [h, w, 3])."""
    share, mx = 0.0, 0.0
    for y, r in pairs:
        if y is None or y.shape != r.shape:
            return {"px_diff_share": WORST, "max_px_diff": WORST}
        d = np.abs(y.astype(np.int16) - r.astype(np.int16))
        share = max(share, float(np.count_nonzero(d)) / d.size)
        mx = max(mx, float(d.max()))
    return {"px_diff_share": share, "max_px_diff": mx}


def verdict(numbers: Dict[str, float], limits: dict
            ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(all within their limits, [(name, value, limit)]). Every number
    the cell's file limits must be present."""
    rows, ok = [], True
    for name, spec in limits["numbers"].items():
        v = numbers.get(name, WORST)
        if v is None or not math.isfinite(v):
            v = WORST
        rows.append((name, v, spec["limit"]))
        ok &= v <= spec["limit"]
    return ok, rows
