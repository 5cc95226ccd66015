"""The number that decides `correct`: a gap between what the program
produced and what the reference computes from the same inputs.

  * `prob_gap`: the widest gap |p - p_ref| over every answer and class
    (answers checked one by one: a single altered answer shows).
"""

from __future__ import annotations

import numpy as np


def prob_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    d = np.abs(np.asarray(got, np.float64) - want)
    return float(d.max()) if np.isfinite(d).all() else float("inf")
