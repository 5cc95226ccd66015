"""Faults planted under the timed path, to show that `correct` sees them.

`planted(fault)` wraps what `benchmark.lib.program` hands the drivers, for
the block:

  * "half_batch": the classifier's device call computes the first half of
    its rows and answers the rest with copies of them;
  * "altered": the classifier's device call answers its first row with
    that row's probabilities rotated by one class.

FAULTS names the faults each driver's cells can have (one chip: no
exchange between chips to leave out; no training state to leave
unchanged).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.lib import program

FAULTS = {"infer_closed": ("half_batch", "altered")}


@contextlib.contextmanager
def planted(fault: str):
    if fault not in {f for fs in FAULTS.values() for f in fs}:
        raise ValueError(f"unknown fault {fault!r}")
    make_classifier = program.classifier

    def classifier(*args, **kwargs):
        clf = make_classifier(*args, **kwargs)
        inner = clf._predict

        def predict(variables, x):
            if fault == "half_batch":
                keep = (x.shape[0] + 1) // 2
                ids, probs = inner(variables, x[:keep])
                rows = torch.arange(x.shape[0], device=probs.device) % keep
                return ids[rows], probs[rows]
            ids, probs = inner(variables, x)
            probs = probs.clone()
            probs[0] = probs[0].roll(1)
            return ids, probs

        clf._predict = predict
        return clf

    program.classifier = classifier
    try:
        yield
    finally:
        program.classifier = make_classifier
