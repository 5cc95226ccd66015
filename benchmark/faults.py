"""Faults planted under the timed path, to show that `correct` sees them.

`planted(fault, arch)` wraps the classifier that the architecture's
`program` hands the drivers, for the block:

  * "half_batch": the classifier's device call computes the first half of
    its rows and answers the rest with copies of them;
  * "altered": the classifier's device call answers its first row with
    that row's probabilities rotated by one class;
  * "swapped_channels": the decode stage of `predict_paths` hands each
    batch on with its colour channels in the wrong order (RGB for BGR).

FAULTS names the faults each driver's cells can have (one chip: no
exchange between chips to leave out; no training state to leave
unchanged).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"infer_closed": ("half_batch", "altered"),
          "infer_paths": ("half_batch", "altered", "swapped_channels")}


def _swap_channels(clf) -> None:
    path_fill = clf.path_fill

    def swapped(fpaths, pool):
        fill = path_fill(fpaths, pool)

        def fill_swapped(start, stop, out):
            kept = fill(start, stop, out)
            out[: len(kept)] = out[: len(kept), :, :, ::-1].copy()
            return kept

        return fill_swapped

    clf.path_fill = swapped


def _break_device_call(clf, fault: str) -> None:
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


@contextlib.contextmanager
def planted(fault: str, arch):
    if fault not in {f for fs in FAULTS.values() for f in fs}:
        raise ValueError(f"unknown fault {fault!r}")
    program = arch.program
    make_classifier = program.classifier

    def classifier(*args, **kwargs):
        clf = make_classifier(*args, **kwargs)
        if fault == "swapped_channels":
            _swap_channels(clf)
        else:
            _break_device_call(clf, fault)
        return clf

    program.classifier = classifier
    try:
        yield
    finally:
        program.classifier = make_classifier
