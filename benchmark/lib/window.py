"""The measured window of a closed loop of one caller, which every driver
runs the same way."""

from __future__ import annotations

import time
import types

import torch

from . import program
from .trace import Capture


def closed_loop(ctx, call) -> types.SimpleNamespace:
    """Call `call()` again and again from `ctx.window()` on, until
    `ctx.seconds` have passed (the last call ends past them), under the
    profiler when `ctx.trace`. Returns `answers` (each call's result),
    `window_s`, `spans` (the program's span registry before and after),
    `trace` and `peak`, the device's memory peak over the window."""
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    spans0 = program.spans()
    answers = []
    with Capture(ctx.trace) as cap:
        start = ctx.window()
        while True:
            answers.append(call())
            if time.monotonic() - start >= ctx.seconds:
                break
        end = time.monotonic()
    spans1 = program.spans()
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    return types.SimpleNamespace(answers=answers, window_s=end - start, spans=(spans0, spans1),
                                 trace=cap.trace, peak=peak)
