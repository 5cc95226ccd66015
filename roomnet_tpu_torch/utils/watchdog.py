"""Step watchdog: failure detection for stalled device steps (port of
roomnet_tpu/utils/watchdog.py; the reference has nothing, and recovers from
a crash only by resuming the latest checkpoint).

A training/serving step that stops completing (a hung kernel, a deadlocked
feeder, a lost device) otherwise hangs silently forever. The watchdog is a
daemon thread that fires callbacks when no heartbeat arrives within
`timeout_s` — by default it logs loudly; callers can escalate (checkpoint +
abort) via `on_stall`.

Usage:
    wd = StepWatchdog(timeout_s=120, on_stall=lambda info: ...)
    with wd:
        for step in ...:
            ...run step...
            wd.beat(step)
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class StepWatchdog:
    def __init__(
        self,
        timeout_s: float = 300.0,
        on_stall: Callable[[dict], None] | None = None,
        check_interval_s: float | None = None,
    ):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self.check_interval_s = check_interval_s or min(timeout_s / 4, 10.0)
        self._last_beat = time.monotonic()
        self._last_step = None
        self._stalls = 0
        self._paused = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- heartbeat -----------------------------------------------------------
    def beat(self, step=None):
        self._last_beat = time.monotonic()
        self._last_step = step

    # -- pause window ---------------------------------------------------------
    # For known-long operations that cannot beat (the first step of a phase,
    # which builds the CUDA kernels on a fresh checkout; a full validation
    # epoch): silence inside a pause window is expected, not a stall.
    def pause(self):
        self._paused = True

    def resume(self):
        self.beat(self._last_step)
        self._paused = False

    @property
    def stall_count(self) -> int:
        return self._stalls

    # -- lifecycle ------------------------------------------------------------
    def _run(self):
        from .logging import get_logger

        log = get_logger("watchdog")
        fired_for_beat = None
        while not self._stop.wait(self.check_interval_s):
            if self._paused:
                continue
            silent = time.monotonic() - self._last_beat
            if silent > self.timeout_s and fired_for_beat != self._last_beat:
                self._stalls += 1
                fired_for_beat = self._last_beat
                info = {"silent_s": silent, "last_step": self._last_step, "stalls": self._stalls}
                log.error("no step heartbeat for %.0fs (last step %s) — device stalled?",
                          silent, self._last_step)
                if self.on_stall:
                    try:
                        self.on_stall(info)
                    except Exception:
                        log.exception("on_stall callback failed")

    def start(self):
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
