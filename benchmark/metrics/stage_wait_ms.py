"""stage_wait_ms (.bf16, .f32): ms per batch that `predict_stream`'s main
loop waits for its staging (the decode stage's fill into the pinned ring,
then the compute stream's wait for the H2D copy): the program's spans
e2e/wait_decode and e2e/wait_put, their totals over the window per batch."""

from benchmark.lib import readers


def read(r):
    if getattr(r, "forwards", 0) <= 0:
        return None
    waits = [readers.span_delta(r, n, "total_s") for n in ("e2e/wait_decode", "e2e/wait_put")]
    if all(w is None for w in waits):
        return None
    return 1e3 * sum(w or 0.0 for w in waits) / r.forwards  # one forward per batch
