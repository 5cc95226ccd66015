"""fill_wait_ms (.bf16, .f32): ms per batch that `predict_stream`'s main
loop waits on the host's fill itself: the program's span stage/wait_fill
(the part of e2e/wait_decode that overlaps the awaited batch's fill call,
both stamped on one host clock), its total over the window per batch. The
rest of stage_wait_ms is the decode stage waiting for its ring slot's last
forward, the H2D enqueue and the hand-off."""

from benchmark.lib import readers


def read(r):
    if getattr(r, "forwards", 0) <= 0:
        return None
    waited = readers.span_delta(r, "stage/wait_fill", "total_s")
    if waited is None:
        return None
    return 1e3 * waited / r.forwards  # one forward per batch
