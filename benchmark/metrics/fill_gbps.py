"""fill_gbps (.bf16, .f32), GB/s: the bytes `predict_stream`'s fill wrote
into the pinned ring over the window (the program's counter
stage/fill_bytes, kept rows x S*S*3) over the time the fill took (its span
e2e/decode, on the thread that runs it)."""

from benchmark.lib import readers


def read(r):
    filled = readers.span_delta(r, "stage/fill_bytes", "total")
    spent = readers.span_delta(r, "e2e/decode", "total_s")
    if not filled or not spent:  # nothing filled, or a program without the counter
        return None
    return filled / spent / 1e9
