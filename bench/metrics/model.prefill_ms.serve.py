"""Median device time of a prefill: CUDA events on stream 1 around each
``ServeRuntime.prefill_request`` of the window."""
import statistics


def read(ctx):
    w = ctx["window"].get("prefill_s")
    if not w:
        return None
    return statistics.median(w) * 1e3
