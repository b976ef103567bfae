"""Median host time from a request's due arrival to the engine's
``prefill_request`` call for it."""
import statistics


def read(ctx):
    w = ctx["window"].get("queue_wait_s")
    if not w:
        return None
    return statistics.median(w) * 1e3
