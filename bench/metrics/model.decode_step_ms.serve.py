"""Mean time a decode step takes: the gaps between the stream-0 events
after consecutive ``ServeRuntime.decode`` calls with no admission
between them."""
import statistics


def read(ctx):
    w = ctx["window"].get("decode_step_s")
    if not w:
        return None
    return statistics.mean(w) * 1e3
