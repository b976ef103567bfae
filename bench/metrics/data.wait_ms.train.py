"""Host time a step spends blocked in ``next()`` of the port's
``PrefetchIterator`` (a span of the benchmark around the call), mean
over the window's steps."""


def read(ctx):
    w = ctx["window"]
    if not w.get("steps"):
        return None
    return w["data_wait_s"] * 1e3
