"""The optimizer's update a step: device time under the program's range
``optimizer.update`` over the traced steps."""
from bench import devicetrace


def read(ctx):
    prof = ctx.get("prof_ops")
    if prof is None:
        return None
    secs, n = devicetrace.under_range(prof, "optimizer.update")
    if n == 0 or secs <= 0:
        return None
    return secs / n * 1e3
