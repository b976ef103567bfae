"""The rate the offload's loads crossed the link: the program's
``h2d_bytes`` counters of the ``offload.update`` spans of the device-only
traced steps, summed, over the device time of that trace's ``Memcpy
HtoD`` operations (GB/s, 1e9 bytes).  Nothing where the program records no
such spans."""
from bench import devicetrace

SPAN = "offload.update"


def read(ctx):
    prof = ctx.get("prof")
    if prof is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    busy = devicetrace.busy_intervals(prof)
    if not busy:
        return None
    moved = sum(s.attrs.get("h2d_bytes", 0)
                for s, a, _ in trace.placed(prof, SPAN)
                if 0.0 <= a <= busy[-1][1])
    secs, _ = devicetrace.kernels_named(prof, "Memcpy HtoD")
    if moved <= 0 or secs <= 0:
        return None
    return moved / secs / 1e9
