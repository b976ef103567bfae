"""The share (%) of a serve cell's traced span in which the device idled
while the host was inside the program's ``serve.decode`` spans:
``device.idle_share.serve`` times the part of the device's idle time (the
gaps between its busy intervals, ``devicetrace.busy_intervals``) that the
spans cover, placed on the trace's timeline by ``repro_torch.trace``.
``read(ctx, span)`` gives the same share for another span's name.
Nothing where the program records no such spans."""
import numpy as np

from bench import devicetrace

SPAN = "serve.decode"


def _idle_before(gaps, t):
    """Idle time (µs) of the sorted, disjoint ``gaps`` before each time
    of ``t``."""
    ga, gb = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(gb - ga)])
    k = np.searchsorted(ga, t, side="right")
    j = np.maximum(k - 1, 0)
    part = np.clip(t - ga[j], 0.0, gb[j] - ga[j])
    return np.where(k > 0, cum[j] + part, 0.0)


def read(ctx, span=SPAN):
    prof, share = ctx.get("prof"), devicetrace.idle_share(ctx)
    if prof is None or share is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    busy = devicetrace.busy_intervals(prof)
    gaps = np.array([(a[1], b[0]) for a, b in zip(busy, busy[1:])
                     if b[0] > a[1]], np.float64).reshape(-1, 2)
    spans = np.array([(a, b) for _, a, b in trace.placed(prof, span)
                      if busy and a < busy[-1][1] and b > busy[0][0]],
                     np.float64).reshape(-1, 2)
    if not len(spans) or not len(gaps):
        return None
    inside = _idle_before(gaps, spans[:, 1]) - _idle_before(gaps, spans[:, 0])
    return share * float(inside.sum()) / float((gaps[:, 1] - gaps[:, 0]).sum())
