"""The whole step's share of the chip's bf16 peak: the yardstick's model
FLOPs a step (6·N·T over the matmul parameters plus causal attention)
over the window's time a step (host clock, all steps of the window)."""
from bench import yardstick as Y


def read(ctx):
    w = ctx["window"]
    if not w.get("steps"):
        return None
    return 100.0 * ctx["step_flops"] / (w["step_s"] * Y.PEAK_BF16_FLOPS)
