"""Flash attention's sm90 forward (``flash_fwd_sm90_kernel``) against its
roofline: each launch's least time, from the yardstick's causal FLOPs and
once-moved bytes at the cell's shapes, over its measured device time."""
from bench import devicetrace, yardstick as Y


def read(ctx):
    prof = ctx.get("prof")
    if prof is None:
        return None
    secs, n = devicetrace.kernels_named(prof, "flash_fwd_sm90_kernel")
    if n == 0 or secs <= 0:
        return None
    c, tr = ctx["cell"]["cfg"], ctx["cell"]["work"]["traffic"]
    B, S, H, K, D = (tr["batch"], tr["seq"], c["n_heads"], c["n_kv_heads"],
                     c["d_head"])
    bound = Y.bound_s(Y.flash_fwd_flops(B, S, H, D),
                      Y.flash_fwd_bytes(B, S, H, K, D))
    return 100.0 * n * bound / secs
