"""Flash attention's backward (device time under the program's range
``flash_attention.backward``) against the roofline of the work any
backward does: 2.5 times the forward's causal FLOPs; q, k, v, o and do
read and dq, dk and dv written once."""
from bench import devicetrace, yardstick as Y


def read(ctx):
    prof = ctx.get("prof_ops")
    if prof is None:
        return None
    secs, n = devicetrace.under_range(prof, "flash_attention.backward")
    if n == 0 or secs <= 0:
        return None
    c, tr = ctx["cell"]["cfg"], ctx["cell"]["work"]["traffic"]
    B, S, H, K, D = (tr["batch"], tr["seq"], c["n_heads"], c["n_kv_heads"],
                     c["d_head"])
    bound = Y.bound_s(Y.flash_bwd_flops(B, S, H, D),
                      Y.flash_bwd_bytes(B, S, H, K, D))
    return 100.0 * n * bound / secs
