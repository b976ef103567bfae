"""The device memory the window's steps held at most
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB."""


def read(ctx):
    peak = ctx["window"].get("peak_bytes", 0)
    if not peak:
        return None
    return peak / 2 ** 30
