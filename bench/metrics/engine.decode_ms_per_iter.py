"""Measured ms per decode iteration (the backend's `decode_s` /
`decode_iters`), over the window and its drain."""


def read(run):
    n = run.stats.get("decode_iters", 0)
    return run.decode_s / n * 1e3 if n else None
