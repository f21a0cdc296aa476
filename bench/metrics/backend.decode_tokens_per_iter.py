"""Decode tokens per decode iteration over every engine (the backend's
`decode_tokens` / `decode_iters`): how many lanes a step carries."""


def read(run):
    n = run.stats.get("decode_iters", 0)
    return run.stats.get("decode_tokens", 0) / n if n else None
