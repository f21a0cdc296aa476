"""Ms of the dense decode view's rebuilds (``engine.decode_iteration.view``,
its waits included) per decode iteration (`decode_iters`).  None where the
program keeps no spans."""


def read(run):
    n = run.stats.get("decode_iters", 0)
    if not n or "engine.decode_iteration:n" not in run.stats:
        return None
    return run.stats.get("engine.decode_iteration.view:ns", 0) / n * 1e-6
