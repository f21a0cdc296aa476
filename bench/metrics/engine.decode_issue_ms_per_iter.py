"""Host ms per decode iteration outside its `wait` spans (rebuilding the
dense view, issuing the step, appending to the pool): the backend's
``backend.decode_iteration`` span less the waits inside it, over
`decode_iters`.  None where the program keeps no spans."""


def read(run):
    n = run.stats.get("decode_iters", 0)
    ns = run.stats.get("backend.decode_iteration:ns")
    if not n or ns is None:
        return None
    wait = run.stats.get("backend.decode_iteration:wait_ns", 0)
    return (ns - wait) / n * 1e-6
