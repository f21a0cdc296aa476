"""Host ms per decode iteration blocked on the card: the `wait` spans inside
the backend's ``backend.decode_iteration`` span (the readback, the copies
from pageable host memory, the backend's synchronise), over
`decode_iters`.  None where the program keeps no spans."""


def read(run):
    n = run.stats.get("decode_iters", 0)
    wait = run.stats.get("backend.decode_iteration:wait_ns")
    if not n or wait is None:
        return None
    return wait / n * 1e-6
