"""Host ms issuing prefill quanta, outside their `wait` spans, per layer run
(`prefill_layers`), over every quantum of the run: the backend's
``backend.prefill_quantum`` span less the waits inside it.  None where the
program keeps no spans."""


def read(run):
    n = run.stats.get("prefill_layers", 0)
    ns = run.stats.get("backend.prefill_quantum:ns")
    if not n or ns is None:
        return None
    wait = run.stats.get("backend.prefill_quantum:wait_ns", 0)
    return (ns - wait) / n * 1e-6
