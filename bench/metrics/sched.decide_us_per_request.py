"""Self us of the simulator's ``sched.decide`` spans (the policy's callbacks
and dispatch passes, outside the backend's spans inside them) over the run,
per request of the window.  None where the program keeps no spans."""


def read(run):
    ns = run.stats.get("sched.decide:self_ns")
    if ns is None or not run.requests:
        return None
    return ns / len(run.requests) * 1e-3
