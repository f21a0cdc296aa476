"""The pecsched policy's suspensions of long prefills (its summary's
`preemptions`) per long completed, over the window and its drain."""


def read(run):
    n = run.summary.get("long_completed") or 0
    return run.summary["preemptions"] / n if n else None
