"""Share of the prefill layers run by whole-stack graph replays
(`prefill_graph_layers`) among every prefill layer run (`prefill_layers`),
in %: how much of the prefill work left the host's per-layer issue.  None
where the program keeps no such counter."""


def read(run):
    n = run.stats.get("prefill_layers", 0)
    g = run.stats.get("prefill_graph_layers")
    if not n or g is None:
        return None
    return 100.0 * g / n
