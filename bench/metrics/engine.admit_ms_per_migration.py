"""Ms of ``engine.admit`` (the §5.2 KV migration into the decode engine's
pool, which the cluster clock does not charge) per KV migration
(`kv_migrations`).  None where the program keeps no spans."""


def read(run):
    n = run.stats.get("kv_migrations", 0)
    ns = run.stats.get("engine.admit:ns")
    if not n or ns is None:
        return None
    return ns / n * 1e-6
