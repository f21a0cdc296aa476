"""90th percentile of the window's shorts' queueing delay (prefill_start -
arrival), in ms on the cluster clock."""
import stats


def read(run):
    v = stats.percentile(stats.short_qd_s(run.requests), 90)
    return None if v is None else v * 1e3
