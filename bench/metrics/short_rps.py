"""Shorts completed inside the window per cluster second of the window."""
import stats


def read(run):
    if not run.window_end:
        return None
    return stats.shorts_done_by(run.requests, run.window_end) / run.window_end
