"""A hook through which a caller may serve the plain versions' repeated
calls from an account instead of running them: the plain attention's
q-block columns and the plain SSD scan call through `call`, and inside
`replay_with(hook)` (in this thread or task only) `call` hands the call
to ``hook(name, fn, args, kwargs)``, which returns its result.  The dry
run (`launch/dryrun.py`) replays a column or scan it has already run on
the "meta" device; outside a hook `call` is ``fn(*args, **kwargs)``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

_hook: contextvars.ContextVar[Optional[Callable]] = \
    contextvars.ContextVar("kernel_replay", default=None)


@contextlib.contextmanager
def replay_with(hook: Callable):
    tok = _hook.set(hook)
    try:
        yield hook
    finally:
        _hook.reset(tok)


def call(name: str, fn: Callable, *args, **kwargs):
    hook = _hook.get()
    if hook is None:
        return fn(*args, **kwargs)
    return hook(name, fn, args, kwargs)
