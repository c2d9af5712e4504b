"""Device microseconds per step (per batched step in a sweep): the union
of the traced stretch's device activity over its steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.activities:
        return None
    return ctx.trace.busy_s() * 1e6 / ctx.trace_steps
