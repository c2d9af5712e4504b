"""The card's idle share over a stretch of steps: one less the union of
the device activity intervals of the traced stretch, over the host wall
of the same steps run untraced just before (the profiler's own cost on
the host is left out of the wall)."""


def read(ctx):
    if ctx.trace is None or not ctx.untraced_wall:
        return None
    return 1.0 - ctx.trace.busy_s() / ctx.untraced_wall
