"""Kernel launches per step (per batched step in a sweep) that ran on the
card in the traced stretch: the lever of launch fusion."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.activities:
        return None
    return len(ctx.trace.kernels()) / ctx.trace_steps
