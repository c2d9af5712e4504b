"""Kernel 1's share of its roofline, in percent: the least time the pair
forces of the cell's tables need on one H100 (``roofline.stencil_bound``:
the larger of their bytes over 3.35 TB/s and their operations over 67
TFLOP/s), per step, over the traced device time per step of the kernels
that compute the pair forces (kernel 1, single and batched, and kernel 4
where a sharded table runs it).  Nothing to read where no such kernel ran
in the trace."""

from perfbench import roofline

SYMBOLS = ("stencil_forces_kernel", "stencil_forces_ext_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    kernel_s = ctx.trace.time_of(SYMBOLS)
    if kernel_s <= 0:
        return None
    least_s, _ = roofline.stencil_bound(ctx.p, ctx.scenes_pos)
    return 100.0 * least_s * ctx.trace_steps / kernel_s
