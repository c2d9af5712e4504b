"""Kernel 3's share of its roofline, in percent: the least time the spans
of the traced stretch need on one H100 (``roofline.span_bound`` of the
cell's tables: the larger of their bytes over 3.35 TB/s and their
operations over 67 TFLOP/s, per K-step span), over the traced device time
of kernel 3, single and batched.  The spans cover (seg - K) of each
gate segment's seg steps (the segment's first block runs the regular
step), so the stretch holds that share of its steps over K spans.
Nothing to read where kernel 3 did not run in the trace."""

from perfbench import roofline

SYMBOLS = ("mega_span_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    kernel_s = ctx.trace.time_of(SYMBOLS)
    if kernel_s <= 0:
        return None
    seg, k = roofline.segment_steps(ctx.p), ctx.k
    spans = ctx.trace_steps * (seg - k) / seg / k
    least_s, _ = roofline.span_bound(ctx.p, ctx.scenes_pos, k)
    return 100.0 * least_s * spans / kernel_s
