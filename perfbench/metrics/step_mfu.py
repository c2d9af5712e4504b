"""The whole step's share of one H100's float32 peak, in percent: the
operations the pair forces of the scenes need (``roofline.PAIR_OPS`` per
ordered pair of occupied rows in each other's 3x3 cells, counted from the
scenes' positions) over the host wall per step of the untraced stretch,
against 67 TFLOP/s.  It bounds what kernel 1's roofline can claim: a
kernel taken off the path leaves its roofline silent, and this stays."""

from perfbench import roofline


def read(ctx):
    if ctx.trace is None or not ctx.untraced_wall:
        return None
    ops = roofline.PAIR_OPS * sum(roofline.scene_pairs(ctx.p, pos) for pos in ctx.scenes_pos)
    return 100.0 * ops * ctx.trace_steps / (ctx.untraced_wall * roofline.PEAK_F32_FLOPS)
