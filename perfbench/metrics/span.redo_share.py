"""Share of the window's span segments that the span path redid on the
regular path (a span rebuild refused, so the segment's spans were thrown
away and its steps run again): the runner's redo count
(``runner.redos``, a device count read once the window has closed) over
the span segments the window's chunks ran.  Nothing to read where the
cell's path runs no span segment."""


def read(ctx):
    if not ctx.span_segments or ctx.redos is None:
        return None
    return ctx.redos / ctx.span_segments
