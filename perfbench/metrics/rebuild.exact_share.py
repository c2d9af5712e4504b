"""Share of the window's slot rebuilds that took the exact (argsort)
rebuild, from the program's rebuild counters (``engine_table.REBUILDS``):
exact over incremental plus exact.  Nothing to read where the cell's path
has no table rebuild."""


def read(ctx):
    if ctx.rebuilds is None or sum(ctx.rebuilds) == 0:
        return None
    incremental, exact = ctx.rebuilds
    return exact / (incremental + exact)
