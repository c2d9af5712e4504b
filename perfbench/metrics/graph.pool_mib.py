"""Card memory the warm-up's graph captures hold: ``memory_reserved``
after the warm-up less before it, the allocator's cache emptied before
each reading, so that what is left is live tensors and the graphs'
private pools."""


def read(ctx):
    return ctx.pool_mib
