"""The most real bots that one scene held in the parking strip after a
slot rebuild (bots no cell had room for: they feel and exert no pair
force), from the program's device counters (``occupancy`` in
``utils.trace.snapshot()``, ``engine_table.OCCUPANCY``).  The harness
zeroes only the rebuild counts, so this is the maximum over the whole
run: set-up, window, traced stretch and the check's chunk.  Nothing to
read where the program keeps no such counter."""


def read(ctx):
    from particlerobotsimulations_torch.utils import trace

    counts = trace.snapshot()["counters"].get("occupancy")
    return None if counts is None else int(counts["parked_max"])
