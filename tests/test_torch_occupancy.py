"""PyTorch port, the table loop's occupancy counters, on the CPU.

``engine_table.OCCUPANCY`` keeps, on the device, the most real bots that
one scene held after a slot rebuild in spill rows (``spill_max``: ranks
``cell_capacity`` to ``storage_capacity - 1``, which kernel 1 does not
see) and in the parking strip (``parked_max``).  Held here: the counters
against a count made on the host from the validity plane of each table
a chunk enters and each carry a rebuild chooses, read at every rebuild,
on a crowded HEX blob with spill rows
(``cell_capacity`` 8 + ``overflow_slots`` 8) and without them
(``overflow_slots`` 0: the excess is parked); single and batched, where
the counters take the worst scene; no tensor converted to a Python value
inside a chunk; reset by assignment; and ``utils.trace.snapshot``'s
``occupancy`` counters.  Sizes: 300 bots, 40 steps.
"""

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch.chunk import drain
from particlerobotsimulations_torch.models.placement import place
from particlerobotsimulations_torch.state import make_state, stack_states
from particlerobotsimulations_torch.utils import trace

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

STEPS = 40
# what a chunk must not call on a tensor: each converts it to a Python value
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
              "numpy")
# (overflow_slots, the counter the crowded blob must raise)
CASES = {"spill": (8, "spill_max"), "park": (0, "parked_max")}


def params(case):
    return pt.SimParams(n_cells=300, n_dead=0, seed=4, config=pt.Config.HEX,
                        force_backend=pt.ForceBackend.PALLAS, cell_capacity=8,
                        overflow_slots=CASES[case][0], slot_rebuild_steps=4,
                        light_x=-5.0).validate()


def scene(p, spread=1.0, seed=0):
    """A HEX blob of ``p``'s bots at step 0, its lattice stretched by
    ``spread`` about its centre (above 1: sparser cells)."""
    pos = np.asarray(place(p, seed=seed)[0], np.float32)
    pos = (pos - pos.mean(0)) * np.float32(spread) + pos.mean(0)
    return make_state(p, pos, seed=seed, device="cpu")


def direct(p, val) -> np.ndarray:
    """(scenes, 2): each scene's real bots in spill rows and parked, counted
    on the host off the rank-major ``(storage, G*G)`` table and the strip
    behind it."""
    gg = p.resolved_grid_dim() ** 2
    cap, cs = p.cell_capacity, p.storage_capacity()
    v = val.reshape(-1, val.shape[-1]).numpy() > 0.5
    table = v[:, : cs * gg].reshape(len(v), cs, gg)
    counts = np.stack([table[:, cap:].sum((1, 2)), v[:, cs * gg:].sum(1)], axis=1)
    # every real bot sits in a visible row, a spill row or the strip
    assert (table[:, :cap].sum((1, 2)) + counts.sum(1) == p.n_cells).all()
    return counts


def zero():
    for k in t_et.OCCUPANCY:
        t_et.OCCUPANCY[k] = 0


def run(p, state, batched, monkeypatch):
    """Run a chunk with the table it enters and every rebuild's chosen
    carry counted on the host; returns, in turn, ``(counts, read)``: each
    table's (scenes, 2) counts and, at a rebuild, the counters read at it
    (None at the entry)."""
    seen = []
    rebuild, enter = t_et._choose_rebuild, t_et.enter_table

    def rebuild_spy(params, ts):
        out, ok = rebuild(params, ts)
        seen.append((direct(params, out.fields["val"]), dict(t_et.OCCUPANCY)))
        return out, ok

    def enter_spy(params, state):
        ts = enter(params, state)
        seen.append((direct(params, ts.fields["val"]), None))
        return ts

    monkeypatch.setattr(t_et, "_choose_rebuild", rebuild_spy)
    monkeypatch.setattr(t_et, "enter_table", enter_spy)
    make = t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table
    zero()
    make(p)(state, STEPS, False)
    return seen


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_equal_a_direct_count_at_every_rebuild(case, batched, monkeypatch):
    p = params(case)
    state = scene(p)
    if batched:
        # a sparse scene beside the dense one: the counters take the worst
        state = stack_states([scene(p, spread=1.25, seed=1), scene(p, seed=2)])
    seen = run(p, state, batched, monkeypatch)
    assert [read is None for _, read in seen] == [True] + [False] * (STEPS // 4)
    worst = np.zeros(2, np.int64)
    for counts, read in seen:
        worst = np.maximum(worst, counts.max(0))
        assert read in (None, {"spill_max": worst[0], "parked_max": worst[1]})
    key = CASES[case][1]
    assert t_et.OCCUPANCY[key] > 0
    if case == "spill":
        # 16 slots hold the densest cell: nothing parked
        assert t_et.OCCUPANCY["parked_max"] == 0
    else:
        # no spill rows to count
        assert t_et.OCCUPANCY["spill_max"] == 0
    if batched:
        per_scene = np.stack([c for c, _ in seen]).max(0)
        i = t_et.OccupancyCounts.KEYS.index(key)
        # the sparse scene drops fewer than the dense one, which sets the maximum
        assert per_scene[0, i] < per_scene[1, i] == t_et.OCCUPANCY[key]


@pytest.mark.parametrize("batched", [False, True])
def test_no_host_read_inside_a_chunk(batched, monkeypatch):
    """The counters update inside the chunk with nothing converted to a
    Python value; they are read after it."""
    p = params("spill")
    state = stack_states([scene(p, seed=1), scene(p, seed=2)]) if batched else scene(p)
    runner = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    zero()
    gen = runner.blocks(state, STEPS, False)

    def refuse(name):
        def read(self, *args, **kw):
            raise AssertionError(f"a chunk called Tensor.{name}")
        return read

    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse(name))
        out = drain(gen)
    assert out.step == STEPS and t_et.OCCUPANCY["spill_max"] > 0


def test_reset_and_snapshot():
    p = params("park")
    zero()
    t_et.make_run_chunk_table(p)(scene(p), 8, False)
    counts = trace.snapshot()["counters"]["occupancy"]
    assert set(counts) == {"spill_max", "parked_max"}
    assert counts["parked_max"] > 0 and counts["spill_max"] == 0
    assert counts == dict(t_et.OCCUPANCY)
    t_et.OCCUPANCY["parked_max"] = 0
    assert dict(t_et.OCCUPANCY) == {"spill_max": 0, "parked_max": 0}
    assert trace.snapshot()["counters"]["occupancy"] == {"spill_max": 0, "parked_max": 0}
    # a set value is a floor the device maxima are taken with
    t_et.OCCUPANCY["spill_max"] = 10**6
    assert t_et.OCCUPANCY["spill_max"] == 10**6
    zero()
    with pytest.raises(KeyError):
        t_et.OCCUPANCY["other"]
