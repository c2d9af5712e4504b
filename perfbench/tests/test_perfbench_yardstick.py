"""The frozen yardstick: roofline counts against hand counts, the plain
reference against two-bot cases worked by hand, the layouts against the
port's placement."""

import numpy as np
import pytest
import torch

from perfbench import layouts, reference, roofline

P = dict(reference.DEFAULTS, n_cells=2, n_dead=0)


def test_occupied_pairs_on_a_3x3_table():
    # G = 3 wraps every cell's 3x3 neighbourhood onto the whole table: the
    # three bots (one in cell (0, 0), two in (1, 1)) each see the other two
    counts = torch.tensor([1, 0, 0, 0, 2, 0, 0, 0, 0])
    assert roofline.occupied_pairs(counts, 3) == 6
    # a bot alone sees nobody; four in one cell see each other: 4 * 3
    assert roofline.occupied_pairs(torch.tensor([0, 0, 0, 0, 4, 0, 0, 0, 0]), 3) == 12
    assert roofline.occupied_pairs(torch.tensor([0, 0, 0, 0, 1, 0, 0, 0, 0]), 3) == 0


def test_occupied_pairs_wrap_on_a_larger_table():
    # G = 4: cells (0, 0) and (3, 3) touch across the corner wrap, (0, 0)
    # and (2, 2) do not
    counts = torch.zeros(16, dtype=torch.int64)
    counts[0], counts[15], counts[10] = 1, 1, 1
    # (0,0)-(3,3) adjacent; (3,3)-(2,2) adjacent; (0,0)-(2,2) two apart
    assert roofline.occupied_pairs(counts, 4) == 4


def test_bound_takes_the_larger_time():
    t, by = roofline.bound(3.35e12, 0.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound(0.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_stencil_bound_of_a_3x3_table():
    p = dict(reference.DEFAULTS, n_cells=3, grid_dim=3, cell_capacity=2)
    h = reference.cutoff(p)
    # three bots in the cells the table's anchor puts them in
    pos = torch.tensor([[0.0, 0.0], [h * 1.0, h * 1.0], [h * 1.1, h * 1.1]])
    t, by = roofline.stencil_bound(p, [pos])
    rows = 3 * 3 * 2
    assert by == "bytes"
    assert t == pytest.approx((5 + 4) * rows * 4 / roofline.PEAK_BYTES_S)
    assert roofline.scene_pairs(p, pos) == 6


def _pair(dx, step=100, phase=3.5):
    s = {
        "pos": torch.tensor([[0.0, 0.0], [dx, 0.0]]),
        "vel": torch.zeros(2, 2),
        "rad": torch.full((2,), P["min_radius"]),
        "phase": torch.full((2,), phase),
        "abs_force_a": torch.zeros(2), "abs_force_r": torch.zeros(2),
    }
    # step 100 fires no gate; t + phase = 4.5 s lies past the two rise
    # periods of the 12 s wave, so the radius holds
    out, ring = reference.run(P, s, step, 1, draws=None)
    return out, ring


def test_two_overlapping_bots_push_apart():
    # 0.01 of overlap: spring 1000 * 0.01 = 10 along the line of centres,
    # over the static threshold 2 * 0.4 * 9.81 * 0.566; the velocity is
    # F dt less kinetic friction mu g dt
    out, ring = _pair(0.145)
    kin = 0.4 * 9.81 * 0.566 * 0.01
    assert ring == {}
    assert torch.equal(out["pos"], torch.tensor([[0.0, 0.0], [0.145, 0.0]]))
    assert out["vel"][0, 0].item() == pytest.approx(-(0.1 - kin), rel=1e-5)
    assert out["vel"][1, 0].item() == pytest.approx(0.1 - kin, rel=1e-5)
    assert out["vel"][:, 1].abs().max().item() == 0.0
    assert out["abs_force_r"].tolist() == pytest.approx([10.0, 10.0], rel=1e-4)
    assert out["abs_force_a"].tolist() == [0.0, 0.0]
    assert torch.equal(out["rad"], torch.full((2,), P["min_radius"]))


def test_two_close_bots_hold_on_the_magnet_plateau():
    # a gap of 0.0005 lies under the first breakpoint: the magnet pulls with
    # its plateau 2.5, under the static threshold, so both stay at rest
    out, _ = _pair(0.1555)
    assert out["abs_force_a"].tolist() == pytest.approx([2.5, 2.5])
    assert out["abs_force_r"].tolist() == [0.0, 0.0]
    assert out["vel"].abs().max().item() == 0.0


def test_table_rows_rank_bots_by_index_within_a_cell():
    p = dict(reference.DEFAULTS, n_cells=3, grid_dim=16, cell_capacity=2)
    h = np.float32(reference.cutoff(p))
    pos = torch.tensor([[0.0, 0.0], [0.01, 0.0], [0.02, 0.0]])
    rows = reference.table_rows(p, pos)
    cell = 2 * 16 + 2  # two margin cells from the bounding box
    assert rows.tolist() == [cell, 256 + cell, 16 * 16 * 2 + 2]
    assert float(h) > 0.02


@pytest.mark.parametrize("n", [1, 7, 300])
def test_hex_layout_is_the_ports(n):
    from particlerobotsimulations_torch.config import Config, SimParams
    from particlerobotsimulations_torch.models.placement import place

    ours = layouts.hex_layout(n, 0.0775)
    theirs, _ = place(SimParams(n_cells=n, n_dead=0, config=Config.HEX))
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_random_layout_is_the_ports(seed):
    from particlerobotsimulations_torch.config import Config, SimParams
    from particlerobotsimulations_torch.models.placement import place

    ours = layouts.random_accretion(60, 0.0775, 0.235, seed)
    theirs, _ = place(SimParams(n_cells=60, n_dead=0, config=Config.RANDOM, seed=seed))
    assert np.array_equal(ours, theirs)


def _jittered(n=40, seed=1):
    """A HEX swarm of ``n`` bots nudged off its exact contacts, moving and
    mid-wave, so that contacts, magnets, friction and the radius law all
    act."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.from_numpy(layouts.hex_layout(n, 0.0775)) + 1e-3 * torch.randn(n, 2, generator=g)
    return {"pos": pos, "vel": 0.05 * torch.randn(n, 2, generator=g),
            "rad": 0.0775 + 0.04 * torch.rand(n, generator=g),
            "phase": 3.0 * torch.rand(n, generator=g),
            "abs_force_a": torch.rand(n, generator=g), "abs_force_r": torch.rand(n, generator=g)}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in reference.FIELDS)


def test_the_mid_step_halves_make_the_whole_step_bit_for_bit():
    p = dict(reference.DEFAULTS, n_cells=40, n_dead=0)
    s = _jittered()
    # no gate fires at steps 101-106
    assert not any(any(reference.gates(p, t)) for t in range(101, 107))
    assert _equal(reference.step(p, s, 101, None),
                  reference.post(p, reference.pre(p, s, 101, None)))
    # a mid-step piece (kernel 3's span: post, whole steps, pre) set
    # between a pre and a post is the whole steps
    whole, _ = reference.run(p, s, 101, 6, None)
    mid, _ = reference.run(p, reference.pre(p, s, 101, None), 102, 4, None, mid=True)
    assert _equal(whole, reference.post(p, reference.pre(p, reference.post(p, mid), 106, None)))


def test_span_work_is_chip_smokes_span_bound(monkeypatch):
    import chip_smoke
    from particlerobotsimulations_torch.config import Config, ForceBackend, SimParams
    from particlerobotsimulations_torch.sim import Simulation

    n = 300
    sim = Simulation(SimParams(n_cells=n, n_dead=0, config=Config.HEX,
                               force_backend=ForceBackend.PALLAS), device="cpu")
    prog, tbl, strip, _ = chip_smoke.span_inputs(sim)
    monkeypatch.setattr(chip_smoke, "bound", lambda n_bytes, n_ops: (n_bytes, n_ops))
    p = dict(reference.DEFAULTS, n_cells=n, n_dead=0)
    k = prog.resolved_slot_rebuild_steps()
    assert reference.grid_dim(p) == prog.resolved_grid_dim() == 16 and k == 4
    assert roofline.span_work(p, sim.state.pos[:n], k) == chip_smoke.span_bound(prog, tbl, strip)
    t, by = roofline.span_bound(p, [sim.state.pos[:n]] * 2, k)
    n_bytes, n_ops = roofline.span_work(p, sim.state.pos[:n], k)
    assert (t, by) == roofline.bound(2 * n_bytes, 2 * n_ops)


def test_segment_steps_are_the_gates_gcd():
    assert roofline.segment_steps(dict(reference.DEFAULTS)) == 200


def test_kernel3_roofline_counts_the_spans_of_the_stretch():
    from types import SimpleNamespace

    from perfbench.spec import Bench

    read = Bench().reader("kernel3_roofline")
    p = dict(reference.DEFAULTS, n_cells=300, n_dead=0)
    pos = torch.from_numpy(layouts.hex_layout(300, 0.0775))
    trace = SimpleNamespace(time_of=lambda symbols: 0.01 if "mega_span_kernel" in symbols else 0)
    ctx = SimpleNamespace(trace=trace, p=p, k=4, trace_steps=1200, scenes_pos=[pos])
    # 1,200 steps are six 200-step segments, each with 49 spans of K=4
    least, _ = roofline.span_bound(p, [pos], 4)
    assert read(ctx) == pytest.approx(100.0 * least * 6 * 49 / 0.01)
    assert read(SimpleNamespace(**{**vars(ctx), "trace": None})) is None
    idle = SimpleNamespace(time_of=lambda symbols: 0.0)
    assert read(SimpleNamespace(**{**vars(ctx), "trace": idle})) is None
