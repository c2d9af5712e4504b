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
