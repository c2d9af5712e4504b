"""PyTorch port, the CUDA kernels on the card against their plain twins.

These tests need a CUDA card and ``nvcc`` (the kernels are built on first
use); elsewhere they skip.  They import no JAX, so on a machine without it
run them with the repository's conftest switched off:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine_table, kernels
from particlerobotsimulations_torch.engine_table import (
    OCCUPANCY,
    REBUILDS,
    _make_mega_glue,
    enter_table,
    exit_table,
    gate_seg,
    make_adaptive_run_chunk,
    make_run_chunk_table,
    make_run_chunk_table_batched,
    make_table_step,
    make_table_step_parts,
)
from particlerobotsimulations_torch.models.placement import resolve_params
from particlerobotsimulations_torch.ops.megakernel import make_mega_span, mega_span_plain
from particlerobotsimulations_torch.ops.pallas_stencil import (
    pair_constants,
    stencil_forces_plain,
)
from particlerobotsimulations_torch.ops.table_rebuild import (
    compact_padded_plain,
    compact_plain,
)
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.parallel.spatial_table import (
    HALO_ROWS,
    make_sharded_table_run,
)
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.state import (
    MOVE_FIELDS,
    N_TF,
    TABLE_FIELDS,
    state_from_arrays,
    state_to_arrays,
    step_tensor,
    table_geometry,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


def random_tables(p, seed, fill=0.5):
    """(C, G*G) tables with bots jittered around their cell centres."""
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    gg = g * g
    rng = np.random.default_rng(seed)
    h = p.cutoff()
    lane = np.arange(gg)
    occ = rng.random((cap, gg)) < fill
    px = ((lane % g) + rng.random((cap, gg))) * h
    py = ((lane // g) + rng.random((cap, gg))) * h
    t = {
        "px": np.where(occ, px, 0.0), "py": np.where(occ, py, 0.0),
        "vx": np.where(occ, rng.normal(0, 0.3, (cap, gg)), 0.0),
        "vy": np.where(occ, rng.normal(0, 0.3, (cap, gg)), 0.0),
        "rad": np.where(occ, rng.uniform(0.0775, 0.1175, (cap, gg)), 0.0),
        "afac": np.where(occ, rng.choice([1.0, 2.0], (cap, gg)), 0.0),
    }
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in t.items()}


@pytest.mark.parametrize("payload", [False, True])
def test_stencil_kernel_matches_twin(card, payload):
    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=16).validate()
    tables = {k: v.to(card) for k, v in random_tables(p, 3, fill=0.1).items()}
    n0 = kernels.LAUNCHES["stencil_forces"]
    got = kernels.stencil_forces_cuda(p, tables)
    assert kernels.LAUNCHES["stencil_forces"] == n0 + 1
    want = stencil_forces_plain(p, tables)
    summed = want[2] + want[3]
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 + 1e-5 * b.abs() + (1e-5 * summed if i < 2 else 0)
        assert bool(((a - b).abs() <= tol).all())


def test_compact_kernel_equals_twin(card):
    p = pt.SimParams(n_dead=0, grid_dim=16).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    gen = torch.Generator(device=card).manual_seed(4)
    data = torch.randn((9, cs, g * g), generator=gen, device=card)
    occ = torch.rand((cs, g * g), generator=gen, device=card) < 0.7
    mv = torch.randint(-1, 2, (2, cs, g * g), generator=gen, device=card).float()
    far = torch.full_like(mv[0], 99.0)
    planes = torch.cat(
        [data, torch.where(occ, mv[0], far)[None], torch.where(occ, mv[1], far)[None]]
    ).contiguous()
    out_k, inc_k = kernels.compact_cuda(p, planes)
    out_p, inc_p = compact_plain(p, planes)
    assert torch.equal(inc_k, inc_p)
    assert bool((out_k == out_p).all())
    assert bool((inc_k > cs).any())  # 70% fill overflows some cells


def test_wrappers_check_shape_and_dtype(card):
    p = pt.SimParams(n_dead=0, grid_dim=16).validate()
    with pytest.raises(ValueError, match="shape"):
        kernels.compact_cuda(p, torch.zeros((11, 16, 100), device=card))
    with pytest.raises(ValueError, match="float32"):
        kernels.compact_cuda(p, torch.zeros((11, 16, 256), device=card,
                                            dtype=torch.float64))


def test_table_loop_on_card_matches_cpu(card):
    p = pt.SimParams(
        n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0, light_x=-5.0,
        slot_rebuild_steps=4,
    )
    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    run = make_run_chunk_table(p)
    a = state_to_arrays(run(state_from_arrays(p, arrays, card), 12))
    b = state_to_arrays(run(state_from_arrays(p, arrays, "cpu"), 12))
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-5)
    np.testing.assert_allclose(a["vel"], b["vel"], atol=1e-4)


def check_span_against_twin(p, card):
    """One span of kernel 3 against its twin from the mid-step state after
    200 steps of ``p`` on the span path, with chip_smoke.py's tolerances:
    1e-5 for px, py, rad; kernel 1's form for aa, ar and vx, vy, plus the
    force that the span's position differences cost through the magnet
    ramp (6 pairs x slope x 2 dpos, times dt for the velocities); the other
    fields equal."""
    sim = pt.Simulation(p, device=card)
    assert sim._run_chunk.path_info["use_mega"]
    sim.step_chunk(200, start_step=0)
    ts = enter_table(p, sim.state)
    ts = make_table_step_parts(p)[0](ts, *t_chunk.gates(p, ts.step))
    tbl, strip = _make_mega_glue(p)[0](ts.fields)
    first = step_tensor(ts.step + 1, card)
    n0 = kernels.LAUNCHES["mega_span"]
    got = make_mega_span(p, table_geometry(p)[2])(tbl, strip, first)
    assert kernels.LAUNCHES["mega_span"] == n0 + 1
    want = mega_span_plain(p, tbl, strip, first)
    assert_span_close(p, got, want)


def assert_span_close(p, got, want):
    """Kernel 3's (tbl, strip) against its twin's, with the tolerances of
    :func:`check_span_against_twin`."""
    ix = {f: j for j, f in enumerate(TABLE_FIELDS)}
    dpos = max(
        float((a[ix[f]] - b[ix[f]]).abs().max())
        for a, b in zip(got, want) for f in ("px", "py")
    )
    (_, _, _, _, attr, _, _, mina, inv_i2_sq, inv_span) = pair_constants(p)
    if p.has_payload:
        attr *= max(1.0, p.attraction_factor) ** 2
    slack = 6 * abs(attr * inv_i2_sq - mina) * inv_span * 2 * dpos
    for a, b in zip(got, want):
        summed = b[ix["aa"]] + b[ix["ar"]]
        for field, j in ix.items():
            d = (a[j] - b[j]).abs()
            if field in ("aa", "ar"):
                tol = 1e-4 + 1e-5 * b[j].abs() + slack
            elif field in ("vx", "vy"):
                tol = 1e-4 + 1e-5 * b[j].abs() + 1e-5 * summed + slack * p.timestep
            elif field in ("px", "py", "rad"):
                tol = torch.full_like(d, 1e-5)
            else:
                tol = torch.zeros_like(d)
            assert bool((d <= tol).all()), (field, float(d.max()), dpos)


def test_mega_span_kernel_matches_twin(card):
    """Kernel 3 against its twin on one span of a 1000-bot HEX swarm after
    200 steps (G=16, C=16: a cluster of 16 CTAs)."""
    p = pt.SimParams(
        n_cells=1000, n_dead=0, seed=3, config=pt.Config.HEX, light_x=-5.0,
    ).validate()
    assert kernels.mega_plan(16, 16, 1024, False)["cluster"] == 16
    check_span_against_twin(p, card)


@pytest.mark.parametrize("shape", ["g16_c8_payload", "g32_c4_obstacles"])
def test_mega_span_kernel_other_shapes(card, shape):
    """Kernel 3 against its twin at eligible shapes other than the band's:
    8 slots with a payload at G=16, and 4 slots at G=32 (2 grid rows per
    CTA) with circle and rectangle obstacles."""
    if shape == "g16_c8_payload":
        p = pt.SimParams(
            n_cells=300, n_dead=-1, seed=5, config=pt.Config.HEX, light_x=-5.0,
            grid_dim=16, cell_capacity=8, attraction_factor=2.0,
            force_backend=pt.ForceBackend.PALLAS,
        ).validate()
    else:
        p = pt.SimParams(
            n_cells=300, n_dead=0, seed=5, config=pt.Config.HEX, light_x=-5.0,
            grid_dim=32, cell_capacity=4, force_backend=pt.ForceBackend.PALLAS,
            circle_obstacles=((1.0, 0.5, 0.5), (-1.5, 1.0, 0.3)),
            rect_obstacles=((-0.5, 0.5, -2.5, -1.5),),
        ).validate()
    g, cap = p.resolved_grid_dim(), p.storage_capacity()
    plan = kernels.mega_plan(cap, g, table_geometry(p)[2], p.has_payload)
    assert plan["cluster"] == 16 and plan["grid_rows"] == g // 16
    check_span_against_twin(p, card)


def test_wrappers_refuse_shapes_the_plans_refuse(card):
    """No fallback: a table whose slots need more shared memory than a
    block has (145 slots), and a table too large for kernel 3's cluster,
    raise before any launch."""
    p = pt.SimParams(n_dead=0, grid_dim=16, cell_capacity=145).validate()
    tables = {k: torch.zeros((145, 256), device=card) for k in ("px", "py", "vx", "vy", "rad")}
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="SMEM_PER_BLOCK"):
        kernels.stencil_forces_cuda(p, tables)
    p = pt.SimParams(n_cells=300, n_dead=0, grid_dim=32, cell_capacity=8).validate()
    n_pad = table_geometry(p)[2]
    tbl = torch.zeros((N_TF, 8, 32 * 32), device=card)
    strip = torch.zeros((N_TF, n_pad // 128, 128), device=card)
    with pytest.raises(ValueError, match="4096"):
        kernels.mega_span_cuda(p, tbl, strip, 1)
    assert kernels.LAUNCHES == n0


@pytest.mark.parametrize("payload", [False, True])
def test_stencil_kernel_equals_ext_kernel_bitwise(card, payload):
    """Kernel 1 on a whole G=32 table and kernel 4 on the same table cut
    into 4 halo-extended shards add the same terms in the same (oy, ox,
    slot) order: the centre lanes are equal bit for bit."""
    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=32).validate()
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    ext, _, h, l0 = ext_tables(p, 7)
    ext = ext.to(card)
    names = ("px", "py", "vx", "vy", "rad", "val", "afac")
    tables_ext = {k: ext[:, j] for j, k in enumerate(names)}
    whole = {k: v.to(card) for k, v in random_tables(p, 7, 0.3).items()}
    got1 = kernels.stencil_forces_cuda(p, whole)
    got4 = kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0)
    assert float(got1[2].max()) > 0 and float(got1[3].max()) > 0
    for a, b in zip(got1, got4):
        assert torch.equal(a, b.permute(1, 0, 2).reshape(cap, g * g))


def test_forced_redo_on_card_equals_regular_run(card):
    """A 60 u/s kick makes the spans' rebuilds refuse: the segment is redone
    on the regular path, and the result is the regular run's, bit for bit
    (the card's kernels are deterministic)."""
    p = pt.SimParams(
        n_cells=128, n_dead=0, seed=3, config=pt.Config.HEX,
        force_backend=pt.ForceBackend.PALLAS, light_x=-5.0, phase_std=0.5,
        centroid_int=0.08, phase_update_interval=0.16,
    )
    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    arrays["vel"][7, 0] += 60.0
    run = make_run_chunk_table(p)
    n0 = kernels.LAUNCHES["mega_span"]
    a = run(state_from_arrays(p, arrays, card), 8, True)
    b = run(state_from_arrays(p, arrays, card), 8, False)
    assert kernels.LAUNCHES["mega_span"] > n0 and run.redos >= 1
    sa, sb = state_to_arrays(a), state_to_arrays(b)
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


def test_mega_span_wrapper_refuses_cpu_tensors():
    p = pt.SimParams(n_cells=300, n_dead=0, grid_dim=16).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    n_pad = table_geometry(p)[2]
    tbl = torch.zeros((N_TF, cs, g * g))
    strip = torch.zeros((N_TF, n_pad // 128, 128))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mega_span_cuda(p, tbl, strip, 1)


def ext_tables(p, seed, shards=4, fill=0.3):
    """Halo-extended (S, C, E) tables: random_tables over the whole G x G
    grid, cut into shards with the neighbours' boundary rows and zero rows
    as the halo, stacked as the sharded loop stacks them."""
    g = p.resolved_grid_dim()
    l0, h = g * g // shards, HALO_ROWS * g
    base = random_tables(p, seed, fill)
    base["val"] = (base["rad"] > 0).float()
    planes = torch.stack([base[k] for k in ("px", "py", "vx", "vy", "rad", "val", "afac")])
    blocks = planes.view(7, -1, shards, l0).permute(2, 0, 1, 3)      # (S, 7, C, L0)
    z = torch.zeros(blocks.shape[:-1] + (h - g,))
    ext = torch.cat(
        [z, torch.roll(blocks, 1, 0)[..., -g:], blocks, torch.roll(blocks, -1, 0)[..., :g], z],
        dim=-1,
    ).contiguous()
    names = ("px", "py", "vx", "vy", "rad", "val", "afac")
    return ext, {k: ext[:, j] for j, k in enumerate(names)}, h, l0


@pytest.mark.parametrize("payload", [False, True])
def test_stencil_ext_kernel_matches_twin(card, payload):
    from particlerobotsimulations_torch.ops.pallas_stencil import stencil_forces_ext_plain

    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=32).validate()
    ext, _, h, l0 = ext_tables(p, 5)
    ext = ext.to(card)
    tables = {k: ext[:, j] for j, k in enumerate(("px", "py", "vx", "vy", "rad", "val", "afac"))}
    n0 = kernels.LAUNCHES["stencil_forces_ext"]
    got = kernels.stencil_forces_ext_cuda(p, tables, h, l0)
    assert kernels.LAUNCHES["stencil_forces_ext"] == n0 + 1
    want = stencil_forces_ext_plain(p, tables, h, l0)
    summed = want[2] + want[3]
    assert float(want[2].max()) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 + 1e-5 * b.abs() + (1e-5 * summed if i < 2 else 0)
        assert bool(((a - b).abs() <= tol).all())


def test_compact_padded_kernel_equals_twin(card):
    p = pt.SimParams(n_dead=0, grid_dim=32).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    gen = torch.Generator(device=card).manual_seed(6)
    s, l0, h = 4, g * g // 4, HALO_ROWS * g
    data = torch.randn((s, 9, cs, l0 + 2 * h), generator=gen, device=card)
    occ = torch.rand((s, cs, l0 + 2 * h), generator=gen, device=card) < 0.7
    mv = torch.randint(-1, 2, (2, s, cs, l0 + 2 * h), generator=gen, device=card).float()
    far = torch.full_like(mv[0], 99.0)
    planes = torch.cat(
        [data, torch.where(occ, mv[0], far)[:, None], torch.where(occ, mv[1], far)[:, None]],
        dim=1,
    ).contiguous()
    n0 = kernels.LAUNCHES["compact_padded"]
    out_k, inc_k = kernels.compact_padded_cuda(p, planes, h, l0)
    assert kernels.LAUNCHES["compact_padded"] == n0 + 1
    out_p, inc_p = compact_padded_plain(p, planes, h, l0)
    assert torch.equal(inc_k, inc_p)
    assert bool((out_k == out_p).all())
    assert bool((inc_k > cs).any())  # 70% fill overflows some cells
    # the wrap form is unchanged: kernel 2 on one whole (G*G-lane) table,
    # two shards' stacks side by side
    whole = torch.cat([planes[0], planes[1]], dim=-1).contiguous()
    assert whole.shape[-1] == g * g
    out_w, inc_w = kernels.compact_cuda(p, whole)
    ref_w = compact_plain(p, whole)
    assert torch.equal(inc_w, ref_w[1]) and bool((out_w == ref_w[0]).all())


def test_sharded_loop_on_card_matches_cpu(card):
    """LocalRing(4) on the card (kernels 4 and 2 padded) against the same
    run on the CPU twins: 300 jittered bots, 12 steps, 3 rebuilds."""
    p = pt.SimParams(
        n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0, light_x=-5.0,
        slot_rebuild_steps=4,
    )
    run_c, p2 = make_sharded_table_run(p, LocalRing(4, card))
    run_h, _ = make_sharded_table_run(p, LocalRing(4, "cpu"))
    arrays = state_to_arrays(pt.Simulation(p2, device="cpu").state)
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    n0 = dict(kernels.LAUNCHES)
    a = state_to_arrays(run_c(state_from_arrays(p2, arrays, card), 12))
    assert kernels.LAUNCHES["stencil_forces_ext"] - n0["stencil_forces_ext"] == 12
    assert kernels.LAUNCHES["compact_padded"] - n0["compact_padded"] == 3
    b = state_to_arrays(run_h(state_from_arrays(p2, arrays, "cpu"), 12))
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-5)
    np.testing.assert_allclose(a["vel"], b["vel"], atol=1e-4)


def test_sharded_wrappers_refuse_cpu_tensors():
    p = pt.SimParams(n_dead=0, grid_dim=32).validate()
    _, tables, h, l0 = ext_tables(p, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stencil_forces_ext_cuda(p, tables, h, l0)
    cs = p.storage_capacity()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_padded_cuda(p, torch.zeros((4, 11, cs, l0 + 2 * h)), h, l0)
    with pytest.raises(ValueError, match="pad"):
        kernels.compact_padded_cuda(p, torch.zeros((4, 11, cs, l0 + 64)), 32, l0)
    with pytest.raises(ValueError, match="S, "):
        kernels.compact_padded_cuda(p, torch.zeros((11, cs, l0 + 2 * h)), h, l0)
    with pytest.raises(ValueError, match="S, C, E"):
        kernels.stencil_forces_ext_cuda(p, {k: v[0] for k, v in tables.items()}, h, l0)


@pytest.mark.parametrize("g,shards,payload", [
    (32, 1, False),   # one shard: the whole table with its own wrap as halo
    (32, 4, True),    # four shards of 8 rows, a payload
    (48, 16, False),  # 3 centre rows per shard: a partial tile in each
    (16, 16, True),   # one centre row per shard, a payload
])
def test_stencil_ext_kernel_shapes(card, g, shards, payload):
    """Kernel 4 against its twin, and bitwise against kernel 1 on the same
    whole table, at other shard counts and with an odd number of centre
    rows (kernel 1's tolerance form against the twin)."""
    from particlerobotsimulations_torch.ops.pallas_stencil import stencil_forces_ext_plain

    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=g).validate()
    cap = p.cell_capacity
    ext, _, h, l0 = ext_tables(p, 8, shards)
    ext = ext.to(card)
    tables = {k: ext[:, j] for j, k in enumerate(("px", "py", "vx", "vy", "rad", "val", "afac"))}
    got = kernels.stencil_forces_ext_cuda(p, tables, h, l0)
    want = stencil_forces_ext_plain(p, tables, h, l0)
    summed = want[2] + want[3]
    assert float(want[2].max()) > 0 and float(want[3].max()) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 + 1e-5 * b.abs() + (1e-5 * summed if i < 2 else 0)
        assert bool(((a - b).abs() <= tol).all())
    whole = {k: v.to(card) for k, v in random_tables(p, 8, 0.3).items()}
    for a, b in zip(kernels.stencil_forces_cuda(p, whole), got):
        assert torch.equal(a, b.permute(1, 0, 2).reshape(cap, g * g))


def test_stencil_ext_wrapper_refuses_cap_33(card):
    """Kernel 4 takes kernel 1's plans: 33 slots (refused while a cell's
    occupancy was one 32-bit word) launch and give zeros on an empty
    table; 145 slots, more than a block's shared memory holds, raise
    before any launch."""
    h, l0 = HALO_ROWS * 32, 256
    names = ("px", "py", "vx", "vy", "rad", "val", "afac")
    for cap, launches in ((33, 1), (145, 0)):
        p = pt.SimParams(n_dead=0, grid_dim=32, cell_capacity=cap).validate()
        ext = torch.zeros((4, 7, cap, 2 * h + l0), device=card)
        tables = {k: ext[:, j] for j, k in enumerate(names)}
        n0 = kernels.LAUNCHES["stencil_forces_ext"]
        if launches:
            out = kernels.stencil_forces_ext_cuda(p, tables, h, l0)
            assert all(bool((o == 0).all()) for o in out)
        else:
            with pytest.raises(ValueError, match="SMEM_PER_BLOCK"):
                kernels.stencil_forces_ext_cuda(p, tables, h, l0)
        assert kernels.LAUNCHES["stencil_forces_ext"] == n0 + launches


@pytest.mark.parametrize("g,cap,spill", [(16, 16, 0), (48, 16, 0), (16, 32, 8), (48, 32, 8)])
def test_compact_kernels_equal_twins_other_shapes(card, g, cap, spill):
    """Both forms of kernel 2 elementwise equal to their twins on the
    band's G=16, the 10k path's G=48, and Cs = 32 + 8 spill slots = 40 (two
    32-slot windows), on a stack with random moves at 70 % fill in which
    every row of the 3x3 lanes around one lane moves into it (overflow)."""
    p = pt.SimParams(n_dead=0, grid_dim=g, cell_capacity=cap, overflow_slots=spill).validate()
    cs, gg = p.storage_capacity(), g * g
    assert cs == cap + spill
    gen = torch.Generator(device=card).manual_seed(g + cs)
    data = torch.randn((9, cs, gg), generator=gen, device=card)
    occ = torch.rand((cs, gg), generator=gen, device=card) < 0.7
    mv = torch.randint(-1, 2, (2, cs, gg), generator=gen, device=card).float()
    target = (g // 4 + 1) * g + g // 2   # a lane of shard 1's first grid row
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            occ[:, target + oy * g + ox] = True
            mv[:, :, target + oy * g + ox] = torch.tensor([-ox, -oy], device=card)[:, None].float()
    far = torch.full_like(mv[0], 99.0)
    stack = torch.cat(
        [data, torch.where(occ, mv[0], far)[None], torch.where(occ, mv[1], far)[None]]
    ).contiguous()
    out_k, inc_k = kernels.compact_cuda(p, stack)
    out_p, inc_p = compact_plain(p, stack)
    assert torch.equal(inc_k, inc_p) and bool((out_k == out_p).all())
    assert float(inc_k[target]) == 9 * cs > cs
    # the padded form on the same stack cut into 4 shards with their halos
    h, l0 = HALO_ROWS * g, gg // 4
    blocks = stack.view(11, cs, 4, l0).permute(2, 0, 1, 3)
    z = torch.zeros(blocks.shape[:-1] + (h - g,), device=card)
    padded = torch.cat(
        [z, torch.roll(blocks, 1, 0)[..., -g:], blocks, torch.roll(blocks, -1, 0)[..., :g], z],
        dim=-1,
    ).contiguous()
    out_k, inc_k = kernels.compact_padded_cuda(p, padded, h, l0)
    out_p, inc_p = compact_padded_plain(p, padded, h, l0)
    assert torch.equal(inc_k, inc_p) and bool((out_k == out_p).all())
    assert bool((inc_k > cs).any())


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("cap", [48, 64])
def test_stencil_kernels_past_32_slots(card, cap, payload):
    """Two occupancy words per cell: kernels 1 and 4 against their twins
    at C = 48 and 64 (about half the slots of every cell occupied, so both
    words hold bots), and kernel 4's centre lanes equal to kernel 1 bit for
    bit on the same table."""
    from particlerobotsimulations_torch.ops.pallas_stencil import stencil_forces_ext_plain

    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=16, cell_capacity=cap).validate()
    g = p.resolved_grid_dim()
    whole = {k: v.to(card) for k, v in random_tables(p, 9, 0.5).items()}
    assert bool((whole["rad"][32:] > 0).any())
    n0 = dict(kernels.LAUNCHES)
    got1 = kernels.stencil_forces_cuda(p, whole)
    want = stencil_forces_plain(p, whole)
    summed = want[2] + want[3]
    for i, (a, b) in enumerate(zip(got1, want)):
        tol = 1e-4 + 1e-5 * b.abs() + (1e-5 * summed if i < 2 else 0)
        assert bool(((a - b).abs() <= tol).all()), i
    ext, _, h, l0 = ext_tables(p, 9, fill=0.5)
    ext = ext.to(card)
    names = ("px", "py", "vx", "vy", "rad", "val", "afac")
    tables_ext = {k: ext[:, j] for j, k in enumerate(names)}
    got4 = kernels.stencil_forces_ext_cuda(p, tables_ext, h, l0)
    want4 = stencil_forces_ext_plain(p, tables_ext, h, l0)
    summed4 = want4[2] + want4[3]
    for i, (a, b) in enumerate(zip(got4, want4)):
        tol = 1e-4 + 1e-5 * b.abs() + (1e-5 * summed4 if i < 2 else 0)
        assert bool(((a - b).abs() <= tol).all()), i
    for a, b in zip(got1, got4):
        assert torch.equal(a, b.permute(1, 0, 2).reshape(cap, g * g))
    assert kernels.LAUNCHES["stencil_forces"] == n0["stencil_forces"] + 1
    assert kernels.LAUNCHES["stencil_forces_ext"] == n0["stencil_forces_ext"] + 1


def test_per_bot_pallas_step_on_card_matches_cpu(card):
    """make_step on PALLAS (the per-bot collide: kernel 1 on the card, its
    twin on the CPU) from the same jittered 300-bot state, 12 steps, phase
    noise off: one kernel-1 launch per step, positions and velocities as
    the table loop's card-vs-CPU check holds them."""
    from particlerobotsimulations_torch.engine import make_step

    p = pt.SimParams(
        n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0, light_x=-5.0,
    )
    arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    a, b = state_from_arrays(p, arrays, card), state_from_arrays(p, arrays, "cpu")
    step_c, step_h = make_step(p, card), make_step(p, "cpu")
    n0 = kernels.LAUNCHES["stencil_forces"]
    for _ in range(12):
        a, b = step_c(a), step_h(b)
    assert kernels.LAUNCHES["stencil_forces"] == n0 + 12
    sa, sb = state_to_arrays(a), state_to_arrays(b)
    np.testing.assert_allclose(sa["pos"], sb["pos"], atol=1e-5)
    np.testing.assert_allclose(sa["vel"], sb["vel"], atol=1e-4)


# ---------------------------------------------------- the batched forms


def bitwise(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("payload", [False, True])
def test_batched_stencil_kernel_equals_single_launches(card, payload):
    """Kernel 1 on B = 3 scenes in one launch, from planes a scene stride
    apart that is not C*G*G (views of (B, rows) field planes, as the
    batched table loop hands them over): each scene's outputs bit for bit
    its single-scene launch, and within the single launch's tolerance of
    the twin."""
    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=16).validate()
    cap, gg = p.cell_capacity, 256
    scenes = [random_tables(p, seed, fill=0.3) for seed in (3, 4, 5)]
    flat = {k: torch.zeros((3, cap * gg + 384), device=card) for k in scenes[0]}
    for k, v in flat.items():
        for b in range(3):
            v[b, : cap * gg] = scenes[b][k].reshape(-1).to(card)
    tables = {k: v[:, : cap * gg].unflatten(-1, (cap, gg)) for k, v in flat.items()}
    n0 = dict(kernels.LAUNCHES)
    got = kernels.stencil_forces_batched_cuda(p, tables)
    assert kernels.LAUNCHES["stencil_forces_batched"] == n0["stencil_forces_batched"] + 1
    assert kernels.LAUNCHES["stencil_forces"] == n0["stencil_forces"]
    for b in range(3):
        one = {k: v[b].contiguous() for k, v in tables.items()}
        single = kernels.stencil_forces_cuda(p, one)
        assert all(bitwise(x[b], y) for x, y in zip(got, single)), b
        want = stencil_forces_plain(p, one)
        summed = want[2] + want[3]
        for i, (a, w) in enumerate(zip(got, want)):
            tol = 1e-4 + 1e-5 * w.abs() + (1e-5 * summed if i < 2 else 0)
            assert bool(((a[b] - w).abs() <= tol).all())


def test_batched_compact_kernel_equals_single_launches(card):
    """Kernel 2's wrap form on B = 3 stacks (70 % fill: cells overflow) in
    one launch: each scene equal to its single launch and to the twin."""
    p = pt.SimParams(n_dead=0, grid_dim=16).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    gen = torch.Generator(device=card).manual_seed(5)
    data = torch.randn((3, 9, cs, g * g), generator=gen, device=card)
    occ = torch.rand((3, cs, g * g), generator=gen, device=card) < 0.7
    mv = torch.randint(-1, 2, (3, 2, cs, g * g), generator=gen, device=card).float()
    far = torch.full_like(mv[:, 0], 99.0)
    planes = torch.cat(
        [data, torch.where(occ, mv[:, 0], far)[:, None], torch.where(occ, mv[:, 1], far)[:, None]],
        dim=1,
    ).contiguous()
    n0 = kernels.LAUNCHES["compact_batched"]
    out, inc = kernels.compact_batched_cuda(p, planes)
    assert kernels.LAUNCHES["compact_batched"] == n0 + 1
    for b in range(3):
        out1, inc1 = kernels.compact_cuda(p, planes[b].contiguous())
        assert bitwise(out[b], out1) and bitwise(inc[b], inc1)
        out_p, inc_p = compact_plain(p, planes[b])
        assert torch.equal(inc[b], inc_p) and bool((out[b] == out_p).all())
    assert bool((inc > cs).any())


def band_span_inputs(p, card, seed):
    """(tbl, strip, first step) of one span from the mid-step state after
    200 steps of the band scene ``p`` at ``seed`` on the span path."""
    sim = pt.Simulation(p.replace(seed=seed), device=card)
    sim.step_chunk(200, start_step=0)
    ts = enter_table(p, sim.state)
    ts = make_table_step_parts(p)[0](ts, *t_chunk.gates(p, ts.step))
    tbl, strip = _make_mega_glue(p)[0](ts.fields)
    return tbl, strip, ts.step + 1


def test_batched_mega_span_equals_single_launches(card):
    """Kernel 3 on B = 3 band scenes (1000 HEX bots, G=16: one cluster of
    16 CTAs each) in one launch: each scene bit for bit its single launch
    and within the single launch's tolerance of the twin; the plan learns
    B."""
    p = pt.SimParams(
        n_cells=1000, n_dead=0, seed=3, config=pt.Config.HEX, light_x=-5.0,
    ).validate()
    ins = [band_span_inputs(p, card, seed) for seed in (3, 4, 5)]
    assert len({first for _, _, first in ins}) == 1
    tbl = torch.stack([t for t, _, _ in ins])
    strip = torch.stack([s for _, s, _ in ins])
    first = step_tensor(ins[0][2], card)
    g, cs, n_pad = p.resolved_grid_dim(), p.storage_capacity(), table_geometry(p)[2]
    plan = kernels.mega_plan(cs, g, n_pad, p.has_payload, scenes=3)
    lib = kernels.library_mega_plan(cs, g, n_pad, p.has_payload, scenes=3)
    assert plan["ctas"] == lib["ctas"] == 48 and lib["max_active_clusters"] >= 1
    n0 = kernels.LAUNCHES["mega_span_batched"]
    got = kernels.mega_span_batched_cuda(p, tbl, strip, first)
    assert kernels.LAUNCHES["mega_span_batched"] == n0 + 1
    for b in range(3):
        single = kernels.mega_span_cuda(p, tbl[b].contiguous(), strip[b].contiguous(),
                                        first)
        assert bitwise(got[0][b], single[0]) and bitwise(got[1][b], single[1]), b
        want = mega_span_plain(p, tbl[b], strip[b], first)
        assert_span_close(p, (got[0][b], got[1][b]), want)


def test_batched_table_loop_on_card_matches_cpu(card):
    """The batched table loop on the card (B = 2 scenes of 300 HEX bots,
    K = 4, 12 steps) against the same run on the CPU twins, one kernel-1
    launch per step and one kernel-2 launch per rebuild for both scenes;
    and the batched span path (24 seg-aligned steps) with one kernel-3
    launch per span.  Positions 1e-5; velocities 1e-4 plus what the
    position differences cost through the magnet ramp (kernel 3's form)."""
    from particlerobotsimulations_torch.engine_table import make_run_chunk_table_batched
    from particlerobotsimulations_torch.state import (
        batch_state_from_arrays,
        batch_state_to_arrays,
    )
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state

    p = pt.SimParams(
        n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX, light_x=-5.0,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0, slot_rebuild_steps=4,
        centroid_int=0.08, phase_update_interval=0.16,
    ).validate()
    arrays = batch_state_to_arrays(make_batch_state(p, [3, 4], "cpu"))
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    arrays["seed"] = np.array([3, 4])
    run = make_run_chunk_table_batched(p)
    assert run.path_info["use_mega"] and run.path_info["gate_seg"] == 8
    for n_steps, aligned in ((12, False), (24, True)):
        n0 = dict(kernels.LAUNCHES)
        a = batch_state_to_arrays(
            run(batch_state_from_arrays(p, arrays, card), n_steps, aligned)
        )
        dl = {k: kernels.LAUNCHES[k] - n0[k] for k in n0}
        b = batch_state_to_arrays(
            run(batch_state_from_arrays(p, arrays, "cpu"), n_steps, aligned)
        )
        # velocities take the force that position ulps cost through the
        # magnet ramp, as in kernel 3's tolerance (chip_smoke.py)
        dpos = float(np.abs(a["pos"] - b["pos"]).max())
        (_, _, _, _, attr, _, _, mina, inv_i2_sq, inv_span) = pair_constants(p)
        slope = abs(attr * inv_i2_sq - mina) * inv_span
        assert dpos <= 1e-5
        np.testing.assert_allclose(
            a["vel"], b["vel"], atol=1e-4 + p.timestep * 6 * slope * 2 * dpos
        )
        assert dl["stencil_forces"] == dl["compact"] == dl["mega_span"] == 0
        if aligned:
            assert dl["mega_span_batched"] == 3 and run.redos == 0
        else:
            assert dl["stencil_forces_batched"] == 12 and dl["compact_batched"] == 3


def test_batched_wrappers_refuse_cpu_tensors_and_bad_strides():
    """No fallback: the batched wrappers refuse CPU tensors, and kernel 1's
    refuses planes whose scene blocks are not contiguous."""
    p = pt.SimParams(n_cells=300, n_dead=0, grid_dim=16).validate()
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    n_pad = table_geometry(p)[2]
    tables = {k: torch.zeros((2, cs, g * g)) for k in ("px", "py", "vx", "vy", "rad")}
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stencil_forces_batched_cuda(p, tables)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_batched_cuda(p, torch.zeros((2, 11, cs, g * g)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mega_span_batched_cuda(
            p, torch.zeros((2, N_TF, cs, g * g)), torch.zeros((2, N_TF, n_pad // 128, 128)), 1,
        )
    if torch.cuda.is_available():
        strided = {k: torch.zeros((2, g * g, cs), device="cuda").transpose(1, 2)
                   for k in tables}
        with pytest.raises(ValueError, match="contiguous"):
            kernels.stencil_forces_batched_cuda(p, strided)


def dp_tp_planes(p, card, shards=2, scenes=3):
    """The dp x tp loop's shard-major inputs on the card: halo-extended
    tables (S, B, 7, C, E) of ``ext_tables`` per scene, and a random
    padded move-plane stack (S, B, 11, Cs, E) at 70 % fill."""
    ext = torch.stack([ext_tables(p, seed, shards)[0] for seed in range(5, 5 + scenes)],
                      dim=1).to(card)
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    l0, h = g * g // shards, HALO_ROWS * g
    gen = torch.Generator(device=card).manual_seed(6)
    shape = (shards, scenes, cs, l0 + 2 * h)
    data = torch.randn((shards, scenes, 9) + shape[2:], generator=gen, device=card)
    occ = torch.rand(shape, generator=gen, device=card) < 0.7
    mv = torch.randint(-1, 2, (2,) + shape, generator=gen, device=card).float()
    far = torch.full_like(mv[0], 99.0)
    planes = torch.cat([data, torch.where(occ, mv[0], far)[:, :, None],
                        torch.where(occ, mv[1], far)[:, :, None]], dim=2).contiguous()
    return ext, planes, h, l0


@pytest.mark.parametrize("payload", [False, True])
def test_batched_sharded_kernels_equal_single_launches(card, payload):
    """Kernel 4 and kernel 2's padded form on S x B = 2 x 3 blocks in one
    launch each (one count under their batched keys): every block bit for
    bit its single-block launch, and kernel 4 within its tolerance of the
    twin, kernel 2 equal to it."""
    from particlerobotsimulations_torch.ops.pallas_stencil import (
        FIELDS,
        stencil_forces_ext_plain,
    )

    p = pt.SimParams(n_dead=-1 if payload else 0, grid_dim=32).validate()
    ext, planes, h, l0 = dp_tp_planes(p, card)
    tables = {k: ext[:, :, j] for j, k in enumerate(FIELDS)}
    n0 = dict(kernels.LAUNCHES)
    got = kernels.stencil_forces_ext_batched_cuda(p, tables, h, l0)
    out_k, inc_k = kernels.compact_padded_batched_cuda(p, planes, h, l0)
    dl = {k: kernels.LAUNCHES[k] - n0[k] for k in n0}
    assert dl["stencil_forces_ext_batched"] == dl["compact_padded_batched"] == 1
    assert sum(dl.values()) == 2
    assert got[0].shape == (2, 3, p.cell_capacity, l0) and inc_k.shape == (2, 3, l0)
    for s in range(2):
        for b in range(3):
            one = kernels.stencil_forces_ext_cuda(p, {k: v[s, b][None] for k, v in tables.items()},
                                                  h, l0)
            assert all(bitwise(x[s, b], y[0]) for x, y in zip(got, one)), (s, b)
            o1, c1 = kernels.compact_padded_cuda(p, planes[s, b][None].contiguous(), h, l0)
            assert bitwise(out_k[s, b], o1[0]) and bitwise(inc_k[s, b], c1[0]), (s, b)
    want = stencil_forces_ext_plain(p, tables, h, l0)
    summed = want[2] + want[3]
    for i, (a, b_) in enumerate(zip(got, want)):
        tol = 1e-4 + 1e-5 * b_.abs() + (1e-5 * summed if i < 2 else 0)
        assert bool(((a - b_).abs() <= tol).all())
    out_p, inc_p = compact_padded_plain(p, planes, h, l0)
    assert torch.equal(inc_k, inc_p) and bool((out_k == out_p).all())


def test_dp_tp_table_loop_on_card_matches_cpu(card):
    """The dp x tp table loop on ``LocalRing(2)`` on the card (B = 2 scenes
    of 300 HEX bots, K = 4, 12 steps) against the same run on the CPU
    twins: one kernel-4 launch per step and one padded kernel-2 launch per
    rebuild for all four blocks."""
    from particlerobotsimulations_torch.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state
    from particlerobotsimulations_torch.state import (
        batch_state_from_arrays,
        batch_state_to_arrays,
    )

    p = pt.SimParams(
        n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX, light_x=-5.0,
        force_backend=pt.ForceBackend.PALLAS, phase_std=0.0, slot_rebuild_steps=4,
    )
    run_c, p2 = make_sharded_table_run_batched(p, LocalRing(2, card))
    run_h, _ = make_sharded_table_run_batched(p, LocalRing(2, "cpu"))
    arrays = batch_state_to_arrays(make_batch_state(p2, [3, 4], "cpu"))
    rng = np.random.default_rng(99)
    arrays["pos"] = arrays["pos"] + (
        1e-4 * rng.standard_normal(arrays["pos"].shape)
    ).astype(np.float32)
    n0 = dict(kernels.LAUNCHES)
    a = batch_state_to_arrays(run_c(batch_state_from_arrays(p2, arrays, card), 12))
    dl = {k: kernels.LAUNCHES[k] - n0[k] for k in n0}
    assert dl["stencil_forces_ext_batched"] == 12 and dl["compact_padded_batched"] == 3
    # the replayed ungated block rebuilds through its conditional node
    assert sum(without_cond_set(dl).values()) == 15 and dl["cond_set"] <= 3
    b = batch_state_to_arrays(run_h(batch_state_from_arrays(p2, arrays, "cpu"), 12))
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-5)
    np.testing.assert_allclose(a["vel"], b["vel"], atol=1e-4)


def test_batched_sharded_wrappers_refuse():
    """No fallback: the dp x tp wrappers refuse CPU tensors and stacks
    without their two leading axes."""
    p = pt.SimParams(n_dead=0, grid_dim=32).validate()
    _, tables, h, l0 = ext_tables(p, 1)
    cs = p.storage_capacity()
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stencil_forces_ext_batched_cuda(p, {k: v[:, None] for k, v in tables.items()},
                                                h, l0)
    with pytest.raises(ValueError, match="S, B, C, E"):
        kernels.stencil_forces_ext_batched_cuda(p, tables, h, l0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_padded_batched_cuda(p, torch.zeros((4, 2, 11, cs, l0 + 2 * h)), h, l0)
    with pytest.raises(ValueError, match="S, B, nf"):
        kernels.compact_padded_batched_cuda(p, torch.zeros((4, 11, cs, l0 + 2 * h)), h, l0)


# ------------------------------------- the differentiable path, checkpoints


def test_diff_collide_on_card_matches_cpu_and_stencil_grads(card):
    """The autograd wrapper of kernel 1 on the card: its forward against
    its CPU twin's forward on one 300-bot state (kernel 1's tolerance:
    velocities 1e-4, magnitudes 1e-4 absolute + 1e-5 relative), one
    kernel-1 launch; its gradient against the STENCIL collide's on the
    card, which is the backward it runs (the same graph on the same
    inputs: 1e-5 relative to the largest entry)."""
    from particlerobotsimulations_torch.ops.pallas_stencil import make_diff_pallas_collide
    from particlerobotsimulations_torch.ops.stencil import stencil_collide

    p = pt.SimParams(n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX,
                     force_backend=pt.ForceBackend.PALLAS, light_x=-5.0).validate()
    st = pt.Simulation(p, device="cpu").state
    rng = np.random.default_rng(7)
    pos = st.pos + torch.tensor(1e-4 * rng.standard_normal(tuple(st.pos.shape)),
                                dtype=torch.float32)
    vel = torch.tensor(0.05 * rng.standard_normal(tuple(st.pos.shape)), dtype=torch.float32)
    rad = st.rad + torch.tensor(rng.uniform(0, 0.02, st.n_pad), dtype=torch.float32)
    mask = pt.active_mask(p, st.n_pad)
    payload = pt.payload_mask(p, st.n_pad)
    collide = make_diff_pallas_collide(p, p.timestep)
    cts = [torch.tensor(rng.standard_normal(tuple(s)), dtype=torch.float32)
           for s in ((st.n_pad, 2), (st.n_pad,), (st.n_pad,))]

    def run(fn, dev):
        ins = [t.to(dev).requires_grad_() for t in (pos, vel, rad)]
        outs = fn(*ins, mask.to(dev), payload.to(dev))
        grads = torch.autograd.grad(outs, ins, [c.to(dev) for c in cts])
        return [o.detach().cpu() for o in outs], [g.cpu() for g in grads]

    n0 = kernels.LAUNCHES["stencil_forces"]
    outs_c, grads_c = run(collide, card)
    assert kernels.LAUNCHES["stencil_forces"] == n0 + 1
    outs_h, _ = run(collide, "cpu")
    for got, want in zip(outs_c, outs_h):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-5)
    _, grads_s = run(lambda *a: stencil_collide(p, *a, p.timestep), card)
    for got, want in zip(grads_c, grads_s):
        assert torch.isfinite(got).all() and got.abs().max() > 0
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_native_renderer_builds_from_source(card):
    from particlerobotsimulations_torch.render import native

    lib = native.load()
    assert lib.path == native.library_path() and lib.path.exists()
    img = np.zeros((8, 8, 3), np.uint8)
    native.splat_disks(img, [4.0], [4.0], [2.0], [[255, 0, 0]])
    assert img[4, 4, 0] == 255
    jpeg = native.encode_jpeg(np.full((16, 16, 3), 90, np.uint8))
    assert jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9"


def test_card_checkpoint_loads_on_card_and_refuses_cpu(card, tmp_path):
    from particlerobotsimulations_torch.io.checkpoint import load_checkpoint, save_checkpoint

    p = pt.SimParams(n_cells=24, n_dead=2, time_to_dead=0.2, phase_std=0.3, seed=4)
    sim = pt.Simulation(p, device=card)
    sim.step_chunk(10)
    path = str(tmp_path / "card.ck")
    save_checkpoint(path, sim.params, sim.state)
    _, st = load_checkpoint(path, device=card)
    assert st.generator.device.type == "cuda"
    assert torch.equal(st.generator.get_state(), sim.state.generator.get_state())
    resumed = pt.Simulation(sim.params, state=st, device=card)
    sim.step_chunk(30)
    resumed.step_chunk(30)
    for k in ("pos", "vel", "rad", "phase", "dead"):
        assert torch.equal(getattr(sim.state, k), getattr(resumed.state, k)), k
    with pytest.raises(ValueError, match="cuda generator state.*cpu device"):
        load_checkpoint(path, device="cpu")


# the graph runner's scene: 2,000 HEX bots with phase noise, centroid gates
# every 16 steps and phase gates every 24, so that a 64-step chunk holds
# gated and ungated K=4 blocks and a ragged end
GRAPH_SCENE = dict(n_cells=2000, n_dead=0, seed=7, config=pt.Config.HEX,
                   force_backend=pt.ForceBackend.PALLAS, slot_rebuild_steps=4,
                   light_x=-20.0, phase_std=0.5, centroid_int=0.16,
                   phase_update_interval=0.24)
CHUNK_FIELDS = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
                "centroid_ring")


def reset_counts():
    torch.cuda.synchronize()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    for k in REBUILDS:
        REBUILDS[k] = 0
    for k in OCCUPANCY:
        OCCUPANCY[k] = 0


class CountedBlock(t_chunk.CapturedBlock):
    """``chunk.CapturedBlock`` that keeps its replays and counts
    the selects (``torch.where`` on a 0-dim condition) its capture made."""

    made: list = []

    def __init__(self, block, carry):
        real = torch.where
        self.selects = 0

        def spy(cond, *args, **kw):
            if torch.is_tensor(cond) and cond.dim() == 0 and args:
                self.selects += 1
            return real(cond, *args, **kw)

        torch.where = spy
        try:
            super().__init__(block, carry)
        finally:
            torch.where = real
        self.replays = 0
        CountedBlock.made.append(self)

    def __call__(self, carry, step):
        self.replays += 1
        return super().__call__(carry, step)


def counted_blocks(monkeypatch) -> list:
    """Make the runners take :class:`CountedBlock`; returns the list of
    the blocks they capture."""
    CountedBlock.made = []
    monkeypatch.setattr(t_chunk, "CapturedBlock", CountedBlock)
    return CountedBlock.made


def replayed_conds(blocks) -> int:
    """``cond_set`` launches the blocks' replays made (those of the
    bodies that ran included: a redone span segment's rebuilds), after
    checking each capture: one top-level conditional node per top-level
    ``cond_set``, a body with nodes, kernel nodes at the top level, and no
    select left."""
    for b in blocks:
        n = b.launches.get("cond_set", 0)
        assert b.selects == 0
        assert b.nodes["kernels"] > 0, b.nodes
        if n:
            assert b.nodes["conditional"] == n and b.nodes["body_nodes"] > 0, b.nodes
        else:
            assert b.nodes["conditional"] == 0 and b.nodes["body_nodes"] == 0, b.nodes
    return sum(b.replays * b.launches.get("cond_set", 0)
               + sum(c.get("cond_set", 0) * int(t) for c, t in b.counted) for b in blocks)


def without_cond_set(launches) -> dict:
    """The launch counts apart from ``cond_set``, which only a graph's
    conditional node launches (an eager rebuild selects)."""
    return {k: v for k, v in launches.items() if k != "cond_set"}


ROW_STEP_KEYS = ("row_step", "row_step_batched")


def without_glue(launches) -> dict:
    """:func:`without_cond_set` apart from the row step's counts too: a
    loop of ``make_table_step`` launches the row step twice a step, the
    runners' blocks fuse a step's post with the next ungated step's pre
    (``engine_table.glue_schedule``)."""
    return {k: v for k, v in without_cond_set(launches).items() if k not in ROW_STEP_KEYS}


def scheduled_row_steps(p, start, n_steps) -> int:
    """The row-step launches of an ``n_steps`` chunk of the table runner
    from step ``start``, as its blocks schedule them."""
    k = max(1, p.resolved_slot_rebuild_steps())
    return sum(sum(part in ("pre", "post_pre", "post") for part, _ in
                   engine_table.glue_schedule(pattern))
               for pattern in engine_table.table_pieces(p, k, start, n_steps))


def eager_table_loop(p, state, n_steps):
    """``n_steps`` of ``make_table_step``, one call a step, on the regular
    schedule (chunk-relative rebuilds) between chunk entry and exit: the
    eager loop the graph runner is held to."""
    k = max(1, p.resolved_slot_rebuild_steps())
    step = make_table_step(p)
    ts = enter_table(p, state)
    for j in range(n_steps):
        ts = step(ts, *t_chunk.gates(p, ts.step), j % k == k - 1)
    return exit_table(p, ts)


@pytest.mark.parametrize("batched", [False, True])
def test_graph_loop_equals_eager_step_loop(card, batched, monkeypatch):
    """Two 62-step chunks of the table runner (ungated K-step blocks
    replayed from a CUDA graph after the first, each rebuild through its
    conditional node) equal the eager step loop (the select) bit for bit,
    with equal rebuild counts and equal launches apart from ``cond_set``,
    which the graphs launch once per replayed rebuild, and the row step,
    which the eager loop launches twice a step and the blocks as they
    schedule it; batched: three scenes in lockstep."""
    p = resolve_params(pt.SimParams(**GRAPH_SCENE).validate())

    def fresh():
        if batched:
            return make_batch_state(p, [0, 1, 2], card)
        return pt.Simulation(p, device=card).state

    blocks = counted_blocks(monkeypatch)
    run = (make_run_chunk_table_batched if batched else make_run_chunk_table)(p)
    reset_counts()
    got = fresh()
    for _ in range(2):
        got = run(got, 62)
    counts = (dict(kernels.LAUNCHES), dict(REBUILDS))
    reset_counts()
    want = fresh()
    for _ in range(2):
        want = eager_table_loop(p, want, 62)
    assert (without_glue(kernels.LAUNCHES), dict(REBUILDS)) == (
        without_glue(counts[0]), counts[1])
    key = "row_step_batched" if batched else "row_step"
    assert kernels.LAUNCHES[key] == 2 * 124
    assert counts[0][key] == scheduled_row_steps(p, 0, 62) + scheduled_row_steps(p, 62, 62)
    assert kernels.LAUNCHES["cond_set"] == 0
    assert counts[0]["cond_set"] == replayed_conds(blocks) > 0
    assert sum(counts[1].values()) == 2 * 15
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step == 124


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("overflow_slots", [8, 0])
def test_graph_and_eager_count_equal_occupancy(card, overflow_slots, batched, monkeypatch):
    """The occupancy maxima (``engine_table.OCCUPANCY``) that the runner's
    graphs take inside their replays (the parking strip inside the exact
    rebuild's conditional node) equal those of the same runner with its
    blocks eager, on a crowded table: ``cell_capacity`` 8 with 8 spill
    rows (bots in spill rows, none parked) or with none (bots parked)."""
    p = resolve_params(pt.SimParams(**dict(GRAPH_SCENE, cell_capacity=8,
                                           overflow_slots=overflow_slots)).validate())
    make = make_run_chunk_table_batched if batched else make_run_chunk_table

    def fresh():
        if batched:
            return make_batch_state(p, [0, 1, 2], card)
        return pt.Simulation(p, device=card).state

    results = []
    for run in (make(p), eager_runner(lambda: make(p), monkeypatch)):
        reset_counts()
        state = fresh()
        for _ in range(2):
            state = run(state, 62)
        results.append((state, dict(OCCUPANCY), dict(REBUILDS)))
    (got, counts, rebuilds), (want, eager_counts, eager_rebuilds) = results
    assert (counts, rebuilds) == (eager_counts, eager_rebuilds)
    assert torch.equal(got.pos, want.pos)
    if overflow_slots:
        assert counts["spill_max"] > 0 and counts["parked_max"] == 0
    else:
        assert counts["spill_max"] == 0 and counts["parked_max"] > 0
        # exact rebuilds taken: the strip is counted inside the graphs' bodies
        assert rebuilds["exact"] > 0


@pytest.mark.parametrize("kind", ["single", "adaptive", "batched"])
def test_table_chunk_reads_nothing_from_the_card(card, kind):
    """A warm table-loop chunk (graphs captured) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing between its entry
    and its exit waits for the card; the adaptive runner reads its last
    probe from the host copy enqueued with it."""
    p = resolve_params(pt.SimParams(**dict(GRAPH_SCENE, centroid_int=2.0,
                                            phase_update_interval=2.0)).validate())
    if kind == "batched":
        run, state = make_run_chunk_table_batched(p), make_batch_state(p, [0, 1], card)
    else:
        make = make_adaptive_run_chunk if kind == "adaptive" else make_run_chunk_table
        run, state = make(p), pt.Simulation(p, device=card).state
    for _ in range(2):
        state = run(state, 400, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = run(state, 400, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.step == 1200 and bool(torch.isfinite(state.pos).all())


# ------------------------------------------ the compiled small-scene paths

class EagerBlock:
    """Stands in for ``chunk.CapturedBlock``: the same runner, its
    captured blocks run eagerly."""

    def __init__(self, block, carry):
        self.block = block

    def __call__(self, carry, step):
        return self.block(carry, step_tensor(step, next(iter(carry.values())).device))


def eager_runner(make, monkeypatch):
    """A runner built and first run with its blocks eager: returns
    ``make()``'s runner and a callable that runs it under the swap."""
    run = make()

    def call(*args):
        with monkeypatch.context() as m:
            m.setattr(t_chunk, "CapturedBlock", EagerBlock)
            return run(*args)

    return call


# 300 bots on DENSE with the centroid every 100 steps and the noisy phase
# law every 150: 32-step blocks from each gate, short ones before the next
# gate and at a chunk's end
SMALL_SCENE = dict(n_cells=300, n_dead=0, seed=5, config=pt.Config.HEX, light_x=-2.0,
                   light_y=4.0, force_backend=pt.ForceBackend.DENSE, phase_std=0.5,
                   centroid_int=1.0, phase_update_interval=1.5)


@pytest.mark.parametrize("batched", [False, True])
def test_dense_graph_equals_eager(card, batched, monkeypatch):
    """Two 170-step chunks of the per-bot runner, its ungated blocks
    replayed from a CUDA graph after the first, equal the same runner with
    eager blocks and a plain loop of ``make_step`` bit for bit; batched:
    three scenes in lockstep."""
    from particlerobotsimulations_torch.engine import (
        make_run_chunk,
        make_run_chunk_batched,
        make_step,
        make_step_batched,
    )

    p = pt.SimParams(**SMALL_SCENE).validate()

    def fresh():
        if batched:
            return make_batch_state(p, [0, 1, 2], card)
        return pt.Simulation(p, device=card).state

    make = make_run_chunk_batched if batched else make_run_chunk
    graph, eager = make(p, card), eager_runner(lambda: make(p, card), monkeypatch)
    got, ref = fresh(), fresh()
    for _ in range(2):
        got, ref = graph(got, 170), eager(ref, 170)
    step = (make_step_batched if batched else make_step)(p, card)
    want = fresh()
    for _ in range(340):
        want = step(want)
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.step == want.step == 340


def reference_span_chunk(p, state, n_steps, glue=None):
    """The span path with each segment's flag read before the next segment
    is enqueued (``bool(ok_all.item())``), every piece eager: (state,
    redos).  ``glue``: ``_make_mega_glue`` or a stand-in for it."""
    from particlerobotsimulations_torch import rng
    from particlerobotsimulations_torch.engine_table import _smart_rebuild

    step = make_table_step(p)
    step_pre, step_post = make_table_step_parts(p)
    k, seg = max(1, p.resolved_slot_rebuild_steps()), gate_seg(p)
    bps = seg // k
    mega = make_mega_span(p, table_geometry(p)[2])
    mega_pack, mega_unpack, incremental_packed = (glue or _make_mega_glue)(p)
    redos = 0

    def regular(ts, n):
        for j in range(n):
            ts = step(ts, *t_chunk.gates(p, ts.step), j % k == k - 1)
        return ts

    ts = enter_table(p, state)
    for _ in range(n_steps // seg):
        entry = (dict(ts.fields), ts.origin, ts.step, ts.centroid_ring,
                 rng.snapshot(ts.generator))
        for _ in range(k - 1):
            ts = step(ts, *t_chunk.gates(p, ts.step), False)
        ts = _smart_rebuild(p, step_pre(ts, *t_chunk.gates(p, ts.step)))
        tbl, strip = mega_pack(ts.fields)
        ok_all = torch.ones((), dtype=torch.bool, device=tbl.device)
        first = ts.step + 1
        for b in range(bps - 1):
            tbl, strip = mega(tbl, strip, first + b * k)
            tbl, ok = incremental_packed(tbl, ts.origin)
            ok_all = ok_all & ok.all()
        if bool(ok_all.item()):
            ts = step_post(ts.replace(fields=mega_unpack(tbl, strip),
                                      step=first + (bps - 1) * k - 1))
            continue
        redos += 1
        fields, origin, step0, ring, snap = entry
        rng.restore(ts.generator, snap)
        ts = regular(ts.replace(fields=fields, origin=origin, step=step0, centroid_ring=ring),
                     seg)
    return exit_table(p, regular(ts, n_steps % seg)), redos


@pytest.mark.parametrize("batched", [False, True])
def test_lagged_span_chunk_equals_one_read_per_segment(card, batched, monkeypatch):
    """128 HEX bots, 12-step segments (two spans each), one bot kicked to
    60 u/s so that span rebuilds refuse: a 48-step seg-aligned chunk of
    the runner (each segment one CUDA graph that decides its
    adopt-or-redo with a conditional node) equals the one-read-per-segment
    reference bit for bit, with equal launches, rebuilds and redos;
    batched: the kick in scene 1 of two."""
    from particlerobotsimulations_torch.state import (
        batch_state_from_arrays,
        batch_state_to_arrays,
    )

    p = pt.SimParams(n_cells=128, n_dead=0, seed=3, config=pt.Config.HEX,
                     force_backend=pt.ForceBackend.PALLAS, light_x=-5.0, phase_std=0.5,
                     centroid_int=0.12, phase_update_interval=0.24,
                     slot_rebuild_steps=4).validate()
    if batched:
        arrays = batch_state_to_arrays(make_batch_state(p, [2, 3], "cpu"))
        arrays["vel"][1, 7, 0] += 60.0
        arrays["seed"] = np.array([2, 3])

        def fresh():
            return batch_state_from_arrays(p, arrays, card)
    else:
        arrays = state_to_arrays(pt.Simulation(p, device="cpu").state)
        arrays["vel"][7, 0] += 60.0

        def fresh():
            return state_from_arrays(p, arrays, card)

    blocks = counted_blocks(monkeypatch)
    run = (make_run_chunk_table_batched if batched else make_run_chunk_table)(p)
    runs = []
    for chunk in (lambda: run(fresh(), 48, True), lambda: reference_span_chunk(p, fresh(), 48)):
        reset_counts()
        out = chunk()
        runs.append((out, dict(kernels.LAUNCHES), dict(REBUILDS)))
    (got, g_launch, g_reb), ((want, redos), r_launch, r_reb) = runs
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert run.redos == redos >= 1
    # the redone segments' blocks replay their rebuilds through conditional
    # nodes; the reference selects
    assert (without_glue(g_launch), g_reb) == (without_glue(r_launch), r_reb)
    assert g_launch["cond_set"] == replayed_conds(blocks) and r_launch["cond_set"] == 0
    assert g_launch["mega_span_batched" if batched else "mega_span"] > 0


SPAN_SCENE = dict(n_cells=128, n_dead=0, seed=3, config=pt.Config.HEX,
                  force_backend=pt.ForceBackend.PALLAS, light_x=-5.0, phase_std=0.5,
                  centroid_int=0.12, phase_update_interval=0.24, slot_rebuild_steps=4)


@pytest.mark.parametrize("batched", [False, True])
def test_segment_graph_redoes_when_forced_on_alternate_replays(card, batched, monkeypatch):
    """The span rebuilds' ``ok`` ANDed with a device flag that is set from
    outside the graphs before each 12-step segment, false on alternate
    ones: eight segments of the runner (each one CUDA graph once its gate
    pattern was seen) equal the one-read-per-segment reference under the
    same flags bit for bit, generators included, with equal redos,
    rebuilds and launches apart from ``cond_set``: the redo body's
    launches count only on the replays that took it."""
    p = pt.SimParams(**SPAN_SCENE).validate()
    flag = torch.ones((), dtype=torch.bool, device=card)
    real = engine_table._make_mega_glue

    def glue(params):
        pack, unpack, inc = real(params)

        def forced(tbl, origin):
            new, ok = inc(tbl, origin)
            return new, ok & flag

        return pack, unpack, forced

    monkeypatch.setattr(engine_table, "_make_mega_glue", glue)
    blocks = counted_blocks(monkeypatch)
    run = (make_run_chunk_table_batched if batched else make_run_chunk_table)(p)
    fresh = ((lambda: make_batch_state(p, [2, 3], card)) if batched
             else (lambda: pt.Simulation(p, device=card).state))
    seg = gate_seg(p)
    outs = []
    for graph in (True, False):
        reset_counts()
        state, redos = fresh(), 0
        for i in range(8):
            flag.fill_(i % 2 == 1)
            if graph:
                state = run(state, seg, True)
            else:
                state, r = reference_span_chunk(p, state, seg, glue)
                redos += r
        torch.cuda.synchronize()
        outs.append((state, redos, dict(kernels.LAUNCHES), dict(REBUILDS)))
    (got, _, g_launch, g_reb), (want, redos, r_launch, r_reb) = outs
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    gens = (lambda s: s.generator.sources) if batched else (lambda s: [s.generator])
    for a, b in zip(gens(got), gens(want)):
        assert torch.equal(a.get_state(), b.get_state())
    assert run.redos == redos == 4
    assert (without_glue(g_launch), g_reb) == (without_glue(r_launch), r_reb)
    assert g_launch["cond_set"] == replayed_conds(blocks) and r_launch["cond_set"] == 0
    segments = [b for b in blocks if b.counted]
    assert segments and sum(b.replays for b in segments) >= 6
    assert all(b.nodes["conditional"] == 2 for b in segments)


@pytest.mark.parametrize("source", ["generator", "scenes"])
def test_gated_block_graph_equals_eager(card, source, monkeypatch):
    """Two 46-step chunks of the table runner with every gate firing (the
    centroid every 4 steps, the noisy phase law every 6, three bots killed
    at step 5): its gated and ungated blocks replayed from CUDA graphs,
    their draws fed in, equal the runner with eager blocks bit for bit,
    the draw sources' states included, on a ``torch.Generator`` and on a
    batch's ``SceneDraws``."""
    p = resolve_params(pt.SimParams(**dict(GRAPH_SCENE, n_dead=3, time_to_dead=0.05,
                                           centroid_int=0.04,
                                           phase_update_interval=0.06)).validate())
    batched = source == "scenes"
    make = make_run_chunk_table_batched if batched else make_run_chunk_table

    def fresh():
        return make_batch_state(p, [0, 1], card) if batched else pt.Simulation(
            p, device=card).state

    results = []
    for eager in (True, False):
        blocks = [] if eager else counted_blocks(monkeypatch)
        run = make(p)
        call = eager_runner(lambda run=run: run, monkeypatch) if eager else run
        reset_counts()
        state = fresh()
        eager_card = []
        for _ in range(2):
            before = t_chunk.EAGER["card"]
            state = call(state, 46)
            eager_card.append(t_chunk.EAGER["card"] - before)
        torch.cuda.synchronize()
        results.append((state, dict(kernels.LAUNCHES), dict(REBUILDS), blocks, eager_card))
    (e_state, e_launch, e_reb, _, _), (g_state, g_launch, g_reb, blocks, eager_card) = results
    assert (without_cond_set(e_launch), e_reb) == (without_cond_set(g_launch), g_reb)
    assert g_launch["cond_set"] == replayed_conds(blocks) > 0
    # the runner's first block ran eagerly before its capture; after it, none
    assert len(blocks) >= 3 and 0 < eager_card[0] < 46 and eager_card[1] == 0
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(g_state, k), getattr(e_state, k)), k
    gens = (lambda s: s.generator.sources) if batched else (lambda s: [s.generator])
    for a, b in zip(gens(g_state), gens(e_state)):
        assert torch.equal(a.get_state(), b.get_state())
    assert int(g_state.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


def test_mega_span_replays_at_the_step_it_reads(card):
    """Kernel 3 captured in a CUDA graph with its step tensor, replayed
    after the tensor is refilled, equals a direct launch at the new step
    bit for bit (the time enters through the radius law), and its twin
    within chip_smoke.py's tolerances."""
    p = pt.SimParams(n_cells=1000, n_dead=0, seed=3, config=pt.Config.HEX,
                     light_x=-5.0).validate()
    tbl, strip, first = band_span_inputs(p, card, 3)
    step = step_tensor(first, card)
    kernels.mega_span_cuda(p, tbl, strip, step)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = kernels.mega_span_cuda(p, tbl, strip, step)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    results = []
    for s in (first, first + 37):
        step.fill_(s)
        graph.replay()
        direct = kernels.mega_span_cuda(p, tbl, strip, step_tensor(s, card))
        assert bitwise(out[0], direct[0]) and bitwise(out[1], direct[1]), s
        assert_span_close(p, direct, mega_span_plain(p, tbl, strip, step_tensor(s, card)))
        results.append(direct[0].clone())
    assert not torch.equal(results[0], results[1])


@pytest.mark.parametrize("kind", ["dense", "dense_batched", "span", "span_batched"])
def test_small_chunk_reads_nothing_from_the_card(card, kind):
    """A warm chunk of the per-bot runner (DENSE) and of the span path
    (graphs captured) under ``torch.cuda.set_sync_debug_mode("error")``:
    nothing in it waits for the card, the span path's adopt-or-redo
    included (a conditional node; a segment whose gate pattern is new in
    the chunk is captured there and replayed, not run eagerly)."""
    from particlerobotsimulations_torch.engine import make_run_chunk, make_run_chunk_batched

    if kind.startswith("dense"):
        p = pt.SimParams(**SMALL_SCENE).validate()
        n = 200
    else:
        p = pt.SimParams(n_cells=1000, n_dead=0, seed=3, config=pt.Config.HEX,
                         light_x=-5.0).validate()
        n = 2 * gate_seg(p)
    if kind.endswith("batched"):
        state = make_batch_state(p, [0, 1], card)
        run = make_run_chunk_batched(p, card)
    else:
        state = pt.Simulation(p, device=card).state
        run = make_run_chunk(p, card)
    if kind.startswith("span"):
        assert run.path_info["use_mega"]
    for _ in range(2):
        state = run(state, n, True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = run(state, n, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.step == 3 * n and bool(torch.isfinite(state.pos).all())


# ------------------------------------------ the sharded loop's compiled chunk

# 300 bots on 4 shards (G=32), K=4, the noisy phase law every 20 steps and
# the centroid every 30: 4-step blocks, gated or not, and a ragged end
SHARDED_SCENE = dict(n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX, light_x=-5.0,
                     force_backend=pt.ForceBackend.PALLAS, phase_std=0.5,
                     slot_rebuild_steps=4, centroid_int=0.3, phase_update_interval=0.2)


def sharded_runner(kind, card, with_stats=False):
    """(runner, fresh-state function) of the sharded loop on the card: one
    scene on ``LocalRing(4)``, two scenes on it (dp x tp), or two scenes on
    two data places of two shards each."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh
    from particlerobotsimulations_torch.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )

    p = pt.SimParams(**SHARDED_SCENE)
    if kind == "single":
        run, p2 = make_sharded_table_run(p, LocalRing(4, card), with_stats)
        return run, lambda: pt.Simulation(p2, device=card).state
    if kind == "batched":
        run, p2 = make_sharded_table_run_batched(p, LocalRing(4, card), with_stats=with_stats)
    else:
        mesh = Mesh(np.array([card] * 4, dtype=object).reshape(2, 2), ("data", "bots"))
        run, p2 = make_sharded_table_run_batched(p, mesh=mesh, with_stats=with_stats)
    return run, lambda: make_batch_state(p2, [0, 1], card)


@pytest.mark.parametrize("kind", ["single", "batched", "mesh"])
def test_sharded_graph_equals_eager(card, kind, monkeypatch):
    """Two 46-step chunks of the sharded loop, its ungated K-step blocks
    replayed from a CUDA graph after the first (each rebuild through its
    conditional node), equal the same runner with eager blocks (the
    select) bit for bit, with equal stats and equal launches apart from
    ``cond_set``, launched once per replayed rebuild."""
    results = []
    for eager in (True, False):
        blocks = [] if eager else counted_blocks(monkeypatch)
        run, fresh = sharded_runner(kind, card, with_stats=True)
        call = eager_runner(lambda run=run: run, monkeypatch) if eager else run
        reset_counts()
        state, stats = fresh(), []
        for _ in range(2):
            state, st = call(state, 46)
            stats.append(st)
        torch.cuda.synchronize()
        results.append((state, stats, dict(kernels.LAUNCHES)))
    (e_state, e_stats, e_launch), (g_state, g_stats, g_launch) = results
    assert (e_stats, without_cond_set(e_launch)) == (g_stats, without_cond_set(g_launch))
    assert e_launch["cond_set"] == 0 and g_launch["cond_set"] == replayed_conds(blocks) > 0
    name = "stencil_forces_ext" if kind == "single" else "stencil_forces_ext_batched"
    assert g_launch[name] == 92 * (2 if kind == "mesh" else 1)
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(g_state, k), getattr(e_state, k)), k
    assert g_state.step == 92


@pytest.mark.parametrize("kind", ["single", "batched", "mesh"])
def test_sharded_chunk_reads_nothing_from_the_card(card, kind):
    """A warm chunk of the sharded loop (graphs captured) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing between its entry
    and its exit waits for the card; its stats are read after."""
    run, fresh = sharded_runner(kind, card, with_stats=True)
    state = fresh()
    for _ in range(2):
        state, _ = run(state, 46)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        result = t_chunk.drain(run.blocks(state, 46))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state, stats = run.read_stats(result)
    assert state.step == 138 and bool(torch.isfinite(state.pos).all())
    assert set(stats) == {"fallbacks", "spill_rows_max"}


# the dead step mid-block in a later chunk that ends in a ragged tail: 200
# HEX bots, K=4, the centroid every 8 steps, the noisy phase law every 12,
# 30 bots killed at step 21, chunks of 16 and 15 steps
DEAD_SCENE = dict(n_cells=200, n_dead=30, time_to_dead=0.21, seed=3, config=pt.Config.HEX,
                  light_x=-5.0, phase_std=0.5, slot_rebuild_steps=4, centroid_int=0.08,
                  phase_update_interval=0.12)
DEAD_CHUNKS = (16, 15)


@pytest.mark.parametrize("kind", ["table", "dense", "sharded"])
def test_dead_step_and_tail_graph_equals_eager(card, kind, monkeypatch):
    """Two chunks (16 + 15 steps, the bots killed at step 21, mid-block in
    the second, which ends in a ragged tail) of the table loop, the per-bot
    DENSE runner and the sharded loop on ``LocalRing(2)``, every block
    replayed from a CUDA graph (the dead step's, its scores fed in, and
    the tail's), equal the same runner with eager blocks bit for bit, with
    equal launches apart from ``cond_set``; no step ran eagerly after the
    runner's warm-up (its first block, before its capture)."""
    from particlerobotsimulations_torch.engine import make_run_chunk

    backend = pt.ForceBackend.DENSE if kind == "dense" else pt.ForceBackend.PALLAS
    p = pt.SimParams(**DEAD_SCENE, force_backend=backend).validate()
    if kind == "sharded":
        p = make_sharded_table_run(p, LocalRing(2, card))[1]

        def make():
            return make_sharded_table_run(p, LocalRing(2, card))[0]
    elif kind == "dense":
        def make():
            return make_run_chunk(p, card)
    else:
        def make():
            return make_run_chunk_table(p)

    results = []
    for eager in (True, False):
        blocks = [] if eager else counted_blocks(monkeypatch)
        run = make()
        call = eager_runner(lambda run=run: run, monkeypatch) if eager else run
        reset_counts()
        state = pt.Simulation(p, device=card).state
        eager_card = []
        for n in DEAD_CHUNKS:
            before = t_chunk.EAGER["card"]
            state = call(state, n)
            eager_card.append(t_chunk.EAGER["card"] - before)
        assert 0 < eager_card[0] < DEAD_CHUNKS[0] and eager_card[1:] == [0]
        torch.cuda.synchronize()
        results.append((state, dict(kernels.LAUNCHES)))
    (e_state, e_launch), (g_state, g_launch) = results
    assert without_cond_set(e_launch) == without_cond_set(g_launch)
    assert e_launch["cond_set"] == 0 and g_launch["cond_set"] == replayed_conds(blocks)
    assert len(blocks) >= 3
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(g_state, k), getattr(e_state, k)), k
    assert g_state.step == 31 and int(g_state.dead[: p.n_cells].sum()) == 30


def test_dp_tp_scenes_decide_alone_on_card(card):
    """dp x tp on the card (two scenes of :data:`SHARDED_SCENE` on
    ``LocalRing(4)``, scene 1's outermost bot kicked to 60 u/s so that its
    rebuilds fall back while scene 0's do not), two 46-step chunks from
    graphs: each scene bit for bit its solo run, the ring bit for bit two
    data places of four shards, the fallbacks the solo runs' summed."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh
    from particlerobotsimulations_torch.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )
    from particlerobotsimulations_torch.state import scene_state

    p = pt.SimParams(**SHARDED_SCENE)
    run, p2 = make_sharded_table_run_batched(p, LocalRing(4, card), with_stats=True)
    mesh = Mesh(np.array([card] * 8, dtype=object).reshape(2, 4), ("data", "bots"))
    mrun, p3 = make_sharded_table_run_batched(p, mesh=mesh, with_stats=True)
    single, p4 = make_sharded_table_run(p, LocalRing(4, card), with_stats=True)
    assert p2 == p3 == p4

    def fresh():
        st = make_batch_state(p2, [0, 1], card)
        vel = st.vel.clone()
        edge = int(torch.argmax(st.pos[1, : p2.n_cells, 0]))
        vel[1, edge, 0] = 60.0
        return st.replace(vel=vel)

    def chunks(call, state):
        fallbacks = 0
        for _ in range(2):
            state, stats = call(state, 46)
            fallbacks += stats["fallbacks"]
        return state, fallbacks

    got, fb = chunks(run, fresh())
    mgot, mfb = chunks(mrun, fresh())
    solo = [chunks(single, scene_state(fresh(), b)) for b in range(2)]
    torch.cuda.synchronize()
    assert fb == mfb == solo[0][1] + solo[1][1] and solo[1][1] > solo[0][1]
    for k in CHUNK_FIELDS[:-1]:
        assert torch.equal(getattr(mgot, k), getattr(got, k)), k
        for b in range(2):
            assert torch.equal(getattr(solo[b][0], k), getattr(got, k)[b]), (b, k)


# ------------------------------------------- the rebuild's conditional node

def rebuild_carry(p, card, far: bool):
    """A 2,000-bot table carry on the card after 2 steps and the third's
    integrate (where a rebuild runs) as a dict of planes and the origin;
    ``far`` moves one bot two cells (the incremental rebuild refuses)."""
    sim = pt.Simulation(p, device=card)
    ts = enter_table(p, sim.state)
    step = make_table_step(p)
    for _ in range(2):
        ts = step(ts, False, False, False, False)
    pre, _ = make_table_step_parts(p)
    ts = pre(ts, False, False, False)
    carry = {**ts.fields, "origin": ts.origin}
    if far:
        g, cs = p.resolved_grid_dim(), p.storage_capacity()
        rows = torch.nonzero(carry["val"][: g * g * cs] > 0.5).flatten()
        px = carry["px"].clone()
        px[rows[len(rows) // 2]] += np.float32(2.0) * np.float32(p.cutoff())
        carry["px"] = px
    return carry


def toggled_rebuild(p):
    """``block(carry, step)`` for ``_CapturedBlock``: the rebuild's two
    branches chosen by the carry's ``ok`` (set from outside the graph)
    through ``ops/cond.cond``; the results as outputs named ``r_*``."""
    from particlerobotsimulations_torch.engine_table import _derived_rows, _exact_rebuild
    from particlerobotsimulations_torch.ops.cond import cond
    from particlerobotsimulations_torch.ops.table_rebuild import incremental_rebuild

    def block(carry, step):
        fields = {k: carry[k] for k in TABLE_FIELDS}
        moved, _ = incremental_rebuild(p, fields, MOVE_FIELDS, carry["origin"])
        inc = {**_derived_rows(p, {**fields, **moved}), "origin": carry["origin"]}

        def take_exact(c):
            exact, origin = _exact_rebuild(p, {k: c[k] for k in TABLE_FIELDS})
            return {**exact, "origin": origin}

        out = cond(carry["ok"], lambda c: inc, take_exact, {**fields, "origin": carry["origin"]})
        return {f"r_{k}": v for k, v in out.items()}

    return block


def test_conditional_node_fires_on_alternate_replays(card):
    """A captured rebuild whose ``ok`` is toggled from outside the graph
    before each replay: each replay equals the eager select on the same
    carry and ``ok`` bit for bit (the incremental branch, then the exact
    one, in turns), the capture holds one conditional node, and each
    replay launches ``cond_set`` once."""
    p = resolve_params(pt.SimParams(**GRAPH_SCENE).validate())
    block = toggled_rebuild(p)
    # a bot two cells away: the incremental result drops it, so the two
    # branches differ
    carry = {**rebuild_carry(p, card, far=True), "ok": torch.ones((), dtype=torch.bool,
                                                                   device=card)}
    block(carry, step_tensor(0, card))  # the eager warm-up
    graph = t_chunk.CapturedBlock(block, carry)
    assert graph.nodes["conditional"] == 1 and graph.nodes["body_nodes"] > 0
    assert graph.launches == {"compact": 1, "cond_set": 1}
    for i in range(6):
        carry["ok"] = torch.full((), i % 2 == 0, dtype=torch.bool, device=card)
        n0 = kernels.LAUNCHES["cond_set"]
        got = graph(carry, 0)
        assert kernels.LAUNCHES["cond_set"] == n0 + 1
        want = block(carry, step_tensor(0, card))
        for k, v in want.items():
            assert torch.equal(got[k], v), (i, k)
    other = block({**carry, "ok": ~carry["ok"]}, None)
    assert not all(torch.equal(other[k], v) for k, v in want.items())


@pytest.mark.parametrize("kind", ["table", "batched", "sharded", "dp_tp"])
def test_cond_set_counted_once_per_replayed_rebuild(card, kind, monkeypatch):
    """Two 46-step chunks of each loop whose ungated blocks rebuild:
    ``cond_set`` counts one launch per rebuild its graphs replayed, each
    capture holds one conditional node per rebuild and no select, and
    the chunk's results equal the runner with eager blocks (the select)."""
    from particlerobotsimulations_torch.parallel.spatial_table import (
        make_sharded_table_run_batched,
    )

    def runner():
        if kind in ("table", "batched"):
            p = resolve_params(pt.SimParams(**GRAPH_SCENE).validate())
            if kind == "table":
                return (make_run_chunk_table(p), lambda: pt.Simulation(p, device=card).state,
                        lambda r, s: r(s, 46))
            return (make_run_chunk_table_batched(p), lambda: make_batch_state(p, [0, 1], card),
                    lambda r, s: r(s, 46))
        p = pt.SimParams(**SHARDED_SCENE)
        if kind == "sharded":
            run, p2 = make_sharded_table_run(p, LocalRing(4, card))
            return run, lambda: pt.Simulation(p2, device=card).state, lambda r, s: r(s, 46)
        run, p2 = make_sharded_table_run_batched(p, LocalRing(4, card))
        return run, lambda: make_batch_state(p2, [0, 1], card), lambda r, s: r(s, 46)

    results = []
    for eager in (True, False):
        with monkeypatch.context() as m:
            blocks = [] if eager else counted_blocks(m)
            if eager:
                m.setattr(t_chunk, "CapturedBlock", EagerBlock)
            run, fresh, advance = runner()
            reset_counts()
            state = fresh()
            for _ in range(2):
                state = advance(run, state)
            torch.cuda.synchronize()
            results.append((state, dict(kernels.LAUNCHES), blocks))
    (e_state, e_launch, _), (g_state, g_launch, blocks) = results
    assert without_cond_set(e_launch) == without_cond_set(g_launch)
    conds = replayed_conds(blocks)
    assert g_launch["cond_set"] == conds > 0 and e_launch["cond_set"] == 0
    assert any(b.nodes["conditional"] for b in blocks)
    for k in CHUNK_FIELDS:
        assert torch.equal(getattr(g_state, k), getattr(e_state, k)), k


def test_conditional_body_allocates_only_from_the_graph_pool(card):
    """Every allocation that capturing a rebuild with its conditional node
    makes (the main stream's and the body's, on its own stream) lies in
    the graph's private pool, but the block's own buffers (its carry, its
    step, its bodies' counters), and 100 replays change no memory
    statistic."""
    p = resolve_params(pt.SimParams(**GRAPH_SCENE).validate())
    block = toggled_rebuild(p)
    carry = {**rebuild_carry(p, card, far=True), "ok": torch.zeros((), dtype=torch.bool,
                                                                   device=card)}
    block(carry, step_tensor(0, card))
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=200_000)
    try:
        graph = t_chunk.CapturedBlock(block, carry)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    pool = tuple(graph.graph.pool())
    own = {t.data_ptr() for t in graph.carry.values()} | {graph.step.data_ptr(),
                                                           graph.counters.data_ptr()}
    segments = [(s["address"], s["address"] + s["total_size"], tuple(s["segment_pool_id"]))
                for s in snap["segments"]]
    trace = snap["device_traces"][card.index if card.index is not None else 0]
    allocs = [e for e in trace if e["action"] == "alloc" and e["addr"] not in own]
    assert allocs
    for e in allocs:
        (seg_pool,) = [sp for lo, hi, sp in segments if lo <= e["addr"] < hi]
        assert seg_pool == pool, e
    assert len({e["stream"] for e in allocs}) >= 2  # the body allocated on its stream
    keys = ("allocated_bytes.all.current", "reserved_bytes.all.current", "segment.all.current")
    graph(carry, 0)
    torch.cuda.synchronize()
    before = {k: torch.cuda.memory_stats()[k] for k in keys}
    for i in range(100):
        carry["ok"].fill_(i % 2 == 0)
        graph(carry, 0)
    torch.cuda.synchronize()
    assert {k: torch.cuda.memory_stats()[k] for k in keys} == before


class PoolCheckedBlock(t_chunk.CapturedBlock):
    """``chunk.CapturedBlock`` whose capture records the allocator's
    trace: ``allocs`` lists (address, stream, the address's pool) of every
    allocation it made but the block's own buffers."""

    made: list = []

    def __init__(self, block, carry):
        torch.cuda.synchronize()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000)
        try:
            dev = next(iter(carry.values())).device
            index = dev.index if dev.index is not None else 0
            first = len(torch.cuda.memory._snapshot()["device_traces"][index])
            super().__init__(block, carry)
            snap = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        own = {t.data_ptr() for t in self.carry.values()} | {self.step.data_ptr(),
                                                             self.counters.data_ptr()}
        segments = [(s["address"], s["address"] + s["total_size"], tuple(s["segment_pool_id"]))
                    for s in snap["segments"]]
        self.allocs = [
            (e["addr"], e["stream"],
             [sp for lo, hi, sp in segments if lo <= e["addr"] < hi][0])
            for e in snap["device_traces"][index][first:]
            if e["action"] == "alloc" and e["addr"] not in own
        ]
        PoolCheckedBlock.made.append(self)


def test_nested_bodies_allocate_only_from_the_graph_pool(card, monkeypatch):
    """A span runner's segment graphs, whose redo body holds the rebuilds'
    conditional nodes (bodies two deep, each depth captured on its own
    stream): every allocation their captures made lies in the graph's
    private pool, on at least three streams."""
    PoolCheckedBlock.made = []
    monkeypatch.setattr(t_chunk, "CapturedBlock", PoolCheckedBlock)
    p = pt.SimParams(**SPAN_SCENE).validate()
    run = make_run_chunk_table(p)
    state = run(pt.Simulation(p, device=card).state, 3 * gate_seg(p), True)
    torch.cuda.synchronize()
    segments = [b for b in PoolCheckedBlock.made if b.counted]
    assert len(segments) == 2 and bool(torch.isfinite(state.pos).all())
    for b in segments:
        pool = tuple(b.graph.pool())
        assert b.allocs and all(sp == pool for _, _, sp in b.allocs), b.allocs[:4]
        assert len({stream for _, stream, _ in b.allocs}) >= 3
        assert b.nodes["conditional"] == 2 and b.nodes["body_nodes"] > b.nodes["nodes"]
