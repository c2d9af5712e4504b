"""PyTorch port, the two kernel-backed table ops against the JAX kernels.

On the CPU the port's ``stencil_forces`` and ``compact`` take their plain
PyTorch twins; the JAX side runs its Pallas kernels in interpret mode, as
the JAX package's own tests do.  Inputs are real tables built by the JAX
``enter_table`` from a numpy-jittered 300-bot HEX swarm (G=16).

Tolerances: the stencil twin gathers all 9 neighbour cells per target
while the JAX kernel adds Newton reactions for half of them, so the same
pair terms are summed in another order — rtol 1e-5 with atol 1e-5 x
max|f| per output.  The compaction only moves data: elementwise equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch import kernels
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch.ops import megakernel as t_mk
from particlerobotsimulations_torch.ops import pallas_stencil as t_ps
from particlerobotsimulations_torch.ops import table_rebuild as t_tr
from particlerobotsimulations_torch.state import state_from_arrays
from particlerobotsimulations_tpu import engine_table as j_et
from particlerobotsimulations_tpu.ops import pallas_stencil as j_ps
from particlerobotsimulations_tpu.ops import table_rebuild as j_tr

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

STATE_KEYS = (
    "pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r",
    "centroid_ring", "step",
)


def params_pair(**kw):
    base = dict(
        n_cells=300, n_dead=0, seed=3, config=pj.Config.HEX,
        force_backend=pj.ForceBackend.PALLAS, phase_std=0.0, light_x=-5.0,
    )
    base.update(kw)
    jp = pj.SimParams(**base).validate()
    tp = pt.SimParams(
        **{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    ).validate()
    return jp, tp


def jittered_state(jp, seed=99, scale=1e-4, vel_scale=0.05):
    """JAX state of a fresh scene, positions jittered (breaks the HEX
    lattice's exact tangencies) and velocities randomized, from numpy."""
    st = pj.Simulation(jp).state
    rng = np.random.default_rng(seed)
    n = jp.n_cells
    pos = np.asarray(st.pos).copy()
    vel = np.zeros_like(pos)
    pos[:n] += (scale * rng.standard_normal((n, 2))).astype(np.float32)
    vel[:n] = (vel_scale * rng.standard_normal((n, 2))).astype(np.float32)
    return st._replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))


def arrays_of(st):
    return {k: np.asarray(jax.device_get(getattr(st, k))) for k in STATE_KEYS}


def build_scene(kind):
    if kind == "payload":
        jp, tp = params_pair(
            n_cells=201, n_dead=-1, config=pj.Config.RANDOM,
            attraction_factor=2.0, seed=5,
        )
    else:
        jp, tp = params_pair()
    st = jittered_state(jp)
    jts = jax.jit(lambda s: j_et.enter_table(jp, s))(st)
    return jp, tp, st, jts


@pytest.fixture(scope="module")
def scenes():
    return {}


@pytest.fixture(params=["plain", "payload"])
def scene(request, scenes):
    if request.param not in scenes:
        scenes[request.param] = build_scene(request.param)
    return scenes[request.param]


@pytest.fixture
def plain_scene(scenes):
    if "plain" not in scenes:
        scenes["plain"] = build_scene("plain")
    return scenes["plain"]


def test_enter_table_matches_jax(scene):
    jp, tp, st, jts = scene
    tts = t_et.enter_table(tp, state_from_arrays(tp, arrays_of(st), "cpu"))
    np.testing.assert_array_equal(tts.origin.numpy(), np.asarray(jts.origin))
    for k in t_et.TABLE_FIELDS:
        np.testing.assert_array_equal(
            tts.fields[k].numpy(), np.asarray(jts.fields[k]), err_msg=k
        )
    back = t_et.exit_table(tp, tts)
    np.testing.assert_array_equal(back.pos.numpy(), np.asarray(st.pos))


def test_stencil_twin_matches_jax_kernel(scene):
    jp, tp, _, jts = scene
    g, cap = jp.resolved_grid_dim(), jp.cell_capacity
    tables_j = {
        k: jts.fields[k][: cap * g * g].reshape(cap, g * g)
        for k in j_ps.FIELDS
    }
    want = j_ps._stencil_forces_pallas(jp, tables_j, True)
    tables_t = {k: torch.tensor(np.asarray(v)) for k, v in tables_j.items()}
    before = dict(kernels.LAUNCHES)
    got = t_ps.stencil_forces(tp, tables_t)
    assert kernels.LAUNCHES == before  # the CPU path never counts a launch
    for name, a, b in zip(("fx", "fy", "fa", "fr"), got, want):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0, name
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-5, atol=1e-5 * scale, err_msg=name
        )


def move_planes(jp, jts, kick_rows=40, seed=0):
    """(nf + 2, Cs, G*G) compaction input from a real table: some occupied
    rows get displaced up to one cell, then the JAX move planes."""
    g, cs = jp.resolved_grid_dim(), jp.storage_capacity()
    total = g * g * cs
    f = {k: np.asarray(v).copy() for k, v in jts.fields.items()}
    occ = np.flatnonzero(f["val"][:total] > 0.5)
    rng = np.random.default_rng(seed)
    pick = rng.choice(occ, kick_rows, replace=False)
    h = jp.cutoff()
    f["px"][pick] += rng.uniform(-0.9, 0.9, kick_rows).astype(np.float32) * h
    f["py"][pick] += rng.uniform(-0.9, 0.9, kick_rows).astype(np.float32) * h
    planes = jnp.stack(
        [jnp.asarray(f[k][:total]) for k in j_et.MOVE_FIELDS]
    ).reshape(len(j_et.MOVE_FIELDS), cs, g * g)
    dxf, dyf, far, edge = j_tr.rebuild_move_planes(
        jp, planes, j_et.MOVE_FIELDS, jts.origin
    )
    assert not bool(far) and not bool(edge)
    return jnp.concatenate([planes, dxf[None], dyf[None]], axis=0)


def overflow_planes(jp, seed=1):
    """A synthetic stack in which every row of the 3x3 lanes around one
    target moves into it (that cell overflows) and other rows move by
    random offsets."""
    g, cs = jp.resolved_grid_dim(), jp.storage_capacity()
    gg = g * g
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((9, cs, gg)).astype(np.float32)
    occ = rng.random((cs, gg)) < 0.5
    mv = rng.integers(-1, 2, (2, cs, gg)).astype(np.float32)
    target = 8 * g + 8
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            occ[:, target + oy * g + ox] = True
            mv[0, :, target + oy * g + ox] = -ox
            mv[1, :, target + oy * g + ox] = -oy
    data[5] = occ
    dx = np.where(occ, mv[0], 99.0).astype(np.float32)
    dy = np.where(occ, mv[1], 99.0).astype(np.float32)
    return jnp.asarray(np.concatenate([data, dx[None], dy[None]]))


@pytest.mark.parametrize("case", ["movers", "overflow"])
def test_compact_twin_equals_jax_kernel(plain_scene, case):
    jp, tp, _, jts = plain_scene
    planes = move_planes(jp, jts) if case == "movers" else overflow_planes(jp)
    want_out, want_cnt = j_tr._compact(jp, 9, 5, planes)
    got_out, got_cnt = t_tr.compact(tp, torch.tensor(np.asarray(planes)))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert (got_out.numpy() == np.asarray(want_out)).all()
    cap = jp.storage_capacity()
    over = bool((np.asarray(want_cnt) > cap).any())
    assert over == (case == "overflow")
    # every matched row is counted once: the counts add up to the occupancy
    val = np.asarray(planes[5]) > 0.5
    assert int(got_cnt.sum()) == int(val.sum())


@pytest.mark.parametrize("far", [False, True])
def test_incremental_rebuild_ok_and_fields(scene, far):
    jp, tp, _, jts = scene
    total = j_et._geometry(jp)[0]
    f = dict(jts.fields)
    if far:
        # teleport one occupied row 3 cells away -> both must refuse
        occ = int(np.argmax(np.asarray(f["val"][:total]) > 0.5))
        f["px"] = f["px"].at[occ].add(3.0 * jp.cutoff())
    want, ok_j = j_tr.incremental_rebuild(jp, f, j_et.MOVE_FIELDS, jts.origin)
    ft = {k: torch.tensor(np.asarray(v)) for k, v in f.items()}
    got, ok_t = t_tr.incremental_rebuild(
        tp, ft, t_et.MOVE_FIELDS, torch.tensor(np.asarray(jts.origin))
    )
    assert bool(ok_t) == bool(ok_j) == (not far)
    if not far:
        for k in t_et.MOVE_FIELDS:
            assert (got[k].numpy() == np.asarray(want[k])).all(), k


def test_wrappers_refuse_cpu_tensors():
    _, tp = params_pair()
    g, cap = tp.resolved_grid_dim(), tp.cell_capacity
    tables = {
        k: torch.zeros((cap, g * g)) for k in ("px", "py", "vx", "vy", "rad")
    }
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stencil_forces_cuda(tp, tables)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_cuda(tp, torch.zeros((11, cap, g * g)))
    with pytest.raises(ValueError, match="unsupported device"):
        t_ps.stencil_forces(tp, {k: v.to("meta") for k, v in tables.items()})
    n_pad = t_et._geometry(tp)[2]
    tbl = torch.zeros((t_et.N_TF, cap, g * g))
    strip = torch.zeros((t_et.N_TF, n_pad // 128, 128))
    with pytest.raises(ValueError, match="unsupported device"):
        t_mk.make_mega_span(tp, n_pad)(tbl.to("meta"), strip.to("meta"), 1)


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edit to a shared header must name a new library, or a stale one
    would be reused."""
    for src in kernels.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.library_path()
    header = tmp_path / "pair_math.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = kernels.library_path()
    assert after != before and after.parent == before.parent
    (tmp_path / "notes.txt").write_text("not a source")
    assert kernels.library_path() == after


def test_mega_constants_order():
    """kernel 3's and the row step's constants: the pair law first, then
    dt — as MegaConsts in csrc/row_step.cuh lays them out."""
    _, tp = params_pair(constrained_contraction=1)
    c = kernels.mega_constants(tp)
    src = (kernels.CSRC / "row_step.cuh").read_text()
    body = src[src.index("struct MegaConsts {"):src.index("};", src.index("struct MegaConsts {"))]
    decl = body.split("PairConsts pair;")[1]
    names = [
        n.strip() for line in decl.splitlines()
        for n in line.split("//")[0].replace("float", "").replace(";", "").split(",")
        if n.strip()
    ]
    assert len(c) == len(t_ps.pair_constants(tp)) + len(names)
    assert c[: len(t_ps.pair_constants(tp))] == t_ps.pair_constants(tp)
    got = dict(zip(names, c[len(t_ps.pair_constants(tp)):]))
    assert got["dt"] == float(np.float32(tp.timestep))
    assert got["constrained"] == 1.0 and got["cc"] == float(np.float32(tp.constraint_contraction))
    assert got["inv_mass_factor"] == float(np.float32(1.0 / tp.mass_factor))
    assert got["half"] == float(np.float32(tp.world_half))


def _eligible_shapes():
    """Every (G, C, payload, n_pad) that passes validation and
    ``mega_eligible``: G a multiple of 16 with G*G*C <= 4096, no spill
    rows, the largest swarm whose strip fits."""
    shapes = []
    for g in (16, 32, 48, 64, 80):
        for cap in range(1, 33):
            for payload in (False, True):
                p = pt.SimParams(
                    n_cells=1000, n_dead=-1 if payload else 0, grid_dim=g,
                    cell_capacity=cap, force_backend=pt.ForceBackend.PALLAS,
                ).validate()
                if t_mk.mega_eligible(p):
                    shapes.append((g, cap, payload, t_et._geometry(p)[2]))
    return shapes


def test_mega_plan_covers_every_eligible_shape():
    """Kernel 3's cluster plan launches every shape the span path takes:
    a cluster of N > 1 CTAs with N dividing G, the CTAs' rows adding up to
    the table, and shared memory within a CTA's 227 KB."""
    shapes = _eligible_shapes()
    assert {(g, cap) for g, cap, _, _ in shapes} == (
        {(16, c) for c in range(1, 17)} | {(32, c) for c in range(1, 5)}
        | {(48, 1), (64, 1)}
    )
    for g, cap, payload, n_pad in shapes:
        plan = kernels.mega_plan(cap, g, n_pad, payload)
        n = plan["cluster"]
        assert 1 < n <= kernels.MEGA_MAX_CLUSTER and g % n == 0, (g, cap)
        assert plan["grid_rows"] * n == g
        assert plan["rows"] * n == cap * g * g
        assert plan["smem"] + kernels.MEGA_STATIC_SMEM <= kernels.SMEM_PER_BLOCK
    band = kernels.mega_plan(16, 16, 1024, False)
    assert (band["cluster"], band["rows"]) == (16, 256)


@pytest.mark.parametrize("g,cap,n", [(8, 32, 8), (12, 28, 12), (13, 4, 13), (17, 1, 1), (18, 12, 9)])
def test_mega_plan_other_sides(g, cap, n):
    """Sides the config does not produce (not multiples of 16) still plan:
    N the largest divisor of G up to 16, a prime G above 16 on one CTA."""
    plan = kernels.mega_plan(cap, g, 4096, True)
    assert plan["cluster"] == n and plan["rows"] * n == cap * g * g
    assert plan["smem"] + kernels.MEGA_STATIC_SMEM <= kernels.SMEM_PER_BLOCK


@pytest.mark.parametrize("cap,g,n_strip,why", [
    (33, 8, 128, "outside"),        # more slots than a 32-bit mask
    (17, 16, 128, "4096"),          # 4352 table rows
    (16, 16, 4224, "4096"),         # a strip beyond 4096 rows
    (14, 17, 128, "shared memory"), # one CTA for 4046 rows: too big
])
def test_mega_plan_refusals(cap, g, n_strip, why):
    with pytest.raises(ValueError, match=why):
        kernels.mega_plan(cap, g, n_strip, False)


@pytest.mark.parametrize("n_cells,shards,g", [(10_000, 1, 48), (10_000, 4, 64), (100_000, 1, 160)])
def test_stencil_plan_tables(n_cells, shards, g):
    """Kernel 1's tiles on the 10k table, the sharded 10k table and the
    100k table: one block per 2x2 tile, shared memory within 227 KB, at
    the configs' own G and at 32, 33, 48 and 64 slots (one and two
    occupancy words per cell); refused only past a block's shared memory."""
    p = pt.SimParams(n_cells=n_cells, n_dead=0).validate()
    if shards == 1:
        assert p.resolved_grid_dim() == g
    for cap in (p.cell_capacity, 32, 33, 48, 64):
        for payload in (False, True):
            plan = kernels.stencil_plan(cap, g, payload)
            assert plan["blocks"] == (g // 2) ** 2
            assert plan["smem"] <= kernels.SMEM_PER_BLOCK
    assert kernels.stencil_plan(16, 48, False) == {"blocks": 576, "smem": 75_032}
    with pytest.raises(ValueError, match="SMEM_PER_BLOCK"):
        kernels.stencil_plan(145, g, False)


def test_plan_constants_match_sources():
    """The Python plans use the geometry the CUDA sources compile in."""
    import re

    def consts(name):
        src = (kernels.CSRC / name).read_text()
        return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}

    k1, k3 = consts("stencil_forces.cu"), consts("mega_span.cu")
    assert (k1["kTile"], k1["kThreads"], k1["kTermCap"], k1["kMaskBits"],
            k1["kSmemPerBlock"]) == (
        kernels.STENCIL_TILE, kernels.STENCIL_THREADS, kernels.STENCIL_TERM_CAP,
        kernels.MASK_BITS, kernels.SMEM_PER_BLOCK)
    k2 = consts("compact.cu")
    assert (k2["kLanes"], k2["kWindow"]) == (kernels.COMPACT_LANES, kernels.COMPACT_WINDOW)
    assert "constexpr int kThreads = kWindow * kLanes;" in (kernels.CSRC / "compact.cu").read_text()
    assert kernels.COMPACT_THREADS == kernels.COMPACT_WINDOW * kernels.COMPACT_LANES
    assert (k3["kThreads"], k3["kTermCap"], k3["kMaxCluster"], k3["kMaxCap"],
            k3["kMaxRows"]) == (kernels.MEGA_THREADS, kernels.MEGA_TERM_CAP,
                                kernels.MEGA_MAX_CLUSTER, kernels.MASK_BITS,
                                kernels.MEGA_MAX_ROWS)
    assert k3["kSmemPerBlock"] == kernels.SMEM_PER_BLOCK
    assert kernels.MEGA_MAX_ROWS == t_mk.MAX_ROWS


@pytest.mark.parametrize("n_cells,g,spill", [
    (1_000, 32, 0), (10_000, 64, 0), (100_000, 160, 0), (100_000, 160, 8),
])
def test_sharded_plans(n_cells, g, spill):
    """Kernels 4 and 2 (padded) on every sharded shape resolve_tp_params
    makes over 4 shards: one 2x2 tile per block across the shards' centre
    rows, the same tiles and shared memory as kernel 1 on the whole table,
    and one block per 16 centre lanes of every shard with Cs in 32-slot
    windows."""
    from particlerobotsimulations_torch.parallel.spatial_table import resolve_tp_params

    p = resolve_tp_params(pt.SimParams(n_cells=n_cells, n_dead=0, overflow_slots=spill), 4)
    assert p.resolved_grid_dim() == g
    cap, cs, l0 = p.cell_capacity, p.storage_capacity(), g * g // 4
    rows = l0 // g
    for payload in (False, True):
        plan = kernels.stencil_plan(cap, g, payload, rows, 4)
        whole = kernels.stencil_plan(cap, g, payload)
        assert plan == {"blocks": (g // 2) * (rows // 2) * 4, "smem": whole["smem"]}
        assert plan["blocks"] == whole["blocks"]  # rows even: the same tiles
        assert plan["smem"] <= kernels.SMEM_PER_BLOCK
    assert kernels.compact_plan(cs, l0, 4) == {
        "blocks": l0 // kernels.COMPACT_LANES * 4, "threads": kernels.COMPACT_THREADS,
        "windows": 1}
    assert cs == 16 + spill


@pytest.mark.parametrize("g,rows,shards,blocks", [
    (32, 3, 4, 16 * 2 * 4),   # an odd number of rows per shard: a partial tile each
    (33, 5, 2, 17 * 3 * 2),   # an odd side and odd rows
    (30, 15, 1, 15 * 8),      # one shard of odd rows
    (1, 1, 3, 3),             # one cell per shard
])
def test_stencil_plan_partial_tiles(g, rows, shards, blocks):
    """Kernel 4's tiles cover a shard's centre rows with partial tiles
    where rows or G are odd, as kernel 1 covers an odd G."""
    assert kernels.stencil_plan(16, g, False, rows, shards)["blocks"] == blocks
    assert kernels.stencil_plan(16, g, False, rows, shards)["smem"] == (
        kernels.stencil_plan(16, g, False)["smem"])


def test_stencil_ext_plan_refuses_cap_33():
    """Kernel 4 takes kernel 1's plans: 33 slots (refused while a cell's
    occupancy was one 32-bit word) plan as on the whole table; the plan
    refuses only past a block's shared memory, with kernel 1's message,
    and shapes below 1."""
    assert kernels.stencil_plan(33, 64, False, 16, 4) == {
        "blocks": 32 * 8 * 4, "smem": kernels.stencil_plan(33, 64, False)["smem"]}
    with pytest.raises(ValueError, match="SMEM_PER_BLOCK"):
        kernels.stencil_plan(145, 64, False, 16, 4)
    with pytest.raises(ValueError, match="shards 0"):
        kernels.stencil_plan(16, 64, False, 16, 0)


def _stencil_smem(cap: int, payload: bool) -> int:
    """Kernel 1's shared memory, laid out as stencil_tile lays it out:
    terms, planes, sums, masks (ceil(C / 32) words per region cell),
    lanes, cell bases, target cells / slots / term bases, reach words (9
    per target and word), warp totals."""
    cells, max_t, nw = 16, 4 * cap, -(-cap // 32)
    words = ((6 if payload else 5) * cap * cells + 4 * max_t + nw * cells + cells
             + 5 + 2 * max_t + max_t + 1 + 9 * max_t * nw + 32)
    return 16 * 4096 + 4 * words


@pytest.mark.parametrize("cap,payload,fits", [
    (32, False, True), (33, False, True), (48, False, True), (64, False, True),
    (64, True, True), (144, False, True), (145, False, False),
    (136, True, True), (137, True, False),
])
def test_stencil_plan_mask_words(cap, payload, fits):
    """Kernels 1 and 4 past 32 slots: ceil(C / 32) occupancy words per
    cell and 9 reach words per target and word; the plan takes every C
    whose shared memory fits a block and refuses the first that does not,
    naming the limit."""
    if not fits:
        assert _stencil_smem(cap, payload) > kernels.SMEM_PER_BLOCK
        with pytest.raises(ValueError, match="SMEM_PER_BLOCK"):
            kernels.stencil_plan(cap, 48, payload)
        return
    plan = kernels.stencil_plan(cap, 48, payload)
    assert plan == {"blocks": 576, "smem": _stencil_smem(cap, payload)}
    assert plan["smem"] <= kernels.SMEM_PER_BLOCK and 9 * cap <= kernels.STENCIL_TERM_CAP
    assert kernels.stencil_plan(cap, 64, payload, 16, 4)["smem"] == plan["smem"]


@pytest.mark.parametrize("out_lanes,shards", [(48 * 48, 1), (16 * 16, 1), (1024, 4), (100, 3)])
def test_compact_plan_takes_any_storage_capacity(out_lanes, shards):
    """Kernel 2 refuses no Cs up to 64: cell_capacity plus spill slots may
    pass 32 (32 + 8 = 40); the slots go in ceil(Cs / 32) windows of one
    mask word."""
    for cs in range(1, 65):
        plan = kernels.compact_plan(cs, out_lanes, shards)
        assert plan["windows"] == -(-cs // 32)
        assert plan["blocks"] == -(-out_lanes // kernels.COMPACT_LANES) * shards
        assert plan["threads"] == kernels.COMPACT_THREADS


def test_compact_plan_refusals():
    for args in ((0, 256, 1), (16, 0, 1), (16, 256, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            kernels.compact_plan(*args)
