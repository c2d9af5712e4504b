"""PyTorch port, the sharded table loop against the JAX package.

The port's ``parallel/spatial_table.py`` splits the table's grid rows over a
ring of shards (``LocalRing``: all shards in one process; ``DistRing``: one
per ``torch.distributed`` rank).  On the CPU its two kernels take their
plain twins, held here against the JAX kernels in interpret mode (kernel 4,
``stencil_forces_pallas_ext``; kernel 2's padded form, ``compact_padded``),
and the whole loop against the JAX ``make_sharded_table_run`` on a 4-device
mesh of the conftest's virtual CPU devices and against the port's own
single-table loop.

Tolerances: kernel 4's twin sums the same pair terms as the JAX kernel in
another order, so kernel 1's form (atol 1e-4, rtol 1e-5, plus 1e-5 x
(fa + fr) on fx and fy, whose terms cancel).  The compaction only moves
data: elementwise equal.  The loops over 12 steps: positions 1e-5,
velocities 1e-4 (the JAX tests' tolerances); 1e-3 on velocities under
50 u/s bulk motion, which amplifies the summation-order seeds faster.
Per-bot comparisons with JAX run at ``phase_std=0, n_dead=0``: the two
packages draw from different streams.  ``DistRing`` over two gloo
processes and ``LocalRing(2)`` do the same arithmetic in the same order
(a two-shard sum commutes exactly): elementwise equal.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch import kernels
from particlerobotsimulations_torch import state as t_state
from particlerobotsimulations_torch.ops import pallas_stencil as t_ps
from particlerobotsimulations_torch.ops import table_rebuild as t_tr
from particlerobotsimulations_torch.parallel import spatial_table as t_st
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
from particlerobotsimulations_tpu import engine_table as j_et
from particlerobotsimulations_tpu.ops import pallas_stencil as j_ps
from particlerobotsimulations_tpu.ops import table_rebuild as j_tr
from particlerobotsimulations_tpu.parallel import spatial_table as j_st

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 4


def params_pair(n_shards=D, **kw):
    """(JAX params, port params), both resolved for ``n_shards`` shards."""
    base = dict(
        n_cells=200, n_dead=0, seed=3, config=pj.Config.HEX,
        force_backend=pj.ForceBackend.PALLAS, phase_std=0.0, light_x=-5.0,
    )
    base.update(kw)
    jp = j_st.resolve_tp_params(pj.SimParams(**base), n_shards)
    tp = pt.SimParams(
        **{f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    ).validate()
    return jp, tp


def start_arrays(tp, seed=99, jitter=1e-4, vel=None, vel_scale=0.0):
    """Bot-order arrays of a fresh scene: positions jittered (the HEX
    lattice's tangencies broken), velocities ``vel`` for every bot plus
    ``vel_scale`` noise, from numpy."""
    a = state_to_arrays(pt.Simulation(tp, device="cpu").state)
    n = tp.n_cells
    rng = np.random.default_rng(seed)
    a["pos"][:n] += (jitter * rng.standard_normal((n, 2))).astype(np.float32)
    if vel is not None:
        a["vel"][:n] = np.asarray(vel, np.float32)
    a["vel"][:n] += (vel_scale * rng.standard_normal((n, 2))).astype(np.float32)
    return a


def jax_state(jp, arrays):
    st = pj.Simulation(jp).state
    return st._replace(**{
        k: jnp.asarray(arrays[k]) for k in ("pos", "vel", "rad", "phase", "dead")
    })


def shard_ext(x, n_shards, g):
    """(..., G*G) global lanes -> (S, ..., L0 + 2H) halo-extended shard
    blocks, laid out as the JAX ``halo_exchange`` lays them out: 3 zero
    rows, the previous shard's last grid row, the block, the next shard's
    first grid row, 3 zero rows."""
    l0 = x.shape[-1] // n_shards
    blocks = [x[..., d * l0:(d + 1) * l0] for d in range(n_shards)]
    z = np.zeros(x.shape[:-1] + ((t_st.HALO_ROWS - 1) * g,), np.float32)
    return np.stack([
        np.concatenate(
            [z, blocks[d - 1][..., -g:], blocks[d], blocks[(d + 1) % n_shards][..., :g], z],
            axis=-1,
        )
        for d in range(n_shards)
    ])


@pytest.fixture(scope="module")
def scene():
    """200 jittered HEX bots with random velocities, entered into the
    table: (jp, tp, port table fields as numpy, origin).  Entry anchors the
    blob in grid rows 1-5, all in shard 0; the table is rolled by 6 grid
    rows (and the origin moved with it) so that the blob straddles the
    boundary of shards 0 and 1."""
    jp, tp = params_pair()
    g, cs = jp.resolved_grid_dim(), jp.storage_capacity()
    assert (g, cs) == (32, 16)
    ts = t_et.enter_table(
        tp, state_from_arrays(tp, start_arrays(tp, vel_scale=0.05), "cpu")
    )
    total = cs * g * g
    fields = {}
    for k, v in ts.fields.items():
        v = v.numpy().copy()
        v[:total] = np.roll(v[:total].reshape(cs, g * g), 6 * g, axis=1).reshape(-1)
        fields[k] = v
    origin = ts.origin.numpy().copy()
    origin[1] -= np.float32(6 * tp.cutoff())
    rows = fields["val"][:total].reshape(cs, g, g).sum(axis=(0, 2))
    assert rows[7] > 0 and rows[8] > 0
    return jp, tp, fields, origin


def test_stencil_ext_twin_matches_jax_kernel(scene):
    jp, tp, fields, _ = scene
    g, cap = jp.resolved_grid_dim(), jp.cell_capacity
    l0, h = g * g // D, t_st.HALO_ROWS * g
    ext = {
        k: shard_ext(fields[k][: cap * g * g].reshape(cap, g * g), D, g)
        for k in t_ps.FIELDS
    }
    assert (l0, h, ext["px"].shape[-1]) == (256, 128, 512)
    got = t_ps.stencil_forces_ext(tp, {k: torch.tensor(v) for k, v in ext.items()}, h, l0)
    for d in range(D):
        want = j_ps.stencil_forces_pallas_ext(
            jp, {k: jnp.asarray(v[d]) for k, v in ext.items()}, h, l0
        )
        want = [np.asarray(w) for w in want]
        summed = want[2] + want[3]
        for i, name in enumerate(("fx", "fy", "fa", "fr")):
            a, b = got[i][d].numpy(), want[i]
            tol = 1e-4 + 1e-5 * np.abs(b) + (1e-5 * summed if i < 2 else 0.0)
            assert (np.abs(a - b) <= tol).all(), (name, d, float(np.abs(a - b).max()))
    for d in (0, 1):
        assert float(got[2][d].max()) > 0 and float(got[3][d].max()) > 0


def test_stencil_ext_twin_equals_kernel1_twin_on_whole_table(scene):
    """On one shard holding the whole table, with the table's own wrapped
    rows as the halo, the extended twin is kernel 1's twin (same pair set:
    every table row is occupied iff rad > 0 iff val)."""
    _, tp, fields, _ = scene
    g, cap = tp.resolved_grid_dim(), tp.cell_capacity
    tables = {
        k: torch.tensor(fields[k][: cap * g * g].reshape(cap, g * g)) for k in t_ps.FIELDS
    }
    h = t_st.HALO_ROWS * g
    ext = {k: torch.cat([v[:, -h:], v, v[:, :h]], dim=1) for k, v in tables.items()}
    got = t_ps.stencil_forces_ext(tp, ext, h, g * g)
    want = t_ps.stencil_forces_plain(tp, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def moved_planes(tp, fields, origin, kick_rows=60, seed=0):
    """(nf + 2, Cs, G*G) global compaction input from the real table: rows
    of the shards' boundary grid rows and random others displaced up to one
    cell, then the port's move planes."""
    g, cs = tp.resolved_grid_dim(), tp.storage_capacity()
    total = g * g * cs
    f = {k: v.copy() for k, v in fields.items()}
    occ = np.flatnonzero(f["val"][:total] > 0.5)
    rng = np.random.default_rng(seed)
    pick = rng.choice(occ, kick_rows, replace=False)
    h = tp.cutoff()
    f["px"][pick] += rng.uniform(-0.9, 0.9, kick_rows).astype(np.float32) * h
    f["py"][pick] += rng.uniform(-0.9, 0.9, kick_rows).astype(np.float32) * h
    planes = torch.tensor(
        np.stack([f[k][:total] for k in t_state.MOVE_FIELDS]).reshape(-1, cs, g * g)
    )
    dxf, dyf, far, edge = t_tr.rebuild_move_planes(
        tp, planes, t_state.MOVE_FIELDS, torch.tensor(origin)
    )
    assert not bool(far) and not bool(edge)
    return torch.cat([planes, dxf[None], dyf[None]]).numpy()


def overflow_planes(tp, seed=1):
    """A synthetic stack with random moves, and every row of the 3x3 lanes
    around a lane in shard 1's first grid row moving into it (it
    overflows, fed from shard 0 across the boundary)."""
    g, cs = tp.resolved_grid_dim(), tp.storage_capacity()
    gg = g * g
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((9, cs, gg)).astype(np.float32)
    occ = rng.random((cs, gg)) < 0.5
    mv = rng.integers(-1, 2, (2, cs, gg)).astype(np.float32)
    target = gg // D + 8
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            occ[:, target + oy * g + ox] = True
            mv[0, :, target + oy * g + ox] = -ox
            mv[1, :, target + oy * g + ox] = -oy
    data[5] = occ
    dx = np.where(occ, mv[0], 99.0).astype(np.float32)
    dy = np.where(occ, mv[1], 99.0).astype(np.float32)
    return np.concatenate([data, dx[None], dy[None]])


@pytest.mark.parametrize("case", ["movers", "overflow"])
def test_compact_padded_twin_equals_jax_kernel(scene, case):
    jp, tp, fields, origin = scene
    g, cs = tp.resolved_grid_dim(), tp.storage_capacity()
    l0, h = g * g // D, t_st.HALO_ROWS * g
    planes = (
        moved_planes(tp, fields, origin) if case == "movers" else overflow_planes(tp)
    )
    padded = shard_ext(planes, D, g)          # (D, 11, Cs, L0 + 2H)
    # rows in the halo rows that land in the centre: they cross a boundary
    dx, dy = padded[:, 9], padded[:, 10]
    lanes = np.arange(padded.shape[-1])
    from_prev = (lanes >= h - g) & (lanes < h)
    from_next = (lanes >= h + l0) & (lanes < h + l0 + g)
    crossing = int((((dy == 1) & from_prev) | ((dy == -1) & from_next)).sum())
    assert crossing > 0
    got_out, got_cnt = t_tr.compact_padded(tp, torch.tensor(padded), h, l0)
    over = False
    for d in range(D):
        want_out, want_cnt = j_tr.compact_padded(jp, 9, 5, jnp.asarray(padded[d]), h, l0)
        np.testing.assert_array_equal(got_cnt[d].numpy(), np.asarray(want_cnt))
        assert (got_out[d].numpy() == np.asarray(want_out)).all(), d
        over |= bool((np.asarray(want_cnt) > cs).any())
    assert over == (case == "overflow")
    if case == "overflow":
        return
    # with the wrapped edge columns empty (the table loop's guard), the
    # sharded compaction is the whole table's compaction, split
    whole_out, whole_cnt = t_tr.compact_plain(tp, torch.tensor(planes))
    np.testing.assert_array_equal(
        got_cnt.numpy().reshape(-1), whole_cnt.numpy()
    )
    split = whole_out.numpy().reshape(9, cs, D, l0).transpose(2, 0, 1, 3)
    assert (got_out.numpy() == split).all()


def test_rebuild_move_planes_lane_offset_equals_jax(scene):
    jp, tp, fields, origin = scene
    g, cs = tp.resolved_grid_dim(), tp.storage_capacity()
    l0 = g * g // D
    planes = moved_planes(tp, fields, origin)[:9].reshape(9, cs, D, l0)
    stack = torch.tensor(planes).permute(0, 2, 1, 3)     # (nf, D, Cs, L0)
    offs = (torch.arange(D, dtype=torch.int32) * l0).view(D, 1, 1)
    got = t_tr.rebuild_move_planes(
        tp, stack, t_state.MOVE_FIELDS, torch.tensor(origin), lane_offset=offs
    )
    for d in range(D):
        want = j_tr.rebuild_move_planes(
            jp, jnp.asarray(planes[:, :, d]), j_et.MOVE_FIELDS, jnp.asarray(origin),
            lane_offset=d * l0,
        )
        one = t_tr.rebuild_move_planes(
            tp, torch.tensor(planes[:, :, d]), t_state.MOVE_FIELDS, torch.tensor(origin),
            lane_offset=d * l0,
        )
        for a, b, c in zip(got[:2], want[:2], one[:2]):
            np.testing.assert_array_equal(a[d].numpy(), np.asarray(b))
            np.testing.assert_array_equal(c.numpy(), np.asarray(b))
        assert bool(one[2]) == bool(want[2]) and bool(one[3]) == bool(want[3])
        # the stack's preconditions, one flag per shard
        assert bool(got[2][d]) == bool(want[2]) and bool(got[3][d]) == bool(want[3])
    assert got[2].shape == got[3].shape == (D,)
    assert not bool(got[2].any()) and not bool(got[3].any())


def test_resolve_tp_params_equals_jax():
    for n in (64, 200, 600, 10_000, 100_000):
        for n_shards in (2, 4, 8):
            jp = j_st.resolve_tp_params(pj.SimParams(n_cells=n), n_shards)
            tp = t_st.resolve_tp_params(pt.SimParams(n_cells=n), n_shards)
            assert tp.grid_dim == jp.grid_dim, (n, n_shards)
    assert t_st.resolve_tp_params(pt.SimParams(n_cells=10_000), 4).grid_dim == 64
    assert t_st.resolve_tp_params(pt.SimParams(n_cells=100_000), 4).grid_dim == 160


def run_port(tp, arrays, n_steps, ring=None, **kw):
    run, p2 = t_st.make_sharded_table_run(
        tp, ring or LocalRing(D, "cpu"), device="cpu", **kw
    )
    assert p2 == tp
    out = run(state_from_arrays(tp, arrays, "cpu"), n_steps)
    if kw.get("with_stats"):
        return state_to_arrays(out[0]), out[1]
    return state_to_arrays(out)


def run_unsharded(tp, arrays, n_steps):
    run = t_et.make_run_chunk_table(tp)
    return state_to_arrays(run(state_from_arrays(tp, arrays, "cpu"), n_steps))


def assert_close(got, want, n, vel_atol=1e-4):
    np.testing.assert_allclose(got["pos"][:n], want["pos"][:n], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["vel"][:n], want["vel"][:n], atol=vel_atol, rtol=0)
    assert int(got["step"]) == int(want["step"])


def test_sharded_loop_matches_jax_and_unsharded():
    """200 jittered bots, 12 steps (3 rebuilds): the port's LocalRing(4)
    against the JAX sharded loop on 4 devices and the port's single-table
    loop."""
    jp, tp = params_pair()
    a = start_arrays(tp)
    mesh = Mesh(np.array(jax.devices()[:D]), ("bots",))
    jrun, jp2 = j_st.make_sharded_table_run(jp, mesh, axis="bots")
    assert jp2 == jp
    want = jrun(jax_state(jp, a), 12)
    want = {k: np.asarray(getattr(want, k)) for k in ("pos", "vel", "rad", "step")}
    got = run_port(tp, a, 12)
    assert_close(got, want, tp.n_cells)
    np.testing.assert_allclose(got["rad"], want["rad"], atol=1e-6, rtol=0)
    assert_close(got, run_unsharded(tp, a, 12), tp.n_cells)


def test_sharded_fallback_matches_unsharded():
    """64 bots at 50 u/s: the incremental rebuild refuses (>1-cell moves)
    and every shard takes the exact global fallback."""
    _, tp = params_pair(n_cells=64)
    a = start_arrays(tp, vel=[50.0, 0.0])
    got, stats = run_port(tp, a, 16, with_stats=True)
    assert stats["fallbacks"] >= 1
    assert_close(got, run_unsharded(tp, a, 16), 64, vel_atol=1e-3)
    assert got["pos"][:64, 0].mean() - a["pos"][:64, 0].mean() > 2.0


def test_sharded_spill_matches_unsharded():
    """600 bots with cell_capacity 8 and 8 spill rows: the HEX blob fills
    the spill rows, which ride the sharded compaction across boundaries."""
    _, tp = params_pair(n_cells=600, cell_capacity=8, overflow_slots=8, light_x=-10.0)
    assert tp.storage_capacity() == 16
    a = start_arrays(tp, vel=[0.0, 2.0])
    got, stats = run_port(tp, a, 12, with_stats=True)
    assert stats["spill_rows_max"] > 0 and stats["fallbacks"] == 0
    assert_close(got, run_unsharded(tp, a, 12), 600)


def test_sharded_dead_injection_and_noise():
    """9 dead after 10 steps and no re-injection after 10 more; with phase
    noise on, the sharded loop draws what the single-table loop draws, so
    the two agree per bot."""
    _, tp = params_pair(n_cells=64, n_dead=9, time_to_dead=0.05, phase_std=0.5)
    a = start_arrays(tp)
    run, _ = t_st.make_sharded_table_run(tp, LocalRing(D, "cpu"))
    out = run(state_from_arrays(tp, a, "cpu"), 10)
    assert int(out.dead[:64].sum()) == 9
    out2 = run(out, 10)
    assert int(out2.dead[:64].sum()) == 9
    got, want = state_to_arrays(out), run_unsharded(tp, a, 10)
    np.testing.assert_array_equal(got["dead"], want["dead"])
    assert_close(got, want, 64)
    np.testing.assert_allclose(got["phase"], want["phase"], atol=1e-4, rtol=0)


DIST_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from particlerobotsimulations_torch.config import SimParams
from particlerobotsimulations_torch.parallel.ring import DistRing
from particlerobotsimulations_torch.parallel.spatial_table import make_sharded_table_run
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
import pickle
init, rank, src, dst = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
with open(src, "rb") as fh:
    params, arrays, n_steps = pickle.load(fh)
run, _ = make_sharded_table_run(params, DistRing(), with_stats=True)
out, stats = run(state_from_arrays(params, arrays, "cpu"), n_steps)
np.savez(dst, fallbacks=stats["fallbacks"], spill=stats["spill_rows_max"], **state_to_arrays(out))
dist.destroy_process_group()
"""


def test_dist_ring_equals_local_ring(tmp_path):
    """Two gloo ranks, one shard each, against LocalRing(2) on the same
    state: 64 bots at 50 u/s (fallbacks: all-gather, argsort), dead
    injection (all-gathered topk) and phase noise, 12 steps."""
    import pickle

    _, tp = params_pair(
        n_shards=2, n_cells=64, n_dead=5, time_to_dead=0.03, phase_std=0.5,
    )
    a = start_arrays(tp, vel=[50.0, 0.0])
    src = tmp_path / "in.pkl"
    with open(src, "wb") as fh:
        pickle.dump((tp, a, 12), fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", DIST_WORKER, init, str(r), str(src),
             str(tmp_path / f"out{r}.npz")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    want, stats = run_port(tp, a, 12, ring=LocalRing(2, "cpu"), with_stats=True)
    assert stats["fallbacks"] >= 1 and int(want["dead"][:64].sum()) == 5
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        assert int(got["fallbacks"]) == stats["fallbacks"]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")


def test_sharded_entry_points_refuse():
    _, tp = params_pair(n_cells=64)
    run, _ = t_st.make_sharded_table_run(tp, LocalRing(D, "cpu"))
    st = pt.Simulation(tp, device="cpu").state
    with pytest.raises(ValueError, match="ring on"):
        run(st.replace(pos=st.pos.to("meta")), 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_st.make_sharded_table_run(tp)
    g = tp.resolved_grid_dim()
    with pytest.raises(ValueError, match="pad"):
        t_tr.compact_padded(tp, torch.zeros((11, 16, g * g + 2 * g)), g, g * g)
    tables = {k: torch.zeros((16, 3 * g * g), device="meta") for k in t_ps.FIELDS}
    with pytest.raises(ValueError, match="unsupported device"):
        t_ps.stencil_forces_ext(tp, tables, g * g, g * g)
    before = dict(kernels.LAUNCHES)
    tables = {k: torch.zeros((16, 3 * g * g)) for k in t_ps.FIELDS}
    t_ps.stencil_forces_ext(tp, tables, g * g, g * g)
    assert kernels.LAUNCHES == before  # the CPU path never counts a launch


# ------------------------------------------------- dp x tp: scene batches


@pytest.fixture
def decisions(monkeypatch):
    """The sharded loops' rebuild decisions, recorded in order as the bool
    tensors the loops select on (0-dim for one scene, one flag per scene
    for a batch).  The CPU loops run every block eagerly, so every rebuild
    calls the hook."""
    seen = []
    real = t_st._all_ok

    def hooked(ring, ok_local):
        ok = real(ring, ok_local)
        seen.append(ok)
        return ok

    monkeypatch.setattr(t_st, "_all_ok", hooked)
    return seen


def batch_arrays(tp, seeds, kick=None):
    """Bot-order arrays of a batch of fresh scenes, positions jittered by
    1e-4 per scene (numpy); ``kick`` = (scene, vx) puts that scene's
    outermost bot at vx."""
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state
    from particlerobotsimulations_torch.state import batch_state_to_arrays

    a = batch_state_to_arrays(make_batch_state(tp, seeds, "cpu"))
    n = tp.n_cells
    rng = np.random.default_rng(99)
    a["pos"][:, :n] += (1e-4 * rng.standard_normal((len(seeds), n, 2))).astype(np.float32)
    if kick is not None:
        b, vx = kick
        edge = int(np.argmax(a["pos"][b, :n, 0]))
        a["vel"][b, edge, 0] = vx
    return a


@pytest.fixture(scope="module")
def jax_dp_tp():
    """JAX's dp x tp table loop for 96 bots on a (2, 2) mesh, built once
    (its interpret-mode compile dominates the cases' time)."""
    jp, _ = params_pair(n_shards=2, n_cells=96)
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "bots"))
    jrun, jp2 = j_st.make_sharded_table_run_batched(jp, jmesh)
    assert jp2 == jp
    return jrun


@pytest.mark.parametrize("case", ["plain", "fallback"])
def test_dp_tp_table_loop_matches_jax_and_lockstep(case, decisions, jax_dp_tp):
    """2 scenes x 2 shards of 96 bots, 10 steps (2 rebuilds), against JAX's
    ``make_sharded_table_run_batched`` on a (2, 2) mesh and, scene by
    scene, bit for bit against the scene alone through the single-scene
    sharded loop, which decides its own rebuilds (no decision replayed).
    ``fallback`` kicks scene 1's outermost bot to 60 u/s: every rebuild
    falls back for scene 1 and for scene 1 only, as in JAX, whose vmapped
    ``lax.cond`` decides per scene.  The ring entry equals the mesh entry
    (one data place per scene) bit for bit in both cases.  The unsharded
    batched table loop decides for all scenes alike (the JAX package's
    ``_smart_rebuild_batched``), so it equals the batch bit for bit in the
    scenes that took its decisions: both scenes in ``plain``, scene 1 in
    ``fallback`` (scene 0, incremental here and exact there, differs only
    in summation order: held at the JAX tolerance)."""
    from particlerobotsimulations_torch.parallel.mesh import Mesh as TorchMesh
    from particlerobotsimulations_torch.state import (
        batch_state_from_arrays,
        batch_state_to_arrays,
        scene_state,
    )
    from particlerobotsimulations_tpu.parallel.sweep import make_batch_state as jax_batch

    seeds = [0, 1]
    fields = ("pos", "vel", "rad", "phase", "dead", "abs_force_a", "abs_force_r")
    jp, tp = params_pair(n_shards=2, n_cells=96)
    a = batch_arrays(tp, seeds, kick=(1, 60.0) if case == "fallback" else None)
    jst = jax_batch(jp, seeds)
    want = jax_dp_tp(jst._replace(**{k: jnp.asarray(a[k]) for k in ("pos", "vel")}), 10)
    want = {k: np.asarray(getattr(want, k)) for k in ("pos", "vel", "rad")}

    run, p2 = t_st.make_sharded_table_run_batched(tp, LocalRing(2, "cpu"), with_stats=True)
    assert p2 == tp
    out, stats = run(batch_state_from_arrays(tp, a, "cpu"), 10)
    seen = [d.tolist() for d in decisions]
    assert all(d.dtype == torch.bool and d.shape == (2,) for d in decisions)
    want_ok = [True, False] if case == "fallback" else [True, True]
    assert seen == [want_ok] * 2
    assert stats["fallbacks"] == sum(d.count(False) for d in seen)
    got = batch_state_to_arrays(out)
    for b in range(2):
        np.testing.assert_allclose(got["pos"][b], want["pos"][b], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["vel"][b], want["vel"][b], atol=1e-4, rtol=0)
    single, _ = t_st.make_sharded_table_run(tp, LocalRing(2, "cpu"), with_stats=True)
    for b in range(2):
        decisions.clear()
        one, one_stats = single(scene_state(batch_state_from_arrays(tp, a, "cpu"), b), 10)
        assert [bool(d) for d in decisions] == [want_ok[b]] * 2
        assert one_stats["fallbacks"] == 2 * (not want_ok[b])
        for k in fields:
            assert torch.equal(getattr(one, k), getattr(out, k)[b]), (b, k)
    mesh = TorchMesh(np.array(["cpu"] * 4).reshape(2, 2), ("data", "bots"))
    mrun, _ = t_st.make_sharded_table_run_batched(tp, mesh=mesh, with_stats=True)
    mout, mstats = mrun(batch_state_from_arrays(tp, a, "cpu"), 10)
    assert mstats == stats
    for k in fields:
        assert torch.equal(getattr(mout, k), getattr(out, k)), k
    ref = t_et.make_run_chunk_table_batched(tp)(batch_state_from_arrays(tp, a, "cpu"), 10)
    same = [0, 1] if case == "plain" else [1]
    for k in ("pos", "vel", "rad", "phase", "dead"):
        assert torch.equal(getattr(ref, k)[same], getattr(out, k)[same]), k
    if case == "fallback":
        np.testing.assert_allclose(out.pos[0].numpy(), ref.pos[0].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out.vel[0].numpy(), ref.vel[0].numpy(), atol=1e-4, rtol=0)


DIST_BATCH_WORKER = """
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from particlerobotsimulations_torch.parallel.ring import DistRing
from particlerobotsimulations_torch.parallel.spatial import gather_state, make_sharded_step, shard_state
from particlerobotsimulations_torch.parallel.spatial_table import make_sharded_table_run_batched
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.state import batch_state_from_arrays, batch_state_to_arrays
init, rank, src, dst = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
with open(src, "rb") as fh:
    tp, dp, arrays, seeds, n_steps = pickle.load(fh)
ring = DistRing()
run, _ = make_sharded_table_run_batched(tp, ring, with_stats=True)
out, stats = run(batch_state_from_arrays(tp, arrays, "cpu"), n_steps)
step = make_sharded_step(dp, ring, batch=True)
st = shard_state(make_batch_state(dp, seeds, "cpu"), ring, batch=True)
for _ in range(n_steps):
    st = step(st)
dense = batch_state_to_arrays(gather_state(st, ring, batch=True))
np.savez(dst, fallbacks=stats["fallbacks"], **batch_state_to_arrays(out),
         **{"dense_" + k: v for k, v in dense.items()})
dist.destroy_process_group()
"""


def test_batched_dist_ring_equals_local_ring(tmp_path):
    """Two gloo ranks, one shard each, against ``LocalRing(2)``: the dp x tp
    table loop on 2 scenes of 64 bots (scene 1 kicked to 60 u/s: the
    fallbacks all-gather and argsort), dead injection and phase noise, and
    the dense split on a batch of 2 with the same draws, 12 steps each:
    elementwise equal (a two-shard sum commutes exactly)."""
    import pickle

    from particlerobotsimulations_torch.parallel import spatial as t_sp
    from particlerobotsimulations_torch.parallel.sweep import make_batch_state
    from particlerobotsimulations_torch.state import (
        batch_state_from_arrays,
        batch_state_to_arrays,
    )

    seeds = [0, 1]
    _, tp = params_pair(n_shards=2, n_cells=64, n_dead=5, time_to_dead=0.03, phase_std=0.5)
    dp = tp.replace(force_backend=pt.ForceBackend.DENSE)
    a = batch_arrays(tp, seeds, kick=(1, 60.0))
    src = tmp_path / "in.pkl"
    with open(src, "wb") as fh:
        pickle.dump((tp, dp, a, seeds, 12), fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", DIST_BATCH_WORKER, init, str(r), str(src),
             str(tmp_path / f"out{r}.npz")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    ring = LocalRing(2, "cpu")
    run, _ = t_st.make_sharded_table_run_batched(tp, ring, with_stats=True)
    out, stats = run(batch_state_from_arrays(tp, a, "cpu"), 12)
    want = batch_state_to_arrays(out)
    assert stats["fallbacks"] >= 1 and (want["dead"][:, :64].sum(axis=1) == 5).all()
    step = t_sp.make_sharded_step(dp, ring, batch=True)
    st = t_sp.shard_state(make_batch_state(dp, seeds, "cpu"), ring, batch=True)
    for _ in range(12):
        st = step(st)
    dense = batch_state_to_arrays(t_sp.gather_state(st, ring, batch=True))
    want.update({"dense_" + k: v for k, v in dense.items()})
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        assert int(got["fallbacks"]) == stats["fallbacks"]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")
