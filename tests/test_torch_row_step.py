"""PyTorch port, the row step: the table loop's per-row step glue in one
launch (``csrc/row_step.cu``, ``ops/row_step.py``).

On the CPU: the launch counts have the row step's keys and a CPU table
chunk counts neither (the plain twin runs there); the fused schedule of a
block's parts (``engine_table.glue_schedule``: a step's post and the next
ungated step's pre as one part, K + 1 row-step parts in an ungated K-step
block); the fused steps equal ``make_table_step`` one step at a time bit
for bit; and the wrapper refuses what the kernel does not take.

On the card (``-m cuda``, skipped elsewhere): the kernel against its
plain twin run on the same CUDA tensors, bit for bit on every plane, in
each mode, on one scene and on 8, with circles and a payload bot, with
rectangles and ``constrained_contraction``, over table, spill, parking
and padding rows; kernel 3, which shares the row arithmetic, equal to
kernel 1 and the twin's rows over a span; and a warm 10k K=8 chunk of the
runner equal to the same chunk through the twin ops, with 9 row-step
launches per ungated 8-step block.  These import no JAX; on a machine without it run them with the
repository's conftest switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_row_step.py
"""

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch import kernels, rng
from particlerobotsimulations_torch import state as t_state
from particlerobotsimulations_torch.models.placement import resolve_params
from particlerobotsimulations_torch.ops.row_step import row_step, row_step_plain
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.state import ARRAY_FIELDS

torch.set_num_threads(1)

UNGATED = t_chunk.NO_GATES
GATED = (False, True, False)
ROW_PARTS = ("pre", "post_pre", "post")


def row_parts(schedule) -> int:
    return sum(part in ROW_PARTS for part, _ in schedule)


# ------------------------------------------------------------ the CPU side

def test_launch_counts_have_the_row_step_keys():
    assert "row_step" in kernels.LAUNCHES and "row_step_batched" in kernels.LAUNCHES
    assert kernels.ROW_STEP_WRITES["post_pre"] == kernels.ROW_STEP_OUT


def small_params(**kw):
    base = dict(n_cells=40, n_dead=0, seed=4, config=pt.Config.HEX, light_x=-3.0,
                phase_std=0.5, centroid_int=0.05, phase_update_interval=0.07,
                slot_rebuild_steps=4, force_backend=pt.ForceBackend.PALLAS)
    base.update(kw)
    return pt.SimParams(**base).validate()


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_table_chunk_launches_no_row_step(batched):
    """A CPU chunk of the table runner (gated and ungated blocks) runs the
    plain twin: no launch is counted, the row step's included."""
    p = small_params()
    run = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    state = make_batch_state(p, [0, 1], "cpu") if batched else pt.Simulation(p, device="cpu").state
    before = dict(kernels.LAUNCHES)
    out = run(state, 12)
    assert out.step == 12 and dict(kernels.LAUNCHES) == before


@pytest.mark.parametrize("case", [
    # (pattern, close, schedule)
    (((UNGATED, False),) * 7 + ((UNGATED, True),), True,
     [("pre", 0)] + [("post_pre", j) for j in range(1, 8)] + [("rebuild", 7), ("post", 7)]),
    (((GATED, False),) + ((UNGATED, False),) * 2 + ((UNGATED, True),), True,
     [("pre", 0), ("post_pre", 1), ("post_pre", 2), ("post_pre", 3), ("rebuild", 3),
      ("post", 3)]),
    (((UNGATED, False), (GATED, False), (UNGATED, False), (UNGATED, True)), True,
     [("pre", 0), ("post", 0), ("pre", 1), ("post_pre", 2), ("post_pre", 3),
      ("rebuild", 3), ("post", 3)]),
    (((UNGATED, True), (UNGATED, False)), True,
     [("pre", 0), ("rebuild", 0), ("post", 0), ("pre", 1), ("post", 1)]),
    (((GATED, False), (UNGATED, False), (UNGATED, False)), False,
     [("pre", 0), ("post_pre", 1), ("post_pre", 2)]),
    (((UNGATED, False),), True, [("pre", 0), ("post", 0)]),
], ids=["ungated-k8", "gated-first", "gated-mid", "rebuild-mid", "open-end", "one-step"])
def test_glue_schedule(case):
    """A step's post and the next step's pre are one part unless that step
    fires a gate or this one rebuilds; an ungated K=8 block is 9 row-step
    parts; ``close=False`` stops after the last pre."""
    pattern, close, want = case
    assert t_et.glue_schedule(pattern, close) == want
    if pattern == ((UNGATED, False),) * 7 + ((UNGATED, True),):
        assert row_parts(want) == 9


@pytest.mark.parametrize("pattern", [
    ((UNGATED, False),) * 3, ((UNGATED, False), (GATED, False)), ((UNGATED, False),),
], ids=["ungated", "gated-next", "one-step"])
def test_glue_schedule_entered(pattern):
    """A block entered mid-step 0 (its pre ran) opens with step 0's post,
    fused with step 1's pre where step 1 fires no gate; the rest as from a
    step's start."""
    got = t_et.glue_schedule(pattern, entered=True)
    assert got == t_et.glue_schedule(pattern)[1:]
    assert got[0] == (("post_pre", 1) if len(pattern) > 1 and not any(pattern[1][0])
                      else ("post", 0))


def test_step_parts_are_one_step_calls_of_the_steps():
    """``make_table_step_parts``' pre and post run as ``make_table_step``:
    a gated pre, then a post, equal the one-step call bit for bit."""
    p = small_params()
    ts = t_et.enter_table(p, pt.Simulation(p, device="cpu").state)
    pre, post = t_et.make_table_step_parts(p)
    got = post(pre(ts, *GATED))
    want = t_et.make_table_step(p)(ts, *GATED, False)
    assert_fields_equal(got, want)


def assert_fields_equal(got, want):
    for k in t_state.TABLE_FIELDS:
        assert torch.equal(got.fields[k], want.fields[k]), k
    assert torch.equal(got.centroid_ring, want.centroid_ring)
    assert got.step == want.step


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("start", [1, 3])
def test_fused_steps_equal_one_step_at_a_time(batched, start):
    """The table runner's pieces over 12 steps (the centroid every 5
    steps, the noisy phase law every 7, so gates fall at a block's start
    and inside it) through ``make_table_steps`` equal ``make_table_step``
    one step at a time, bit for bit: fields, ring and step."""
    p = small_params()
    k = p.resolved_slot_rebuild_steps()
    state = make_batch_state(p, [0, 1], "cpu") if batched else pt.Simulation(p, device="cpu").state
    ts0 = t_et.enter_table(p, state.replace(step=start))
    pieces = t_et.table_pieces(p, k, start, 12)
    assert any(any(g) for pat in pieces for g, _ in pat[1:])
    steps, step = t_et.make_table_steps(p), t_et.make_table_step(p)
    got, want = ts0, ts0
    for pattern in pieces:
        draws = [t_chunk.draws(p, got.generator, got.step + j, g, got.fields["dead"].shape, "cpu")
                 for j, (g, _) in enumerate(pattern)]
        srcs = [rng.Drawn(d.get("scores"), d.get("noise")) for d in draws]
        s0 = t_state.step_tensor(got.step, "cpu")
        got = steps(got, pattern, s0, lambda j: srcs[j])
        for j, (gates, rebuild) in enumerate(pattern):
            want = step(want, *gates, rebuild, step_t=s0 + j, source=srcs[j])
        assert_fields_equal(got, want)
    assert got.step == start + 12


def test_row_step_wrapper_refuses_what_the_kernel_does_not_take():
    """No fallback: the wrapper refuses CPU planes and an unknown mode, and
    the dispatcher sends CPU planes to the twin."""
    p = small_params()
    ts = t_et.enter_table(p, pt.Simulation(p, device="cpu").state)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.row_step_cuda(p, ts.fields, "pre", t_state.step_tensor(0, "cpu"))
    with pytest.raises(ValueError, match="mode"):
        kernels.row_step_cuda(p, ts.fields, "both")
    step = t_state.step_tensor(0, "cpu")
    got = row_step(p, ts.fields, "pre", step, 2)
    want = row_step_plain(p, ts.fields, "pre", step, 2)
    for k in t_state.TABLE_FIELDS:
        assert torch.equal(got[k], want[k]), k


# ----------------------------------------------------------- the card side

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


# 300 bots in a 16 x 16 table of 16 force-visible slots and 8 spill slots,
# with the 384-row parking strip (rows 300..383 padding)
KERNEL_SCENES = {
    "plain": dict(),
    "circles-payload": dict(n_dead=-1, circle_obstacles=((0.0, 0.0, 1.0), (2.0, -1.5, 0.6),
                                                         (-2.5, 2.0, 0.3))),
    "rects-constrained": dict(constrained_contraction=1, constraint_contraction=0.8,
                              rect_obstacles=((-3.0, -1.0, -2.0, 2.0), (1.0, 3.5, 1.0, 1.8))),
}


def kernel_params(scene):
    base = dict(n_cells=300, n_dead=0, seed=3, config=pt.Config.HEX, grid_dim=16,
                cell_capacity=16, overflow_slots=8, world_half=4.5, light_x=-5.0)
    base.update(KERNEL_SCENES[scene])
    return pt.SimParams(**base).validate()


def random_fields(p, lead, seed, device):
    """The 13 planes of ``lead`` scenes, every branch of the row
    arithmetic taken somewhere: occupied and empty rows, exact and tiny
    velocities (the static hold), positions past the box (the clamp),
    negative, large and frozen phases, dead rows, payload rows, bots
    inside the obstacles."""
    rows = t_state.table_geometry(p)[1]
    rng = np.random.default_rng(seed)
    shape = lead + (rows,)
    val = (rng.random(shape) < 0.6).astype(np.float32)
    v = rng.normal(0.0, 0.3, shape)
    v = np.where(rng.random(shape) < 0.1, 0.0, v)
    v = np.where(rng.random(shape) < 0.05, 1e-8, v)
    phase = rng.uniform(-5.0, 20.0, shape)
    phase = np.where(rng.random(shape) < 0.05, 2.0e7, phase)
    f = {
        "px": rng.uniform(-5.0, 5.0, shape), "py": rng.uniform(-5.0, 5.0, shape),
        "vx": v, "vy": rng.normal(0.0, 0.3, shape) * (v != 0.0),
        "rad": np.where(val > 0, rng.uniform(0.07, 0.12, shape), 0.0),
        "val": val, "afac": val, "phase": phase,
        "dead": (rng.random(shape) < 0.1).astype(np.float32),
        "aa": np.abs(rng.normal(0.0, 2.0, shape)), "ar": np.abs(rng.normal(0.0, 2.0, shape)),
        "pay": val * (rng.random(shape) < 0.05) if p.has_payload else np.zeros(shape),
        "bid": np.broadcast_to(np.arange(rows), shape),
    }
    return {k: torch.tensor(np.ascontiguousarray(f[k]), dtype=torch.float32, device=device)
            for k in t_state.TABLE_FIELDS}


def random_forces(p, lead, seed, device):
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    rng = np.random.default_rng(seed)
    out = rng.normal(0.0, 3.0, (4,) + lead + (cap, g * g))
    out[:, ..., rng.random((cap, g * g)) < 0.3] = 0.0
    return tuple(torch.tensor(o, dtype=torch.float32, device=device) for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [None, 8])
@pytest.mark.parametrize("scene", list(KERNEL_SCENES))
@pytest.mark.parametrize("mode", ["post", "pre", "post_pre"])
def test_row_step_kernel_equals_twin(card, mode, scene, scenes):
    """The kernel against its plain twin on the same CUDA planes, equal to
    the bit on all 13 planes, at steps whose sim time wraps the phase
    clock; one launch whatever the scene count; the planes the mode does
    not write come back as they went in."""
    p = kernel_params(scene)
    lead = () if scenes is None else (scenes,)
    fields = random_fields(p, lead, 11, card)
    forces = random_forces(p, lead, 12, card) if mode != "pre" else None
    key = "row_step_batched" if lead else "row_step"
    for step, offset in ((0, 0), (4_321, 1), (1_000_003, 7)):
        s = t_state.step_tensor(step, card)
        n0 = kernels.LAUNCHES[key]
        got = kernels.row_step_cuda(p, fields, mode, s, offset, forces)
        assert kernels.LAUNCHES[key] == n0 + 1
        want = row_step_plain(p, fields, mode, s, offset, forces)
        torch.cuda.synchronize()
        for k in t_state.TABLE_FIELDS:
            assert torch.equal(got[k], want[k]), (k, step, int((got[k] != want[k]).sum()))
            if k not in kernels.ROW_STEP_WRITES[mode]:
                assert got[k] is fields[k], k


# kernel 3's scenes (tests/test_torch_cuda.py): the band (1000 bots, G=16,
# C=16), 8 slots with a payload at G=16, and 4 slots at G=32 with circles
# and a rectangle
SPAN_SCENES = {
    "band": dict(n_cells=1000, n_dead=0, seed=3, config=pt.Config.HEX, light_x=-5.0),
    "g16-c8-payload": dict(n_cells=300, n_dead=-1, seed=5, config=pt.Config.HEX,
                           light_x=-5.0, grid_dim=16, cell_capacity=8, attraction_factor=2.0,
                           force_backend=pt.ForceBackend.PALLAS),
    "g32-c4-obstacles": dict(n_cells=300, n_dead=0, seed=5, config=pt.Config.HEX,
                             light_x=-5.0, grid_dim=32, cell_capacity=4,
                             force_backend=pt.ForceBackend.PALLAS,
                             circle_obstacles=((1.0, 0.5, 0.5), (-1.5, 1.0, 0.3)),
                             rect_obstacles=((-0.5, 0.5, -2.5, -1.5),)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SPAN_SCENES))
def test_mega_span_rows_equal_twin_ops(card, scene):
    """Kernel 3 runs the row step's arithmetic (``row_step.cuh``): one span
    from the mid-step state after 200 steps equals, bit for bit on every
    plane of the table and the parking strip, the same k steps built from
    kernel 1's pair sums (the order kernel 3 adds them in) and the row
    step's plain twin, the PyTorch ops, on the same card."""
    p = pt.SimParams(**SPAN_SCENES[scene]).validate()
    sim = pt.Simulation(p, device=card)
    assert sim._run_chunk.path_info["use_mega"]
    sim.step_chunk(200, start_step=0)
    ts = t_et.enter_table(p, sim.state)
    ts = t_et.make_table_step_parts(p)[0](ts, *t_chunk.gates(p, ts.step))
    pack, unpack, _ = t_et._make_mega_glue(p)
    tbl, strip = pack(ts.fields)
    first = t_state.step_tensor(ts.step + 1, card)
    got = kernels.mega_span_cuda(p, tbl.contiguous(), strip.contiguous(), first)
    g, cap = p.resolved_grid_dim(), p.cell_capacity
    names = ("px", "py", "vx", "vy", "rad") + (("afac",) if p.has_payload else ())
    f = unpack(tbl, strip)
    for j in range(p.resolved_slot_rebuild_steps()):
        tables = {n: f[n][: cap * g * g].view(cap, g * g) for n in names}
        f = row_step_plain(p, f, "post_pre", first, j, kernels.stencil_forces_cuda(p, tables))
    want = pack(f)
    torch.cuda.synchronize()
    for part, a, b in zip(("table", "strip"), got, want):
        for i, k in enumerate(t_state.TABLE_FIELDS):
            assert torch.equal(a[i], b[i]), (part, k, int((a[i] != b[i]).sum()))


@pytest.mark.cuda
def test_row_step_wrapper_refuses_shapes(card):
    p = kernel_params("plain")
    fields = random_fields(p, (), 1, card)
    forces = random_forces(p, (), 2, card)
    s = t_state.step_tensor(0, card)
    with pytest.raises(ValueError, match="forces"):
        kernels.row_step_cuda(p, fields, "post")
    with pytest.raises(ValueError, match="step"):
        kernels.row_step_cuda(p, fields, "pre", t_state.step_tensor(0, "cpu"))
    with pytest.raises(ValueError, match="forces"):
        kernels.row_step_cuda(p, fields, "post", forces=tuple(f[:8] for f in forces))
    bad = dict(fields, vx=fields["vx"][:-1])
    with pytest.raises(ValueError, match="vx"):
        kernels.row_step_cuda(p, bad, "pre", s)


# 10,000 HEX bots at K=8 (G=48): the centroid every 37 steps and the noisy
# phase law every 50, so that a warm chunk holds ungated blocks and gates
# inside blocks
CHUNK_SCENE = dict(n_cells=10_000, n_dead=0, seed=7, config=pt.Config.HEX, light_x=-20.0,
                   force_backend=pt.ForceBackend.PALLAS, slot_rebuild_steps=8,
                   phase_std=0.5, centroid_int=0.37, phase_update_interval=0.5)
CHUNKS = (8, 64, 64)


def run_chunks(p, state, batched):
    """``CHUNKS`` through a fresh runner; the launches of the last (warm)
    chunk."""
    run = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    for n in CHUNKS[:-1]:
        state = run(state, n)
    torch.cuda.synchronize()
    n0 = dict(kernels.LAUNCHES)
    state = run(state, CHUNKS[-1])
    torch.cuda.synchronize()
    return state, {k: kernels.LAUNCHES[k] - n0[k] for k in n0}


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_warm_chunk_equals_twin_ops(card, batched, monkeypatch):
    """A warm 10k K=8 chunk of the table runner (every block replayed from
    a CUDA graph) equals the same chunks through the twin ops bit for bit;
    its row-step launches are the schedule's, 9 per ungated 8-step block,
    one kernel-1 launch per step; batched: two scenes."""
    p = resolve_params(pt.SimParams(**CHUNK_SCENE).validate())
    k = p.resolved_slot_rebuild_steps()

    def fresh():
        if batched:
            return make_batch_state(p, [0, 1], card)
        return pt.Simulation(p, device=card).state

    got, launches = run_chunks(p, fresh(), batched)
    with monkeypatch.context() as m:
        m.setattr(kernels, "row_step_cuda", row_step_plain)
        want, twin_launches = run_chunks(p, fresh(), batched)
    for name in ARRAY_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    start = sum(CHUNKS[:-1])
    pieces = t_et.table_pieces(p, k, start, CHUNKS[-1])
    ungated = [pat for pat in pieces if not any(any(g) for g, _ in pat)]
    assert len(pieces) == 8 and 0 < len(ungated) < 8
    assert all(row_parts(t_et.glue_schedule(pat)) == 9 for pat in ungated)
    key, other = ("row_step_batched", "row_step") if batched else ("row_step", "row_step_batched")
    assert launches[key] == sum(row_parts(t_et.glue_schedule(pat)) for pat in pieces)
    assert launches[other] == twin_launches[key] == 0
    assert launches["stencil_forces_batched" if batched else "stencil_forces"] == CHUNKS[-1]
