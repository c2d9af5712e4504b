"""PyTorch port, the dense step: steps 4-6 of the per-bot DENSE step (the
radius controller, integrate, all-pairs forces, obstacles and friction) of
every scene in one launch (``csrc/dense_step.cu``, ``ops/dense_step.py``).

On the CPU: the launch counts have the dense step's keys, and a CPU DENSE
chunk, single and batched, and a differentiable ``make_step`` count none
(the plain ops run there); the body, its gated ops (``engine._gated``) and
its tail (``ops/dense_step.step_tail``, and on DENSE the twin
``dense_step_plain``) equal the body as it was before the split, kept in
this file, bit for bit; the launch plan and the constants against the
source; and the wrapper refuses what the kernel does not take.

On the card (``-m cuda``, skipped elsewhere): the kernel against its plain
twin on the same CUDA tensors, for one scene and for 8, with circles,
rectangles, a payload bot, dead bots and padded rows: bit for bit on
every field where no bot has more than one neighbour in reach, within the
sum order's tolerance (rtol 1e-5, atol 1e-5 x max|f|) on the
``example_obstacle.cfg`` layout and on 1,500 bots (two staged chunks); a
warm 8-step block of the batched runner replayed from its CUDA graph, 8
``dense_step_batched`` launches, equal to eight eager steps; and the
differentiable step, which counts none.  These import no JAX; on a
machine without it run them with the repository's conftest switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_step.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import chunk as t_chunk
from particlerobotsimulations_torch import engine as t_engine
from particlerobotsimulations_torch import kernels, rng
from particlerobotsimulations_torch import state as t_state
from particlerobotsimulations_torch.ops.actuation import update_radius
from particlerobotsimulations_torch.ops.dense_step import (
    TAIL_FIELDS,
    dense_step_plain,
)
from particlerobotsimulations_torch.ops.integrate import integrate
from particlerobotsimulations_torch.ops.phase import update_phase
from particlerobotsimulations_torch.parallel.sweep import make_batch_state
from particlerobotsimulations_torch.state import ARRAY_FIELDS, active_mask, payload_mask

torch.set_num_threads(1)

f32 = np.float32
ROOT = Path(__file__).resolve().parents[1]
UNGATED = t_chunk.NO_GATES
DENSE = pt.ForceBackend.DENSE
KEYS = ("dense_step", "dense_step_batched")


def launches():
    return {k: kernels.LAUNCHES[k] for k in KEYS}


# ------------------------------------------------------------ the CPU side

def test_launch_counts_have_the_dense_step_keys():
    assert all(k in kernels.LAUNCHES for k in KEYS)


# 40 bots, a payload bot, two circles and a rectangle, the radius law's
# constrained contraction, the centroid every 5 steps and the noisy phase
# law every 7; and 40 bots of which 5 die at step 30
SMALL = {
    "payload-obstacles": dict(n_dead=-1, attraction_factor=2.0, mass_factor=3.0,
                              friction_factor=1.5, constrained_contraction=1,
                              constraint_contraction=0.8,
                              circle_obstacles=((0.0, 0.0, 0.3), (0.8, -0.6, 0.2)),
                              rect_obstacles=((-1.0, -0.6, -0.3, 0.3),)),
    "dead": dict(n_dead=5, time_to_dead=0.3),
}


def small_params(scene):
    base = dict(n_cells=40, seed=4, config=pt.Config.HEX, light_x=-3.0, phase_std=0.5,
                centroid_int=0.05, phase_update_interval=0.07, force_backend=DENSE)
    base.update(SMALL[scene])
    return pt.SimParams(**base).validate()


@pytest.mark.parametrize("batched", [False, True])
def test_cpu_dense_chunk_launches_no_dense_step(batched):
    """A CPU DENSE chunk (gated and ungated blocks) runs the plain ops: no
    launch is counted, the dense step's included."""
    p = small_params("payload-obstacles")
    run = (t_engine.make_run_chunk_batched if batched else t_engine.make_run_chunk)(p, "cpu")
    state = make_batch_state(p, [0, 1], "cpu") if batched else pt.Simulation(p, device="cpu").state
    before = dict(kernels.LAUNCHES)
    out = run(state, 12)
    assert out.step == 12 and dict(kernels.LAUNCHES) == before


def test_differentiable_step_launches_no_dense_step():
    """``make_step(differentiable=True)`` on DENSE runs the plain ops, and a
    gradient flows through them."""
    p = small_params("payload-obstacles")
    state = pt.Simulation(p, device="cpu").state
    phase = state.phase.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out = t_engine.make_step(p, "cpu", differentiable=True)(state.replace(phase=phase))
    out.pos.sum().backward()
    assert dict(kernels.LAUNCHES) == before
    assert phase.grad is not None


def pre_split_body(params):
    """``engine._make_body`` on DENSE as it was before its split into the
    gated ops and the tail, with the tail's ops inline."""
    collide = t_engine._COLLIDES[DENSE]
    dt = params.timestep

    def body(arrays, draws, step, gates, step_t=None):
        pos, vel, rad, phase, dead, ring = (
            arrays[k] for k in ("pos", "vel", "rad", "phase", "dead", "centroid_ring")
        )
        dev = pos.device
        n_pad = pos.shape[-2]
        mask = active_mask(params, n_pad, dev)
        payload = payload_mask(params, n_pad, dev)
        if step_t is None:
            step_t = t_state.step_tensor(step, dev)
        time = t_state.sim_time(step_t, dt)
        dead_gate, cog_gate, phase_gate = gates
        if dead_gate:
            dead = t_engine._inject_dead(params, dead, mask, draws["scores"])
        if cog_gate:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            centroid = torch.sum(torch.where(mask[:, None], pos, zero), dim=0) / f32(
                params.n_cells)
            ring = t_chunk.ring_write(params, ring, step_t, centroid)
        if phase_gate:
            phase = update_phase(params, pos, phase, mask,
                                 rng.Drawn(normal=draws.get("noise")), step=step)
        rad = update_radius(params, rad, phase, arrays["abs_force_a"],
                            arrays["abs_force_r"], dead, mask, time, dt)
        pos, vel = integrate(params, pos, vel, rad, dt)
        new_vel, abs_a, abs_r = collide(params, pos, vel, rad, mask, payload, dt)
        return {"pos": pos, "vel": new_vel, "rad": rad, "phase": phase, "dead": dead,
                "abs_force_a": abs_a, "abs_force_r": abs_r, "centroid_ring": ring}

    return body


def assert_arrays_equal(got, want, keys=ARRAY_FIELDS):
    for k in keys:
        assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k]).sum()))


def stepped(p, batched, n=25):
    """A CPU state ``n`` steps in (contacts, forces and radii moving)."""
    run = (t_engine.make_run_chunk_batched if batched else t_engine.make_run_chunk)(p, "cpu")
    state = make_batch_state(p, [0, 1], "cpu") if batched else pt.Simulation(p, device="cpu").state
    return run(state, n)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("scene", list(SMALL))
def test_split_body_equals_the_body_before_the_split(scene, batched):
    """Over 12 steps from step 25, gates firing at some, the step fn of the
    runners (``_make_step_fn``: the body, vmapped where batched), the gated
    ops followed by the twin ``dense_step_plain``, and the body before the
    split agree bit for bit on every field."""
    p = small_params(scene)
    state = stepped(p, batched)
    shape = (state.pos.shape[0], state.n_pad) if batched else (state.n_pad,)
    fn = t_engine._make_step_fn(p, DENSE, batched)
    old = pre_split_body(p)
    fired = set()
    for s in range(state.step, state.step + 12):
        gates = t_chunk.step_gates(p, s)
        fired.update(i for i, g in enumerate(gates) if g)
        draws = t_chunk.draws(p, state.generator, s, gates, shape, "cpu")
        arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
        step_t = t_state.step_tensor(s, "cpu")
        got = fn(arrays, draws, s, gates, step_t)
        if batched:
            want = torch.func.vmap(lambda a, d: old(a, d, s, gates, step_t))(arrays, draws)
            gated = torch.func.vmap(lambda a, d: t_engine._gated(
                a, d, params=p, step=s, gates=gates, step_t=step_t))(arrays, draws)
        else:
            want = old(arrays, draws, s, gates)
            gated = t_engine._gated(arrays, draws, params=p, step=s, gates=gates, step_t=step_t)
        twin = {**gated, **dense_step_plain(p, gated, step_t)}
        assert_arrays_equal(got, want)
        assert_arrays_equal(twin, want)
        state = state.replace(step=s + 1, **got)
    assert fired == ({0, 1, 2} if p.n_dead > 0 else {1, 2})


def test_twin_takes_the_step_offset():
    """``dense_step_plain`` at ``(step, offset)`` is the twin at the step
    ``step + offset``, single and batched."""
    p = small_params("payload-obstacles")
    for batched in (False, True):
        state = stepped(p, batched)
        arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
        s = t_state.step_tensor(state.step, "cpu")
        want = dense_step_plain(p, arrays, s + 3)
        assert not torch.equal(want["rad"], dense_step_plain(p, arrays, s)["rad"])
        assert_arrays_equal(dense_step_plain(p, arrays, s, 3), want, TAIL_FIELDS)


@pytest.mark.parametrize("case", [
    # (scenes, n_pad, SMs, tile rows)
    (8, 512, 132, 32), (1, 512, 132, 16), (1, 256, 132, 8), (1, 128, 132, 4),
    (1, 64, 132, 4), (2, 256, 132, 16), (1, 10_112, 132, 32), (2, 128, 1, 32),
])
def test_dense_plan(case):
    """The tile is the largest whose blocks number at least an eighth of
    the SMs, else the smallest; a block is a warp per row."""
    scenes, n_pad, sms, rows = case
    plan = kernels.dense_plan(scenes, n_pad, sms)
    assert plan == {"rows": rows, "blocks": scenes * -(-n_pad // rows), "threads": rows * 32}


def test_dense_constants_follow_the_source():
    """The constants fill ``DensePair`` in ``csrc/dense_step.cu``, and the
    tiles are the source's; the ramp's reciprocals are the
    float32 reciprocals of the twin's host scalars."""
    src = (ROOT / "particlerobotsimulations_torch/csrc/dense_step.cu").read_text()
    body = re.search(r"struct DensePair \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\w+(?=[,;])", body)
    p = small_params("payload-obstacles")
    consts = kernels.dense_constants(p)
    assert len(consts) == len(fields) == 11
    named = dict(zip(fields, consts))
    assert named["neg_spring"] == -float(f32(p.spring))
    assert named["inv_int2_sq"] == float(f32(1.0) / f32(0.0019) ** 2)
    assert named["inv_span"] == float(f32(1.0) / f32(0.0019 - 0.0009))
    assert f"kMaxTile = {max(kernels.DENSE_TILES)};" in src
    tiles = " && ".join(f"tile_rows != {r}" for r in sorted(kernels.DENSE_TILES))
    assert tiles in src


def test_dense_step_wrapper_refuses_what_the_kernel_does_not_take():
    """No fallback: the wrapper refuses CPU tensors and shapes it does not
    take, before it builds anything."""
    p = small_params("payload-obstacles")
    state = pt.Simulation(p, device="cpu").state
    arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
    s = t_state.step_tensor(0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dense_step_cuda(p, arrays, s)
    with pytest.raises(ValueError, match="pos"):
        kernels.dense_step_cuda(p, dict(arrays, pos=arrays["pos"][:, :1]), s)
    with pytest.raises(ValueError, match="pos"):
        kernels.dense_step_cuda(p, dict(arrays, pos=arrays["pos"].reshape(-1)), s)


# ----------------------------------------------------------- the card side

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


# 150 bots (rows 150..255 padding) in pairs and singles on a lattice 1.3
# apart, past the 0.517 cutoff, so no bot has more than one neighbour in
# reach; circles and a rectangle over some lattice sites
SPARSE = {
    "plain": dict(n_dead=0),
    "payload-obstacles": dict(n_dead=-1, attraction_factor=2.0, mass_factor=3.0,
                              friction_factor=1.5,
                              circle_obstacles=((0.0, 0.0, 0.3), (2.6, -1.3, 0.2),
                                                (-3.9, 3.9, 0.25)),
                              rect_obstacles=((-2.7, -2.5, -1.6, -1.0),
                                              (1.2, 1.4, 2.5, 2.7))),
    "constrained": dict(n_dead=0, constrained_contraction=1, constraint_contraction=0.8),
}


def sparse_params(scene):
    base = dict(n_cells=150, seed=3, config=pt.Config.HEX, world_half=8.0, light_x=-5.0,
                force_backend=DENSE)
    base.update(SPARSE[scene])
    return pt.SimParams(**base).validate()


def sparse_arrays(p, lead, seed, device):
    """Per-bot arrays of ``lead`` scenes: pairs at every contact and magnet
    branch (overlap, the plateau, the ramp, the inverse square, out of
    reach) and single bots, one per lattice site; exact, tiny and zero
    velocities; negative, large and frozen phases; dead bots; the force
    magnitudes of a previous step."""
    from particlerobotsimulations_torch.config import padded_n

    n, n_pad = p.n_cells, padded_n(p)
    g = np.random.default_rng(seed)
    shape = lead + (n_pad,)
    rad = g.uniform(p.min_radius, p.max_radius, shape)
    sites = np.array([(x, y) for x in np.arange(-6.5, 6.6, 1.3)
                      for y in np.arange(-6.5, 6.6, 1.3)])
    pos = np.zeros(shape + (2,))
    k = 0
    extra = (-0.02, 0.0005, 0.0014, 0.1, 0.6)  # surface gap of a pair
    for site in sites:
        if k >= n:
            break
        if k + 1 < n and (k // 2) % 3 != 2:
            gap = extra[(k // 2) % len(extra)]
            d = rad[..., k] + rad[..., k + 1] + gap
            ang = g.uniform(0.0, 2 * np.pi, lead)
            pos[..., k, :] = site
            pos[..., k + 1, 0] = site[0] + d * np.cos(ang)
            pos[..., k + 1, 1] = site[1] + d * np.sin(ang)
            k += 2
        else:
            pos[..., k, :] = site
            k += 1
    assert k == n
    vel = g.normal(0.0, 0.05, shape + (2,))
    vel[g.random(shape) < 0.1] = 0.0
    vel[g.random(shape) < 0.05] = 1e-8
    phase = g.uniform(-5.0, 20.0, shape)
    phase[g.random(shape) < 0.05] = 2.0e7
    dead = g.random(shape) < 0.1
    real = np.arange(n_pad) < n
    a = {
        "pos": pos, "vel": vel * real[:, None], "rad": rad * real, "phase": phase,
        "dead": dead & real, "abs_force_a": np.abs(g.normal(0.0, 2.0, shape)),
        "abs_force_r": np.abs(g.normal(0.0, 2.0, shape)),
        "centroid_ring": np.zeros(lead + (p.centroid_steps, 2)),
    }
    return {k: torch.tensor(v, dtype=torch.bool if k == "dead" else torch.float32,
                            device=device) for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [None, 8])
@pytest.mark.parametrize("scene", list(SPARSE))
def test_dense_step_kernel_equals_twin_bitwise_on_sparse_layouts(card, scene, scenes):
    """Where no bot has more than one neighbour in reach the sum order
    cannot matter: the kernel equals its twin on the same CUDA tensors bit
    for bit on every field, at steps whose sim time wraps the phase clock;
    one launch whatever the scene count."""
    p = sparse_params(scene)
    lead = () if scenes is None else (scenes,)
    arrays = sparse_arrays(p, lead, 11, card)
    key = "dense_step_batched" if lead else "dense_step"
    for step, offset in ((0, 0), (4_321, 1), (1_000_003, 7)):
        s = t_state.step_tensor(step, card)
        n0 = kernels.LAUNCHES[key]
        got = kernels.dense_step_cuda(p, arrays, s, offset)
        assert kernels.LAUNCHES[key] == n0 + 1
        want = dense_step_plain(p, arrays, s, offset)
        torch.cuda.synchronize()
        assert float(want["abs_force_r"].abs().max()) > 0
        assert float(want["abs_force_a"].abs().max()) > 0
        assert_arrays_equal(got, want, TAIL_FIELDS)


def obstacle_params():
    return pt.load_cfg(str(ROOT / "examples/example_obstacle.cfg"))


@pytest.fixture(scope="module")
def obstacle_states():
    """``example_obstacle.cfg`` (500 RANDOM bots, 3 circles; AUTO: DENSE on
    the card) 300 steps in, one scene and 8 seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = obstacle_params()
    assert p.resolved_backend("cuda") == DENSE
    one = t_engine.make_run_chunk(p, "cuda")(pt.Simulation(p, device="cuda").state, 300)
    eight = t_engine.make_run_chunk_batched(p, "cuda")(
        make_batch_state(p, list(range(8)), "cuda"), 300)
    return {None: one, 8: eight}


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [None, 8])
def test_dense_step_kernel_equals_twin_on_the_obstacle_layout(card, obstacle_states, scenes):
    """On the shipped obstacle scene, where bots touch several others, the
    kernel equals its twin within the sum order's tolerance (rtol 1e-5,
    atol 1e-5 x max|f|); the positions and radii, which no sum reaches,
    bit for bit."""
    p = obstacle_params()
    state = obstacle_states[scenes]
    arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
    s = t_state.step_tensor(state.step, card)
    got = kernels.dense_step_cuda(p, arrays, s)
    want = dense_step_plain(p, arrays, s)
    torch.cuda.synchronize()
    assert_arrays_equal(got, want, ("pos", "rad"))
    assert float((want["abs_force_r"] > 0).float().mean()) > 0.5
    for k in ("vel", "abs_force_a", "abs_force_r"):
        a, b = got[k].cpu().numpy(), want[k].cpu().numpy()
        scale = float(np.abs(b).max())
        assert scale > 0, k
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.cuda
def test_dense_step_kernel_takes_scenes_past_one_staged_chunk(card):
    """1,500 HEX bots forced to DENSE: the kernel stages the candidates in
    two chunks and every target computes its own pre; equal to the twin
    as on the obstacle layout."""
    p = pt.SimParams(n_cells=1_500, n_dead=0, seed=5, config=pt.Config.HEX, light_x=-8.0,
                     force_backend=DENSE).validate()
    state = t_engine.make_run_chunk(p, card)(pt.Simulation(p, device=card).state, 40)
    arrays = {k: getattr(state, k) for k in ARRAY_FIELDS}
    s = t_state.step_tensor(state.step, card)
    got = kernels.dense_step_cuda(p, arrays, s)
    want = dense_step_plain(p, arrays, s)
    torch.cuda.synchronize()
    assert_arrays_equal(got, want, ("pos", "rad"))
    for k in ("vel", "abs_force_a", "abs_force_r"):
        a, b = got[k].cpu().numpy(), want[k].cpu().numpy()
        scale = float(np.abs(b).max())
        assert scale > 0, k
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.cuda
def test_warm_block_replays_eight_dense_step_launches(card, obstacle_states):
    """A warm ungated 8-step block of the batched runner (replayed from its
    CUDA graph) launches the dense step 8 times and equals eight eager
    steps of ``make_step_batched`` bit for bit."""
    p = obstacle_params()
    state = obstacle_states[8]
    run = t_engine.make_run_chunk_batched(p, "cuda")
    state = run(state, 16)  # the block's graph is captured
    pieces = t_engine.bot_pieces(p, state.step, 8, t_engine.BLOCK_STEPS)
    assert pieces == [(UNGATED, 8)]
    torch.cuda.synchronize()
    n0 = launches()
    got = run(state, 8)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - n0[k] for k in KEYS} == {
        "dense_step": 0, "dense_step_batched": 8}
    step = t_engine.make_step_batched(p, "cuda")
    want = state
    for _ in range(8):
        want = step(want)
    for k in ARRAY_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.cuda
def test_differentiable_step_on_the_card_launches_no_dense_step(card):
    """On the card the differentiable DENSE step runs the plain ops (no
    launch) and the plain step the dense step (one)."""
    p = sparse_params("payload-obstacles")
    state = pt.Simulation(p, device=card).state
    n0 = launches()
    t_engine.make_step(p, card, differentiable=True)(state)
    assert launches() == n0
    t_engine.make_step(p, card)(state)
    assert launches() == dict(n0, dense_step=n0["dense_step"] + 1)


@pytest.mark.cuda
def test_dense_step_wrapper_refuses_shapes_on_the_card(card):
    p = sparse_params("plain")
    arrays = sparse_arrays(p, (), 1, card)
    s = t_state.step_tensor(0, card)
    with pytest.raises(ValueError, match="step"):
        kernels.dense_step_cuda(p, arrays, t_state.step_tensor(0, "cpu"))
    with pytest.raises(ValueError, match="dead"):
        kernels.dense_step_cuda(p, dict(arrays, dead=arrays["dead"].float()), s)
    with pytest.raises(ValueError, match="vel"):
        kernels.dense_step_cuda(p, dict(arrays, vel=arrays["vel"][:-1]), s)
    with pytest.raises(ValueError, match="rad"):
        kernels.dense_step_cuda(p, dict(arrays, rad=arrays["rad"][:1].expand(256)), s)
    with pytest.raises(ValueError, match="n_cells"):
        kernels.dense_step_cuda(p, {k: v[:128] for k, v in arrays.items()}, s)
