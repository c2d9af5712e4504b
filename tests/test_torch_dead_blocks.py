"""PyTorch port, the dead-injection step and the ragged tail as blocks, on
the CPU.

The JAX package compiles every step of a chunk: its dead injection is a
``lax.cond`` among the gates (``engine_table.py``'s ``step_pre``, the
sharded loop's ``step_local``) and a chunk's remainder a ``plain`` scan.
The port cuts no step of a chunk out to run eagerly: the dead step rides
in the block it falls in (table loops: a K-step block keyed by its gate
pattern; the per-bot runner: the block it starts), its scores drawn
before the block and fed in, and the ragged tail is a block of its own
length.  On the card each replays a CUDA graph; on the CPU every block
runs eagerly through the code a graph captures.

Held here, for chunks that hold the dead step at step 0, mid-block in a
later chunk, and a ragged tail: the schedules (``table_pieces``,
``bot_pieces``), and bit for bit against a one-step-at-a-time loop the
table loop, the per-bot DENSE runner and the sharded ``LocalRing`` loop
(single and batched), and the span path (a G=16 mega-eligible table whose
dead step opens a gate segment, with the segment's span rebuilds forced
to fail in one case: its redo kills the same bots) against the span path
that reads each segment's flag (``test_torch_small_chunk.py``'s
reference).  Against the JAX package on its own draws (``JaxDraws``): the
table loop, DENSE and the sharded loop over two chunks (6 + 9 steps, the
dead step at 13) against JAX's single-scene chunks at the slice tests'
tolerances (positions 1e-5, velocities 1e-4, radii and ring 1e-6, phases
1e-4; dead sets equal; the sharded loop draws what the single-table loop
draws, so it is held to JAX's single-table chunk), and the span path
over 24 steps with its dead segment against JAX's span chunk at the
megakernel tests' tolerances (positions and radii 2e-4, phases 1e-4,
ring 1e-5).  Sizes: 24-256 bots, at most 48 steps.
"""

import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
from particlerobotsimulations_torch import engine as t_engine
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch.parallel import spatial_table as t_st
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_torch.state import state_from_arrays, state_to_arrays
from particlerobotsimulations_tpu import engine as j_engine
from particlerobotsimulations_tpu import engine_table as j_et

from test_torch_gated_blocks import (
    assert_close,
    assert_states_equal,
    fresh,
    gated_params,
    jax_pair,
    table_step_loop,
)
from test_torch_rng import arrays_of, jittered, port_state
from test_torch_small_chunk import (  # noqa: F401 (forced_spans: a fixture)
    counted_run,
    forced_spans,
    reference_span_chunk,
    span_params,
)

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

# (time_to_dead, chunk lengths): the dead step at step 0 in a chunk that
# ends in a 2-step tail; the dead step at 13, mid-block in the second of
# two chunks, which ends in a 3-step tail
CASES = {
    "dead at 0": (0.0, (18,)),
    "dead mid-chunk": (0.13, (8, 11)),
}


def dead_params(case, **kw):
    """:func:`gated_params` (24 HEX bots, K=4, the centroid every 4 steps,
    the noisy phase law every 6, 3 bots killed) with the case's dead step."""
    return gated_params(time_to_dead=CASES[case][0], **kw)


def holds_dead(p, chunks) -> bool:
    return p.n_dead > 0 and 0 <= p.dead_step < sum(chunks)


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("case", list(CASES))
def test_table_pieces_hold_no_eager_piece(case):
    """``table_pieces``: blocks of (gates, rebuild) steps only, each ending
    with its rebuild but the chunk's ragged tail, a block of its own
    length; the dead step sits inside its block at its own step."""
    p = dead_params(case)
    k = p.resolved_slot_rebuild_steps()
    start = 0
    for n in CASES[case][1]:
        pieces = t_et.table_pieces(p, k, start, n)
        assert all(isinstance(pat, tuple) and all(len(st) == 2 for st in pat) for pat in pieces)
        assert [len(pat) for pat in pieces] == [k] * (n // k) + ([n % k] if n % k else [])
        assert all(pat[-1][1] for pat in pieces[: n // k])
        assert not any(rb for _, rb in pieces[-1]) or n % k == 0
        steps = [(start + j, st) for j, st in enumerate(st for pat in pieces for st in pat)]
        assert [s for s, (gates, _) in steps if gates[0]] == (
            [p.dead_step] if start <= p.dead_step < start + n else [])
        assert all(gates == t_et._step_gates(p, s) for s, (gates, _) in steps)
        start += n


@pytest.mark.parametrize("case", list(CASES))
def test_bot_pieces_hold_no_eager_piece(case):
    """``bot_pieces``: (gates, length) blocks only, each starting at a gated
    step or where the previous one ended, the dead step's included, none
    longer than the block length; the chunk's last block is short."""
    p = dead_params(case, force_backend=pt.ForceBackend.DENSE)
    start = 0
    for n in CASES[case][1]:
        pieces = t_engine.bot_pieces(p, start, n, 4)
        assert all(len(piece) == 2 for piece in pieces)
        assert sum(length for _, length in pieces) == n
        assert all(1 <= length <= 4 for _, length in pieces) and pieces[-1][1] < 4
        firsts = np.cumsum([0] + [length for _, length in pieces])[:-1] + start
        gated = [s for s in range(start, start + n) if any(t_et._step_gates(p, s))]
        assert set(gated) <= set(firsts.tolist())
        if start <= p.dead_step < start + n:
            i = firsts.tolist().index(p.dead_step)
            assert pieces[i][0][0]
        start += n


# --------------------------------------- against the one-step reference

def run_chunks(run, state, chunks):
    for n in chunks:
        state = run(state, n)
        assert run.eager_steps == 0
    return state


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_table_runner_with_dead_block_equals_step_loop(case, batched):
    """The table runner's chunks equal ``make_table_step`` one step at a
    time over the same chunks, bit for bit, rebuild counts included; no
    step ran eagerly by design."""
    p = dead_params(case)
    chunks = CASES[case][1]
    assert holds_dead(p, chunks)
    run = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    got = run_chunks(run, fresh(p, batched), chunks)
    counts = dict(t_et.REBUILDS)
    for k in t_et.REBUILDS:
        t_et.REBUILDS[k] = 0
    want = fresh(p, batched)
    for n in chunks:
        want = table_step_loop(p, want, n)
    assert_states_equal(got, want)
    assert counts == dict(t_et.REBUILDS)
    assert int(got.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_dense_runner_with_dead_block_equals_step_loop(case, batched, monkeypatch):
    """The per-bot DENSE runner at 4-step blocks over the same chunks equals
    ``make_step`` (``make_step_batched``) one step at a time, bit for
    bit."""
    monkeypatch.setattr(t_engine, "BLOCK_STEPS", 4)
    p = dead_params(case, force_backend=pt.ForceBackend.DENSE)
    chunks = CASES[case][1]
    make = t_engine.make_run_chunk_batched if batched else t_engine.make_run_chunk
    got = run_chunks(make(p, "cpu"), fresh(p, batched), chunks)
    step = (t_engine.make_step_batched if batched else t_engine.make_step)(p, "cpu")
    want = fresh(p, batched)
    for _ in range(sum(chunks)):
        want = step(want)
    assert_states_equal(got, want)
    assert int(got.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_runner_with_dead_block_equals_step_pieces(case, batched, monkeypatch):
    """The sharded loop on ``LocalRing(2)`` over the same chunks (40 bots:
    its blocks, the dead step's all-gathered ``topk`` in one) equals the
    loop cut into one-step pieces, each step's draws taken just before it,
    bit for bit with equal stats."""
    p = t_st.resolve_tp_params(dead_params(case, n_cells=40), 2)
    chunks = CASES[case][1]
    make = t_st.make_sharded_table_run_batched if batched else t_st.make_sharded_table_run

    def chunked(run, state):
        stats = []
        for n in chunks:
            state, s = run(state, n)
            stats.append(s)
            assert run.eager_steps == 0
        return state, stats

    got, stats = chunked(make(p, LocalRing(2, "cpu"), with_stats=True)[0], fresh(p, batched))
    real = t_st.table_pieces
    monkeypatch.setattr(t_st, "table_pieces", lambda params, k, start, n: [
        (step,) for pattern in real(params, k, start, n) for step in pattern])
    want, w_stats = chunked(make(p, LocalRing(2, "cpu"), with_stats=True)[0],
                            fresh(p, batched))
    assert_states_equal(got, want)
    assert stats == w_stats
    assert int(got.dead[..., : p.n_cells].sum()) == 3 * (2 if batched else 1)


# ------------------------------------------------ the span path's dead segment

def dead_span_params():
    """:func:`span_params` (128 HEX bots, G=16, gate segments of 12 steps,
    K=4) with 10 bots killed on the segment boundary at step 12."""
    p = span_params(n_dead=10, time_to_dead=0.12)
    assert p.resolved_grid_dim() == 16 and t_et.gate_seg(p) == 12 and p.dead_step == 12
    return p


@pytest.mark.parametrize("fail", [(), (1,)], ids=["adopted", "redone"])
@pytest.mark.parametrize("batched", [False, True])
def test_span_dead_segment_equals_one_read_per_segment(batched, fail, forced_spans):
    """Three 12-step segments and a 5-step regular tail, the second segment
    opening with the dead step: the runner (its segment, dead step
    included, one piece that decides adopt-or-redo with ``ops/cond.branch``)
    equals the one-read-per-segment reference bit for bit, every
    generator's state included, with equal redos, rebuild counts and
    launch counts; with the dead segment's spans failed, its redo replays
    the first block with the same scores and kills the same bots."""
    p = dead_span_params()
    seg = t_et.gate_seg(p)
    forced_spans["fail"] = set(fail)
    n_steps = 3 * seg + 5
    run = (t_et.make_run_chunk_table_batched if batched else t_et.make_run_chunk_table)(p)
    assert run.path_info["use_mega"]
    got, launches, rebuilds = counted_run(lambda: run(fresh(p, batched, (2, 3)), n_steps, True))
    counts = {"redos": 0}
    want, w_launches, w_rebuilds = counted_run(
        lambda: reference_span_chunk(p, fresh(p, batched, (2, 3)), n_steps, counts))
    assert_states_equal(got, want)
    assert run.redos == counts["redos"] == len(fail)
    assert (launches, rebuilds) == (w_launches, w_rebuilds)
    assert run.eager_steps == 0
    assert int(got.dead[..., : p.n_cells].sum()) == 10 * (2 if batched else 1)


# ------------------------------------------------------------ against JAX

# the dead step at 13, mid-block in the second chunk, which ends in a
# 1-step tail: 15 steps (the sharded loop's summation order parts from the
# single table's by 2.6e-4 in velocity after 19)
JAX_CHUNKS = (6, 9)


@pytest.mark.parametrize("backend", ["PALLAS", "DENSE", "sharded"])
def test_dead_chunks_match_jax_on_jax_draws(backend):
    """Two chunks (6 + 9 steps, the dead step at 13 mid-block in the
    second, which ends in a 1-step tail) on JAX's draws: the table loop
    (PALLAS), the per-bot runner (DENSE) and the sharded loop on
    ``LocalRing(2)`` (40 bots) against the JAX package's single-scene
    chunks over the same chunks."""
    kw = dict(time_to_dead=0.13)
    if backend == "sharded":
        # JAX's single table at the grid the two shards resolve
        g = t_st.resolve_tp_params(jax_pair("PALLAS", n_cells=40, **kw)[1], 2).grid_dim
        jp, tp = jax_pair("PALLAS", n_cells=40, grid_dim=g, **kw)
        run_t, tp2 = t_st.make_sharded_table_run(tp, LocalRing(2, "cpu"))
        assert tp2 == tp
    else:
        jp, tp = jax_pair(backend, **kw)
        run_t = (t_et.make_run_chunk_table(tp) if backend == "PALLAS"
                 else t_engine.make_run_chunk(tp, "cpu"))
    assert jp.dead_step == tp.dead_step == 13
    run_j = j_engine.make_run_chunk(jp) if backend == "DENSE" else j_et.make_run_chunk_table(jp)
    st = jittered(jp)
    ts = port_state(tp, arrays_of(st))
    for n in JAX_CHUNKS:
        st, ts = run_j(st, n), run_t(ts, n)
    assert_close(state_to_arrays(ts), arrays_of(st), tp.n_cells)


SPAN_TOL = {"pos": 2e-4, "rad": 2e-4, "phase": 1e-4, "centroid_ring": 1e-5}


def test_span_dead_segment_matches_jax_span_chunk(monkeypatch):
    """256 HEX bots on G=16, gate segments of 8 steps (one gated block and
    one span each), 20 bots killed on the boundary at step 8: 24
    seg-aligned steps of the port's span path on JAX's draws against the
    JAX package's span chunk."""
    monkeypatch.delenv("PBOT_MEGA", raising=False)
    jp, tp = jax_pair("PALLAS", n_cells=256, n_dead=20, time_to_dead=0.08,
                      centroid_int=0.08, phase_update_interval=0.16, phase_std=0.0,
                      light_x=-5.0, light_y=0.0)
    assert t_et.gate_seg(tp) == j_et.gate_seg(jp) == 8 and tp.dead_step == 8
    run_j = j_et.make_run_chunk_table(jp)
    run_t = t_et.make_run_chunk_table(tp)
    assert run_j.path_info["use_mega"] is True and run_t.path_info["use_mega"]
    st = jittered(jp)
    ts = port_state(tp, arrays_of(st))
    want = arrays_of(run_j(st, 24, True))
    got = state_to_arrays(run_t(ts, 24, True))
    for k, tol in SPAN_TOL.items():
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["dead"], want["dead"])
    assert int(got["dead"][: tp.n_cells].sum()) == 20 and run_t.redos == 0
    assert int(got["step"]) == int(want["step"]) == 24
