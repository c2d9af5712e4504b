"""PyTorch port, the incremental-or-exact rebuild choice, on the CPU.

``ops/cond.cond`` is the port's counterpart of the JAX package's
``lax.cond`` around the slot rebuild.  On the card, inside a captured CUDA
graph, it becomes kernel ``cond_set`` and a conditional IF node whose body
holds the exact rebuild (``csrc/graph_cond.cu``; held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Everywhere else it
is the plain form held here: both branches run and a select keeps one,
reading nothing on the host.

Held here: the plain ``cond`` on single and batched carries with every
tensor-to-host conversion made to raise; ``engine_table._choose_rebuild``
against the JAX package's ``_smart_rebuild`` and
``_smart_rebuild_batched`` on 64-bot tables at G=16, forced into each
branch; the sharded ``sharded_rebuild`` on ``LocalRing(2)`` (G=32, the
smallest grid the shard geometry takes), joined into the whole table,
against the JAX package's rebuild of the same table, which is what the
JAX sharded loop's ``take_inc`` (the halo compaction) and ``take_exact``
(the global rebuild, split) compute; and the new entry points' argument
types against ``csrc/graph_cond.cu``.  A rebuild only moves data and
re-derives the payload planes with the same float32 expressions, so the
tolerance is none: elementwise equal.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particlerobotsimulations_torch as pt
import particlerobotsimulations_tpu as pj
from particlerobotsimulations_torch import engine_table as t_et
from particlerobotsimulations_torch import kernels
from particlerobotsimulations_torch.ops.cond import cond
from particlerobotsimulations_torch.parallel import spatial_table as t_st
from particlerobotsimulations_torch.parallel.ring import LocalRing
from particlerobotsimulations_tpu import engine_table as j_et

# The port's CPU tests run small tables: one intra-op thread is faster than
# a pool, and pools oversubscribe the cores when test workers share them.
torch.set_num_threads(1)

f32 = np.float32
# what the plain cond must not call on a tensor: each converts it to a
# Python value
HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu",
              "numpy")


def refuse_host_reads(monkeypatch):
    def refuse(name):
        def read(self, *args, **kw):
            raise AssertionError(f"cond called Tensor.{name}")
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("pred", [True, False])
def test_plain_cond_takes_one_branch_without_a_host_read(lead, pred, monkeypatch):
    """The plain form is ``take_inc``'s result where ``pred`` holds, else
    ``take_exact``'s, for every entry (fields of a scene or of a batch, and
    an origin), calling each branch once on the operands and converting no
    tensor to a Python value."""
    rng = np.random.default_rng(5)
    ops = {k: torch.from_numpy(rng.standard_normal(lead + (40,)).astype(f32))
           for k in ("px", "py", "val")}
    ops["origin"] = torch.from_numpy(rng.standard_normal(lead + (2,)).astype(f32))
    inc = {k: v + 1.0 for k, v in ops.items()}
    exact = {k: v * 2.0 for k, v in ops.items()}
    calls = []

    def branch(name, result):
        def take(operands):
            assert operands is ops
            calls.append(name)
            return result
        return take

    p = torch.tensor(pred)
    with monkeypatch.context() as m:
        refuse_host_reads(m)
        out = cond(p, branch("inc", inc), branch("exact", exact), ops)
    assert sorted(calls) == ["exact", "inc"]
    assert list(out) == list(inc)
    for k in ops:
        assert torch.equal(out[k], (inc if pred else exact)[k]), k


def params(**kw):
    base = dict(n_cells=64, n_dead=0, seed=3, config=pt.Config.HEX,
                force_backend=pt.ForceBackend.PALLAS, phase_std=0.0,
                light_x=-5.0, light_y=0.0, grid_dim=16)
    base.update(kw)
    return pt.SimParams(**base).validate()


def entered(p, seed=0, steps=2):
    """A table carry of a fresh scene after ``steps`` steps without a
    rebuild, the next step's integrate done (where a rebuild runs)."""
    sim = pt.Simulation(p.replace(seed=seed), device="cpu")
    ts = t_et.enter_table(sim.params, sim.state)
    step = t_et.make_table_step(sim.params)
    for _ in range(steps):
        ts = step(ts, False, False, False, False)
    pre, _ = t_et.make_table_step_parts(sim.params)
    return pre(ts, False, False, False)


def moved_far(p, fields: dict) -> dict:
    """``fields`` with one occupied row moved two cells in x: the
    incremental rebuild's >1-cell precondition fails."""
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    rows = torch.nonzero(fields["val"][: g * g * cs] > 0.5).flatten()
    px = fields["px"].clone()
    px[rows[len(rows) // 2]] += f32(2.0) * f32(p.cutoff())
    return {**fields, "px": px}


def jax_table(p, fields, origin):
    """The JAX package's table carry of the same planes."""
    jf = {k: jnp.asarray(v.numpy()) for k, v in fields.items()}
    lead = origin.shape[:-1]
    return j_et.TableState(jf, jnp.asarray(origin.numpy()), jnp.zeros(lead, jnp.int32),
                           None, jnp.zeros(lead + (2, 2), jnp.float32))


def jax_params(p):
    return pj.SimParams(**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def assert_fields_equal(got: dict, got_origin, want: dict, want_origin):
    for k in t_et.TABLE_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got_origin.numpy(), np.asarray(want_origin))


@pytest.mark.parametrize("carry", ["single", "batched"])
@pytest.mark.parametrize("branch", ["incremental", "exact"])
def test_choose_rebuild_matches_jax_smart_rebuild(branch, carry):
    """``_choose_rebuild`` taken into each branch (a clean carry; one bot
    moved two cells) against the JAX package's ``_smart_rebuild``, and on
    a batch of two scenes (the second forced) against
    ``_smart_rebuild_batched``, which takes the exact rebuild for both
    when one scene fails: equal planes and origin, ``ok`` as chosen."""
    p = params()
    ts = entered(p, seed=0)
    if branch == "exact":
        ts = ts.replace(fields=moved_far(p, ts.fields))
    if carry == "batched":
        other = entered(p, seed=1)
        ts = t_et.TableState(
            {k: torch.stack([other.fields[k], ts.fields[k]]) for k in t_et.TABLE_FIELDS},
            torch.stack([other.origin, ts.origin]), ts.step, None,
            torch.stack([other.centroid_ring, ts.centroid_ring]))
    got, ok = t_et._choose_rebuild(p, ts)
    assert bool(ok) == (branch == "incremental")
    jts = jax_table(p, ts.fields, ts.origin)
    jp = jax_params(p)
    want = (j_et._smart_rebuild(jp, jts) if carry == "single"
            else j_et._smart_rebuild_batched(jp, jts))
    assert_fields_equal(got.fields, got.origin, want.fields, want.origin)


def joined(p, n_shards, f):
    """The whole table's fields of a ``LocalRing``'s (S, Cs*L0 + n_pad)
    shard-local fields: the shards' lane blocks side by side, then the
    strip."""
    g, cs = p.resolved_grid_dim(), p.storage_capacity()
    l0 = g * g // n_shards
    out = {}
    for k in t_et.TABLE_FIELDS:
        centre = f[k][:, : cs * l0].reshape(n_shards, cs, l0).permute(1, 0, 2).reshape(-1)
        out[k] = torch.cat([centre, f[k][0, cs * l0:]])
    return out


@pytest.mark.parametrize("branch", ["incremental", "exact"])
def test_sharded_rebuild_matches_jax_rebuild(branch):
    """``sharded_rebuild`` on ``LocalRing(2)`` taken into each branch,
    joined into the whole table, against the JAX package's rebuild of that
    table: the halo compaction equals the whole table's (the JAX sharded
    ``take_inc``), the exact branch the global argsort rebuild (its
    ``take_exact``): equal planes and origin, ``ok`` as chosen."""
    n_shards = 2
    run, p = t_st.make_sharded_table_run(params(grid_dim=0), LocalRing(n_shards, "cpu"))
    assert p.resolved_grid_dim() == 32
    ts = entered(p, seed=2)
    fields = moved_far(p, ts.fields) if branch == "exact" else ts.fields
    local = run.parts["split_local"](fields)
    got, origin, ok = run.parts["rebuild"](local, ts.origin)
    assert bool(ok) == (branch == "incremental")
    want = j_et._smart_rebuild(jax_params(p), jax_table(p, fields, ts.origin))
    assert_fields_equal(joined(p, n_shards, got), origin, want.fields, want.origin)


def test_signatures_declare_the_conditional_node_entry_points():
    """Every entry point of ``csrc/graph_cond.cu`` is declared in
    ``kernels.SIGNATURES`` with one argument type per C parameter (a
    pointer or handle as a 64-bit type), and kernel ``cond_set`` has its
    launch count."""
    src = (kernels.CSRC / "graph_cond.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (pbot_\w+)\(([^)]*)\)', src))
    assert set(decls) == {
        "pbot_cond_handle", "pbot_cond_set", "pbot_cond_node", "pbot_cond_body_begin",
        "pbot_cond_body_end",
    }
    for name, args in decls.items():
        argtypes = kernels.SIGNATURES[name]
        assert len(argtypes) == len(args.split(",")), name
        for decl, t in zip(args.split(","), argtypes):
            wide = "*" in decl or "long long" in decl
            assert wide == (t in (kernels._vp, kernels._ull)), (name, decl)
    assert "cond_set" in kernels.LAUNCHES
