"""The general generator: a cell's inputs, made from its configuration, its
traffic mix and ``--seed``, and the program's entry that steps them.

A traffic mix (``traffic/<mix>.json``) says how the scenes are driven:

* ``scenes``: 1 runs one scene through ``Simulation.step_chunk`` (the
  runner of ``engine.make_run_chunk``), the path of a single scenario
  run; more run that many seeds in one lockstep batch through
  ``engine.make_run_chunk_batched``, the path of a seed sweep;
* ``chunk_steps``: steps per chunk, each ended by the host read the user's
  loop makes (``read``: ``state``, the bots' positions, velocities and
  radii a CSV dump copies; ``centroids``, each scene's centroid a sweep
  records).

Scene ``b`` of a run with seed ``s`` has seed ``s + b``: its RANDOM layout
and its phase noise (``draws.SeedDraws``) are drawn from it; a HEX layout
is the same for every seed.
"""

from __future__ import annotations

import sys

import numpy as np

from . import layouts, reference
from .draws import SeedDraws


def program_params(config: dict, cfg_dir, seed: int):
    """The port's ``SimParams`` of a configuration: its upstream ``.cfg``
    (a frozen copy beside the configuration's file) or the defaults,
    updated by the file's ``params``, with ``seed``.  Raises ValueError
    where a value the file states differs from the one the program
    runs."""
    from particlerobotsimulations_torch.config import Config, SimParams, load_cfg

    params = load_cfg(str(cfg_dir / config["cfg"])) if config.get("cfg") else SimParams()
    stated = config.get("params", {})
    if not config.get("cfg"):
        stated_fields = {k: _tuples(v) for k, v in stated.items()}
        params = params.replace(**stated_fields)
    params = params.replace(seed=int(seed), config=Config[config["layout"]])
    for key, value in stated.items():
        if _tuples(value) != _tuples(getattr(params, key)):
            raise ValueError(f"{config['name']}: {key} runs as {getattr(params, key)!r}, "
                             f"the configuration states {value!r}")
    return params.validate()


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def positions(config: dict, p: dict, seed: int) -> np.ndarray:
    """(n, 2) float32 initial positions of one scene."""
    if config["layout"] == "HEX":
        return layouts.hex_layout(p["n_cells"], p["min_radius"])
    if config["layout"] == "RANDOM":
        return layouts.random_accretion(p["n_cells"], p["min_radius"],
                                        p["max_radius"] * 2.0, seed, p["world_half"])
    raise ValueError(f"no layout rule for {config['layout']}")


class Workload:
    """One cell's scenes on ``device``: ``initial()`` makes the program's
    state, ``advance(state, n)`` steps it through the program's entry,
    ``read(state)`` makes the user's host read and says which scenes are
    finite, ``arrays(state, b)`` are scene ``b``'s fields (real bots)."""

    def __init__(self, config: dict, traffic: dict, seed: int, cfg_dir, device="cuda"):
        import torch

        from particlerobotsimulations_torch.config import ForceBackend
        from particlerobotsimulations_torch.engine import make_run_chunk_batched
        from particlerobotsimulations_torch.engine_table import REBUILDS, gate_seg

        self.device = torch.device(device)
        self.traffic = traffic
        self.p = reference.params_of(config)
        self.p["seed"] = int(seed)
        self.params = program_params(config, cfg_dir, seed)
        self.n = self.params.n_cells
        self.scenes = int(traffic["scenes"])
        self.seeds = [int(seed) + b for b in range(self.scenes)]
        self.draws = [SeedDraws(s) for s in self.seeds]
        self.pos0 = [positions(config, self.p, s) for s in self.seeds]
        self.backend = self.params.resolved_backend(self.device)
        self.seg = gate_seg(self.params) if self.backend == ForceBackend.PALLAS else 0
        self.rebuilds = REBUILDS
        self.sim = None
        self.runner = None
        if self.scenes == 1:
            from particlerobotsimulations_torch.sim import Simulation

            self.sim = Simulation(self.params, state=self.initial(), device=self.device)
            self.runner = self.sim._run_chunk
        else:
            self.runner = make_run_chunk_batched(self.params, self.device)

    def initial(self):
        """A fresh program state of every scene at step 0."""
        from particlerobotsimulations_torch.state import make_state, stack_states

        states = [make_state(self.params, pos, device=self.device).replace(generator=d)
                  for pos, d in zip(self.pos0, self.draws)]
        return states[0] if self.scenes == 1 else stack_states(states)

    def advance(self, state, n_steps: int):
        if self.sim is not None:
            self.sim.state = state
            self.sim.step_chunk(n_steps, start_step=state.step)
            return self.sim.state
        aligned = self.seg > 0 and state.step % self.seg == 0
        return self.runner(state, n_steps, aligned)

    def read(self, state) -> list:
        """The host read that ends a chunk; one flag per scene: finite."""
        if self.traffic["read"] == "state":
            self.sim.state = state
            return [all(bool(np.isfinite(a).all()) for a in self.sim.host_view())]
        c = state.pos[:, : self.n].mean(dim=1).cpu().numpy()
        return [bool(np.isfinite(row).all()) for row in c]

    def arrays(self, state, b: int) -> dict:
        """Scene ``b``'s fields, real bots only, copied off the program's
        buffers."""
        get = (lambda t: t) if self.scenes == 1 else (lambda t: t[b])
        out = {k: get(getattr(state, k))[: self.n].clone() for k in reference.FIELDS}
        out["centroid_ring"] = get(state.centroid_ring).clone()
        return out

    def snapshot(self, st) -> list:
        """Scene by scene, the fields of a program state met inside a
        chunk (a bot-order ``SimState``, or a ``TableState`` gathered back
        to bot order as the chunk's exit does), copied at once off the
        buffers the next block overwrites, with ``rows``: each bot's row
        in the table it sits in (``None`` in bot order)."""
        from particlerobotsimulations_torch.engine_table import TableState, exit_table

        rows = [None] * self.scenes
        if isinstance(st, TableState):
            val, bid = st.fields["val"], st.fields["bid"]
            if self.scenes == 1:
                val, bid = val[None], bid[None]
            rows = [_rows_of(val[b], bid[b], self.n) for b in range(self.scenes)]
            st = exit_table(self.params, st.replace(centroid_ring=st.centroid_ring.clone()))
        return [dict(self.arrays(st, b), rows=rows[b]) for b in range(self.scenes)]

    def span_segments(self, state, n_steps: int) -> int:
        """How many gate segments of a chunk of ``n_steps`` entered at
        ``state`` the runner takes through the span path (kernel 3); 0
        where its path has none."""
        segments = getattr(self.runner, "segments", None)
        if segments is None:
            return 0
        return segments(n_steps, self.seg > 0 and state.step % self.seg == 0)

    def redos(self):
        """The span segments the runner redid on the regular path so far
        (a device count: reading it waits for the card), or None where
        the runner keeps no such count (the adaptive and per-bot
        runners)."""
        return getattr(self.runner, "redos", None)

    def span_snapshot(self, tbl, strip, step: int, ring) -> list:
        """:meth:`snapshot` of kernel 3's table and parking-strip planes
        (its input or its answer, at ``step``), gathered to bot order by
        ``bid`` as the chunk's exit gathers a table; ``ring`` stands in
        for the centroid ring, which a span never writes."""
        import torch

        from particlerobotsimulations_torch.engine_table import TableState, _make_mega_glue

        fields = _make_mega_glue(self.params)[1](tbl, strip)
        origin = torch.zeros(tbl.shape[:-3] + (2,), dtype=torch.float32, device=tbl.device)
        return self.snapshot(TableState(fields, origin, int(step), None, ring))

    def rebuild_counts(self) -> tuple:
        return self.rebuilds["incremental"], self.rebuilds["exact"]

    def zero_rebuilds(self) -> None:
        for key in ("incremental", "exact"):
            self.rebuilds[key] = 0

    def settled(self) -> bool:
        """Whether the chunk runner's adaptive cadence, where it has one
        (``runner.live``), runs the faster cadence its last probe
        certified (``runner.last_probe`` within ``path_info["bound8"]``):
        the adaptive table loop enters on the slower one, and a swarm
        placed at rest moves too fast for the faster one for its first
        chunks."""
        if getattr(self.runner, "live", None) is None:
            return True
        probe = self.runner.last_probe
        return probe is not None and probe <= self.runner.path_info["bound8"]

    def live_k(self):
        live = getattr(self.runner, "live", None)
        return None if live is None else live["k"]



def _rows_of(val, bid, n: int):
    """(n,) the table row of each bot, read off the table's occupied rows
    and their bot ids; -1 for a bot in no row."""
    import torch

    occupied = torch.nonzero(val > 0.5).flatten()
    bots = bid[occupied].long()
    keep = bots < n
    rows = torch.full((n,), -1, dtype=torch.int64, device=val.device)
    rows[bots[keep]] = occupied[keep]
    return rows


class _Hook:
    """A ``sys.settrace`` hook on this thread, for the block of a ``with``
    alone: :meth:`_global` sees each call made there."""

    def _global(self, frame, event, arg):
        raise NotImplementedError

    def __enter__(self):
        self._before = sys.gettrace()
        sys.settrace(self._global)
        return self

    def __exit__(self, *exc):
        sys.settrace(self._before)
        return False


class BlockEnds(_Hook):
    """The program's state at block ends inside one chunk, recorded while
    the chunk runs through the cell's own entry.

    A chunk runner enqueues a chunk block by block, each a generator of
    the port that yields after its block (``runner.blocks``), with the
    state it has reached in a local variable.  Under this context, each
    yield of such a generator offers that state, by its step, to
    :meth:`offer`, which keeps the states that the pieces need: for each
    start asked for, the first block end at or after it, and the first at
    least ``length`` steps after that (the piece's end), and the states
    at the steps of ``keep``.  States at or
    after ``stop`` are not taken: the chunk's own answer ends the last
    piece there.  Nothing of the program changes: the hook reads locals
    (``sys.settrace``, on this thread, for the chunk alone)."""

    def __init__(self, wl: "Workload", starts: list, length: int, stop: int, keep=()):
        from particlerobotsimulations_torch.engine_table import TableState
        from particlerobotsimulations_torch.state import SimState

        self.wl, self.length, self.stop = wl, int(length), int(stop)
        self.kinds = (TableState, SimState)
        self.spans = {int(a): [None, None] for a in sorted(set(starts))}
        self.keep = {int(s) for s in keep}
        self.states: dict = {}

    def offer(self, step: int, st) -> None:
        if step in self.states or step >= self.stop:
            return
        need = step in self.keep
        for a, span in self.spans.items():
            if span[0] is None and step >= a:
                span[0], need = step, True
            elif span[0] is not None and span[1] is None and step >= span[0] + self.length:
                span[1], need = step, True
        if need:
            self.states[step] = self.wl.snapshot(st)

    def close(self, step: int, st) -> None:
        """The chunk's answer at its end step ``step``: the end of every
        piece still open."""
        self.states[step] = self.wl.snapshot(st)
        for span in self.spans.values():
            if span[0] is not None and span[1] is None:
                span[1] = step

    def pieces(self) -> list:
        """``[(start asked for, start step, end step)]``, one per start
        asked for; a step is ``None`` where the chunk gave no block end
        for it."""
        return [(a, s, e) for a, (s, e) in self.spans.items()]

    def _local(self, frame, event, arg):
        if event == "return":
            for v in frame.f_locals.values():
                if isinstance(v, self.kinds) and isinstance(v.step, int):
                    self.offer(v.step, v)
        return self._local

    def _global(self, frame, event, arg):
        if (event == "call" and frame.f_code.co_flags & _CO_GENERATOR
                and frame.f_globals.get("__name__", "").startswith(_PORT)):
            return self._local
        return None


class SpanCalls(_Hook):
    """Kernel 3's own spans, recorded while the cell's entry runs a span
    segment eagerly (a fresh runner's first segment of a kind, before its
    capture): for each call of the span function that
    ``ops.megakernel.make_mega_span`` returns, ``(tbl, strip, step, tbl',
    strip')``, its inputs and its answer, cloned at once.  Calls made
    while a CUDA graph is being captured run on the capture's buffers and
    are skipped.  Nothing of the program changes: the hook reads the
    call's arguments and its return value (``sys.settrace``, on this
    thread, for the block of the ``with`` alone)."""

    def __init__(self):
        self.calls: list = []
        self._open = None

    def _local(self, frame, event, arg):
        if event == "return" and arg is not None and self._open is not None:
            tbl, strip = arg
            self.calls.append(self._open + (tbl.clone(), strip.clone()))
            self._open = None
        return self._local

    def _global(self, frame, event, arg):
        if (event != "call" or frame.f_code.co_qualname != _SPAN
                or frame.f_globals.get("__name__") != _MEGA):
            return None
        import torch

        args = frame.f_locals
        tbl, step = args["tbl"], args["step"]
        if tbl.is_cuda and torch.cuda.is_current_stream_capturing():
            return None
        self._open = (tbl.clone(), args["strip"].clone(),
                      step.clone() if torch.is_tensor(step) else int(step))
        frame.f_trace_lines = False
        return self._local


_PORT = "particlerobotsimulations_torch."
_MEGA, _SPAN = _PORT + "ops.megakernel", "make_mega_span.<locals>.span"
_CO_GENERATOR = 0x20
