"""The benchmark of ``particlerobotsimulations_torch`` on one H100.

``BENCHMARK.json`` at the checkout's root names the cells; ``run.py`` runs
one (``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``).  Everything that measures lives here and imports
nothing of the JAX package: the inputs (``layouts.py``, ``draws.py``,
``workload.py``), the plain reference and the check (``reference.py``,
``check.py``), the roofline arithmetic (``roofline.py``), the trace's
reduction (``trace.py``) and one reader per per-layer metric
(``metrics/``).
"""
