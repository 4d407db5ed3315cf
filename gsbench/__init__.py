"""The benchmark of litegs_torch on one H100.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, each a
configuration (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``, whose ``loop`` names a module of
``loops/`` and ``kind``, where it is there, the metrics it reports), and
the metrics, each read by ``metrics/<name>.py``.  A
cell's correctness limits are ``limits/<cell>.json``; the reference it is
held to is ``reference/``.
"""
