"""The benchmark of the PyTorch/CUDA port (``katsdpimager_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Configurations (``configs/``), traffic mixes (``traffic/``)
and per-layer metrics (``metrics/``) are files of their own, found by the
names in the manifest; ``runners/`` holds the entry each mix calls,
``gen/`` the frozen input generators, ``reference/`` the plain reference
that decides ``correct`` and ``common/`` the trace reading and the
card's peaks.
"""
