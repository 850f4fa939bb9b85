"""The benchmark of ``lsm_tpu_torch`` on one NVIDIA H100: ``run.py`` runs
one cell once; the cells, configurations, traffic mixes and per-layer
metrics are the files that ``BENCHMARK.json`` names."""
