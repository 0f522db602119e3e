"""The benchmark of ``clip_gp_tpu_torch`` on one H100: the cells of
``BENCHMARK.json``, run one at a time by ``run.py``."""
