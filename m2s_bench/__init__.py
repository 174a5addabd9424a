"""The benchmark of mesh2splat_torch on one CUDA card: ``run.py`` runs one
cell of ``BENCHMARK.json`` once and prints its result line."""
