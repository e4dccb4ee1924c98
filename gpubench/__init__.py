"""The benchmark of the PyTorch and CUDA port (``stochastic_gcn_tpu_torch``).

``python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
configurations (``configs/``), traffic mixes (``traffic/``), correctness
limits (``limits/``) and per-layer metrics (``metrics/<name>/``) are files
found by name; nothing here imports JAX or the JAX package.
"""
