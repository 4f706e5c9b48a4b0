"""The benchmark of the PyTorch and CUDA port ``ggnn_torch``.

``python3 annbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. See
``annbench/README.md``.
"""
