"""The benchmark of ``renderformer_tpu_torch``, the PyTorch/CUDA port, on H100s.

``python3 -m rfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once.  The harness finds a cell's
configuration, traffic mix, correctness limits and metrics by name
(``rfbench/registry.py``); the plain reference that decides ``correct``
lives in ``rfbench/reference`` and imports nothing of the program.
Nothing here imports JAX or the JAX package ``renderformer_tpu``.
"""
