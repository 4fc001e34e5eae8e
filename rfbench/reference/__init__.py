"""The plain PyTorch reference of the models the benchmark runs.

It imports neither JAX nor anything of the program under test.
"""
