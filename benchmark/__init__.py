"""The benchmark of the PyTorch and CUDA renderer ``clive2_tpu_torch``:
one command runs one cell of ``BENCHMARK.json`` once (``run.py``).  Nothing
here imports JAX or the JAX package, and the reference (``reference/``)
imports nothing of the program."""
