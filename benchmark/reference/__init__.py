"""The plain reference the benchmark's check holds the program to: frozen
copies of the port's plain PyTorch modules (each names the file it was
copied from) with an acceleration structure of its own (``ops/lbvh.py``).
Nothing here imports the program, JAX or the JAX package."""
