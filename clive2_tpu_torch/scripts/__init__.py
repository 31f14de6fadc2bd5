"""The port's counterparts of the JAX package's tools in ``scripts/`` that
run TPU kernels: ``kernel_stats`` and ``kernel_microbench`` (the packet
walk, ops/packet_walk.py) and ``link_probe`` (the host-to-card check).
Each runs as ``python -m clive2_tpu_torch.scripts.<name>``, on the card
unless ``--device cpu`` is given."""
