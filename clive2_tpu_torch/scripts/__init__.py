"""The port's counterparts of the JAX package's tools in ``scripts/`` that
run TPU kernels: ``kernel_stats`` and ``kernel_microbench`` (the packet
walk, ops/packet_walk.py), ``link_probe`` (the host-to-card check) and
``probe_mosaic_layouts`` (the layout probes).  Each runs as ``python -m
clive2_tpu_torch.scripts.<name>``, on the card unless ``--device cpu`` is
given.  ``launch_cost`` times the kernels' launch path on the card, for
one checkout or several in turns (``python3
clive2_tpu_torch/scripts/launch_cost.py --root A --root B``)."""
