"""The port's counterparts of the JAX package's tools in ``scripts/``.

Those that run TPU kernels: ``kernel_stats`` and ``kernel_microbench``
(the packet walk, ops/packet_walk.py), ``link_probe`` (the host-to-card
check) and ``probe_mosaic_layouts`` (the layout probes).  Those that drive
the renderer: ``make_assets`` (the presets' meshes), ``smoke_render``,
``compare_images``, ``parity_render`` (the reference's default still
workload), ``profile_stages`` (one sample by stage) and ``movie_launcher``
(movie frames over worker processes).  The diagnostics: ``diag_mis`` (the
estimator's strategies, one by one, against the unidirectional image),
``shade_ab`` (the shading pass's lobes against their floors) and
``shadow_cache_study`` (how many connection casts last sample's occluder
would settle).  Each runs as ``python -m
clive2_tpu_torch.scripts.<name>``, on the card unless ``--device cpu`` (or
``--cpu``, where the JAX script has that flag) is given; ``make_assets``
and ``compare_images`` use no device.  The port's own tools:
``launch_cost`` times the kernels' launch path on the card, for one
checkout or several in turns (``python3
clive2_tpu_torch/scripts/launch_cost.py --root A --root B``)."""
