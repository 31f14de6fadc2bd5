"""Map a JAX package scene onto the port's tensors.

``scene_data_from_jax`` takes a ``clive2_tpu`` ``Scene.data`` converted to
numpy (for example ``jax.tree.map(np.asarray, scene.data)``) and returns the
port's scene dict on ``device``, adding the kernel tables the device needs.
The JAX package's own traversal tables for TPU kernels are not used: the
port derives what it needs from the gather walk's rows, which every JAX BVH
scene carries, through ``scene.traversal_tables``, so a converted scene
follows the same selectors (``CLIVE2_TRAVERSAL``, ``CLIVE2_STREAM_IMPL``)
as one the port builds.  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .scene import to_device, traversal_tables


def scene_data_from_jax(np_tree, device="cpu"):
    device = torch.device(device)
    data = {k: dict(np_tree[k]) for k in ("tri", "bvh", "mat", "lights",
                                          "camera")}
    data["bvh"] = {k: data["bvh"][k] for k in ("node_packed", "leaf_packed")}
    data["camera"] = {k: np.asarray(v, np.float32)
                      for k, v in data["camera"].items()}
    if "brute" in np_tree:
        # CPU-built scene: v0/e1/e2 rows, padded past the triangle count
        # with degenerate triangles (dropped here)
        b = np_tree["brute"]
        n = data["tri"]["packed"].shape[0]
        tris = np.zeros((n, 10), dtype=np.float32)
        tris[:, 0:3] = b["v0"][:n]
        tris[:, 3:6] = b["e1"][:n]
        tris[:, 6:9] = b["e2"][:n]
        data["brute"] = dict(tris=tris)
    elif "brute_pallas" in np_tree:
        # TPU-built scene: the flat [T * 10] SMEM table
        b = np_tree["brute_pallas"]
        n = int(np.asarray(b["n"]).reshape(-1)[0])
        data["brute"] = dict(tris=np.asarray(b["tris"]).reshape(-1, 10)[:n])
    else:
        data["camtri"] = dict(np_tree["camtri"])
        n_world = int((np.asarray(data["tri"]["is_camera"]) == 0).sum())
        data.update(traversal_tables(data["bvh"], n_world,
                                     cuda=device.type == "cuda"))
    return to_device(data, device)
