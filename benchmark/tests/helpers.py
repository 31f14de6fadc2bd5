"""Small cells for the CPU tests: the manifest's cells at a few pixels,
run through the harness on the CPU."""

from __future__ import annotations

import argparse
import os

import numpy as np

from benchmark import manifest, run

BLOB = dict(file="blob.ply", generator=dict(kind="displaced_blob_exact",
                                            triangles=3000),
            material=4, scale=50.0, offset=[0.0, -4.0, 0.0])


def small_cell(workload="cornell.1080p", width=32, height=18, **traffic):
    c = manifest.cell(manifest.load_manifest(), workload)
    c["traffic"] = dict(c["traffic"], width=width, height=height, **traffic)
    return c


def blob_config():
    """A BVH configuration small enough for the CPU: the sponza camera and
    a 3,000-triangle blob."""
    c = manifest.cell(manifest.load_manifest(), "sponza.1080p")["config"]
    return dict(c, scene=dict(c["scene"], meshes=[BLOB]))


def args(workload, seed=2**31 + 11, seconds=1.0, trace=0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)


def run_small(c, tmp_path, seed=2**31 + 11, seconds=1.0, trace=0):
    return run.run(c, args(c["workload"]["name"], seed, seconds, trace),
                   device="cpu", resources=str(tmp_path))


def blob_scene(tmp_path, width, height):
    """The program's scene of ``blob_config`` on the CPU (mesh written by
    the benchmark's generator)."""
    import clive2_tpu_torch as ct

    from benchmark import meshgen

    config = blob_config()
    meshgen.ensure_meshes(config, str(tmp_path))
    cam = config["scene"]["camera"]
    return config, ct.create_scene(
        pixel_width=width, pixel_height=height,
        cam_center=np.array(cam["center"]),
        cam_direction=np.array(cam["direction"]),
        file_specs=[dict(file_path=os.path.join(str(tmp_path), BLOB["file"]),
                         material=BLOB["material"], scale=BLOB["scale"],
                         offset=np.array(BLOB["offset"]))],
        device="cpu")
