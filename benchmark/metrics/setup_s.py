"""``setup_s``: from the process's start to the first sample of the
window: imports, the CUDA context, the kernel library's build or load,
the mesh written or found, the scene and BVH build and the warm-up
samples."""


def read(records):
    return records.get("setup_s")
