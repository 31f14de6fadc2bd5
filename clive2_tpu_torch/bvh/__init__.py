from .build import FlatBVH, build_bvh  # noqa: F401
