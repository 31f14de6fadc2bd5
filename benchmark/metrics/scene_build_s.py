"""``scene_build_s``: the program's own span of the scene build,
``Scene.build_seconds`` (host clock around the BVH build and the tables'
upload)."""


def read(records):
    return records.get("scene_build_s")
