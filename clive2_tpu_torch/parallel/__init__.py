from .mesh import (TileMesh, make_tile_mesh, resolve_device,  # noqa: F401
                   tile_rows)
