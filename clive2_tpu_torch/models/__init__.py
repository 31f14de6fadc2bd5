"""Procedural mesh generators.

The reference ships no assets in its snapshot (scene presets point at
``../resources/*.obj|*.ply``, scene.py:159-200).  This module provides
procedural generators used both as test fixtures and as documented
stand-ins for the missing Utah-teapot / Stanford-dragon files
(scripts/make_assets.py writes them into resources/).
"""

from .primitives import (  # noqa: F401
    displaced_blob,
    displaced_blob_exact,
    icosphere,
    revolve,
    teapot_like,
    uv_sphere,
)
from .teapot import utah_teapot  # noqa: F401
