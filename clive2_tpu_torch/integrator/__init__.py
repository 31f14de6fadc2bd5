from .connect import connect_paths  # noqa: F401
from .render import render_sample  # noqa: F401
from .trace import (  # noqa: F401
    generate_camera_rays,
    generate_light_rays,
    trace_subpaths,
)
