"""clive2_tpu_torch: the PyTorch + CUDA port of clive2_tpu's BDPT renderer.

A second package beside the JAX reference, with the same module names.  The
main path is ``create_scene*`` -> ``Renderer.run_sample()``: one BDPT sample
(merged camera + light subpath trace, one batched connection cast, MIS, t=1
splats, 3x3 filter) with every intersection going through a hand-written
CUDA kernel on the card (``csrc/``) and through that kernel's plain PyTorch
version on the CPU.  This package imports no JAX.
"""

from .camera import Camera, tone_map  # noqa: F401
from .materials import MaterialTable, default_materials  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .scene import (  # noqa: F401
    Scene,
    create_scene,
    create_scene_from_preset,
    create_scene_from_preset_with_params,
    orbit_camera,
    scene_presets,
)

__version__ = "0.1.0"
