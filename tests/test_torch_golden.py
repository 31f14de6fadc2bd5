"""The port reproduces the JAX package's golden images on the CPU.

Same scenes, seeds and sample counts as tests/test_golden.py and
tests/test_golden_glass.py, compared at their tolerance (rtol 2e-4,
atol 1e-5) on every pixel that no near-tie sample reaches, and the
unidirectional image on every pixel.  Near ties are found, not guessed: the
JAX renderer runs beside the port with every cast's triangle ids recorded
(tests/torch_parity.py), and a sample slot whose casts disagree is a near
tie.  How many rays disagree, and how many pixels they reach, is bounded.
The JAX run is also held to its own golden, so the recording provably did
not move it.
"""

import os

import jax
import numpy as np
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu.models import icosphere
from clive2_tpu_torch.geometry import TriangleSoup as TorchSoup
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
SIZE, SPP = 24, 4
# (state field, golden key, whether near ties may move it)
FIELDS = (("summed_image", "image", True), ("summed_weight", "weight", True),
          ("summed_unidirectional", "uni", False))


def _render_both(jax_scene, torch_scene, seed):
    jax_renderer._make_step.cache_clear()    # trace anew, with recording
    jax.clear_caches()
    jr = c2.Renderer(jax_scene, seed=seed)
    tr = ct.Renderer(torch_scene, seed=seed)
    with NearTies() as ties:
        for _ in range(SPP):
            jr.run_sample()
            tr.run_sample()
    return jr, tr, check_ties(ties, SIZE, SIZE)


def _check(golden_file, jr, tr, near):
    g = np.load(os.path.join(HERE, golden_file))
    none = np.zeros_like(near)
    for ours, key, tied in FIELDS:
        assert_match(jr.state[ours], g[key], none, f"JAX {key}")
        assert_match(tr.state[ours].numpy(), g[key], near if tied else none,
                     f"port {key}")


def test_golden_cornell():
    jr, tr, near = _render_both(
        c2.create_scene_from_preset("empty", SIZE, SIZE),
        ct.create_scene_from_preset("empty", SIZE, SIZE, device="cpu"),
        seed=1234)
    _check("golden_cornell.npz", jr, tr, near)


def _glass_scene(pkg, soup_cls, **kw):
    v, f = icosphere(1)
    soup = soup_cls.from_vertices(
        (v[f] * 1.6 + np.array([0.0, 0.6, 1.0])).astype(np.float32),
        material=5)
    return pkg.create_scene(
        pixel_width=SIZE, pixel_height=SIZE,
        cam_center=np.array([0, 1.5, 6]),
        cam_direction=np.array([0, 0, -1.0]),
        extra_geometry=soup, **kw,
    )


def test_golden_glass():
    jr, tr, near = _render_both(_glass_scene(c2, JaxSoup),
                                _glass_scene(ct, TorchSoup, device="cpu"), seed=4321)
    _check("golden_glass.npz", jr, tr, near)
