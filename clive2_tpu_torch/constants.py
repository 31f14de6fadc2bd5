"""Global tunables and color constants.

TPU-native rebuild of the reference's ``src/constants.py`` (see
reference src/constants.py:4-36).  Values are kept numerically identical
so scenes render pixel-comparable; color order stays BGR like the reference
(which targeted cv2; constants.py:16 notes "cv2 color order").
"""

from __future__ import annotations

import time

import numpy as np

# camera constants (reference constants.py:5)
H_FOV = 110.0 * np.pi / 180.0

# unit directions
UNIT_X = np.array([1.0, 0.0, 0.0], dtype=np.float64)
UNIT_Y = np.array([0.0, 1.0, 0.0], dtype=np.float64)
UNIT_Z = np.array([0.0, 0.0, 1.0], dtype=np.float64)
ZERO_VECTOR = np.zeros(3, dtype=np.float64)
INF = np.array([np.inf, np.inf, np.inf])
NEG_INF = -INF

# BGR color order, [0, 1] (reference constants.py:16-24)
BLACK = np.array([0.0, 0.0, 0.0])
WHITE = np.array([0.7, 0.7, 0.7])
FULL_WHITE = np.array([1.0, 1.0, 1.0])
GRAY = np.array([0.5, 0.5, 0.5])
RED = np.array([0.3, 0.3, 0.8])
GREEN = np.array([0.541, 0.807, 0.0])
BLUE = np.array([0.8, 0.3, 0.3])
CYAN = np.array([0.8, 0.8, 0.3])

# BVH constants (reference constants.py:28-29)
MAX_MEMBERS = 8          # max triangles per leaf
MAX_DEPTH = 32           # build stack cap

# path-tracing constants (reference renderer.py:8, trace.metal:407)
MAX_BOUNCES = 6          # vertices stored per subpath
DELTA = 1e-4             # ray epsilon (trace.metal:5)

# default Cornell-style room (reference constants.py:33-36)
DEFAULT_BOX_MIN_CORNER = np.array([-10.0, -2.0, -10.0])
DEFAULT_BOX_MAX_CORNER = np.array([10.0, 10.0, 10.0])
DEFAULT_LIGHT_HEIGHT = 0.95
DEFAULT_LIGHT_SCALE = 0.25


def timed(func):
    """Wall-clock decorator, parity with reference constants.py:39-49.

    Controlled by the module-global ``TIMED_ENABLED`` so benchmarks can
    silence it.
    """

    def wrapper(*args, **kwargs):
        if not TIMED_ENABLED:
            return func(*args, **kwargs)
        start_time = time.time()
        result = func(*args, **kwargs)
        end_time = time.time()
        print(f"Function {func.__name__} took {end_time - start_time:.4f} seconds")
        return result

    return wrapper


TIMED_ENABLED = False

# CLIVE2_REFERENCE_MIS=1 selects the reference's BDPT estimator verbatim
# (stale junction values in the MIS chain, trace.metal:696-706; no emission
# cosine on the light subpath's first edge; cos/pi junction "BRDFs"; the
# reference store rule; closest-hit connection casts whose hit must be the
# target; splat pixel round(); no |o.n| in the transmit weight).  The default
# (0) is the corrected estimator.  The integrator reads this attribute at
# call time (``constants.REFERENCE_MIS``), so setting it switches the
# estimator in a running process.
import os

REFERENCE_MIS = os.environ.get("CLIVE2_REFERENCE_MIS", "0") == "1"
