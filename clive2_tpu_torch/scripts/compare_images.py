"""RMSE comparison of two renders (the port's counterpart of the JAX
package's scripts/compare_images.py, with the same output and exit code).

    python -m clive2_tpu_torch.scripts.compare_images a.png b.png
    python -m clive2_tpu_torch.scripts.compare_images a.npz b.npz

PNGs are compared on [0, 1]-normalised channels, ``.npz`` checkpoints on
their accumulated image over its weight.  Prints RMSE, MAE and the largest
difference; exits 0 when the RMSE is under 1e-3 (the parity criterion at
equal spp, BASELINE.md), 1 when it is not, 2 when the shapes differ.  Host
only: nothing runs on a device.
"""

from __future__ import annotations

import sys

import numpy as np


def load(path):
    if path.endswith(".npz"):
        z = np.load(path)
        img = z["summed_image"] / np.maximum(z["summed_weight"][..., None],
                                             1e-9)
        return np.nan_to_num(img, posinf=0, neginf=0)
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float64) / 255.0


def main(argv=None):
    a_path, b_path = (sys.argv[1:] if argv is None else argv)[:2]
    a, b = load(a_path), load(b_path)
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}")
        return 2
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    mae = float(np.mean(np.abs(a - b)))
    print(f"rmse={rmse:.6f} mae={mae:.6f} "
          f"max={float(np.abs(a - b).max()):.6f}")
    return 0 if rmse < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
