"""Random split-feature proposals (host numpy; counterpart of
beats3d_tpu/train/proposals.py).

Probe offsets have a uniform angle and a log-uniform magnitude up to e^14;
thresholds are sign-symmetric log-uniform up to e^11, as in the reference
trainer.  The draws come from a ``numpy.random.Generator`` in the JAX
package's order, so one seed gives the same proposals in both packages.
"""

from __future__ import annotations

import numpy as np

FEATURE_MAGNITUDE_MAX = 14.0
FEATURE_THRESHOLD_MAX = 11.0


def make_random_features(n: int, rng: np.random.Generator = None) -> np.ndarray:
    """(n, 5) float32 rows (ux, uy, vx, vy, thresh)."""
    rng = rng or np.random.default_rng()
    theta = rng.uniform(0.0, 2.0 * np.pi, size=(n, 2))
    mag = np.exp(rng.uniform(0.0, FEATURE_MAGNITUDE_MAX, size=(n, 2)))
    u = np.stack([np.cos(theta[:, 0]), np.sin(theta[:, 0])], -1) * mag[:, 0:1]
    v = np.stack([np.cos(theta[:, 1]), np.sin(theta[:, 1])], -1) * mag[:, 1:2]
    thresh = rng.choice([-1.0, 1.0], size=n) * np.exp(
        rng.uniform(0.0, FEATURE_THRESHOLD_MAX, size=n)
    )
    return np.concatenate([u, v, thresh[:, None]], axis=1).astype(np.float32)
