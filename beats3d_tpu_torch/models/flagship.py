"""The committed flagship model (``models/flagship/`` beside the package):
which files make it up and at which label stride it serves.

The flagship is a layered forest, a coarse hand/arm layer (D=8, T=4)
filtering a 7-class fine layer (D=16, T=4), served with labels at half
resolution.  Its serving-depth variant replaces the fine layer by
``m1_serving.npy.gz``, the fine layer cut to D=13 with refit pdfs by
``scripts.truncate_fine``.
"""

from __future__ import annotations

import os

from .layered import LayeredDecisionForest

FLAGSHIP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "models", "flagship")
SERVING = os.path.join(FLAGSHIP, "m1_serving.npy.gz")


def load_flagship(device, model_dir=FLAGSHIP, layer_files=None):
    """The committed trained flagship (coarse D=8 T=4 -> fine D=16 T=4), or
    the layered model of another ``model_dir``, on ``device``, labels at
    half resolution; ``layer_files`` as ``LayeredDecisionForest.load``
    takes it."""
    return LayeredDecisionForest.load(
        os.path.join(model_dir, "model_cfg.json"), labels_reduce=2,
        device=device, layer_files=layer_files)


def load_serving_flagship(device):
    """The flagship's serving-depth variant on ``device``: the committed
    coarse layer and configuration with ``m1_serving.npy.gz`` as layer 1,
    the model the JAX package's bench stages from the same files."""
    return load_flagship(device, layer_files={1: SERVING})
