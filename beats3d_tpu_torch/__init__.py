"""beats3d_tpu_torch — the PyTorch/CUDA port of beats3d_tpu for one NVIDIA
H100: real-time per-pixel decision-forest hand tracking on depth frames,
layered forests, mean-shift fingertips, RANSAC table-plane calibration,
tap-detection MIDI, and the decision-forest trainer.

The JAX package ``beats3d_tpu`` stays the reference; this package imports
neither it nor JAX.  Plain tensor code is PyTorch; the JAX package's Pallas
TPU kernels on the live frame and training paths are hand-written CUDA C++
for Hopper (``csrc/``), built with nvcc at first use.  Every kernel has a
plain PyTorch version beside it, which the CPU runs.
"""

__version__ = "0.1.0"

from . import models, ops, utils  # noqa: F401
