"""phdslam_tpu_torch — GM-PHD SLAM (static and mixed static+dynamic maps),
CPHD, FastSLAM and the monocular disparity SC-PHD pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of ``phdslam_tpu`` (JAX + Pallas on a TPU), which stays beside it
as the reference. Module names mirror the JAX package. The Pallas kernels
become ``kernels/select.py`` (``csrc/select.cu``, with its by-index mode),
``kernels/select4.py`` (``csrc/select4.cu``, with its by-index mode),
``kernels/merge.py``, ``merge4.py``, ``merge3.py`` (``csrc/merge*.cu``) and
``kernels/esf.py`` (``csrc/esf.cu``); FastSLAM's association loop and the
in-loop OSPA's eps-scaled auction, which JAX leaves to XLA, become
``kernels/auction.py`` (``csrc/auction.cu``). Each kernel wrapper launches
its CUDA kernel on a CUDA tensor and runs its plain PyTorch version on a
CPU tensor.

This package never imports JAX, flax or ``phdslam_tpu``: the host-only
modules it needs (``config.py``, ``simdata.py``, ``io/``, ``ops/jcbb.py``,
``eval/player.py``, ``eval/plots.py``, the batch harness's analysis, the
NumPy EAP and OSPA functions) are its own copies of the JAX package's.
"""

import torch as _torch

# The filter is small-matrix float32 algebra: TF32 products (~10-bit
# mantissa) perturb the Kalman covariances and merge decisions, which is why
# the JAX package forces full float32 too (phdslam_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from phdslam_tpu_torch.config import SlamConfig, load_config  # noqa: E402
from phdslam_tpu_torch.filter.state import (  # noqa: E402
    Gaussian2DMixture, Gaussian4DMixture, Measurements, SlamState)

__all__ = [
    "SlamConfig",
    "load_config",
    "SlamState",
    "Measurements",
    "Gaussian2DMixture",
    "Gaussian4DMixture",
]
