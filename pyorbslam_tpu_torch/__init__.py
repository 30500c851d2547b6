"""pyorbslam_tpu_torch: the stereo SLAM engine ported to PyTorch and CUDA.

A port of ``pyorbslam_tpu`` (JAX) for NVIDIA Hopper GPUs.  Module layout
and function names follow the JAX package, so each module's counterpart
is easy to find; inside, the code is plain functions on tensors.  The
frontend's three Pallas kernels are CUDA C++ kernels here (``csrc/``,
built with ``nvcc`` at first use, see ``ops/kernels.py``); the native map
core (``native/``) is built with ``g++`` at first use.

This package imports neither ``jax`` nor ``pyorbslam_tpu``; it reads the
shared ORB pattern and vocabulary assets by file path.  No function picks a device by
itself: callers pass tensors, or a ``device``, explicitly.
"""

__version__ = "0.1.0"

from pyorbslam_tpu_torch.config import SlamConfig, load_settings  # noqa: F401
