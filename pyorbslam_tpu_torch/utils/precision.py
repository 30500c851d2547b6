"""Float32 precision for geometry and optimizer code.

The JAX package scopes full-f32 matmuls over its geometry with a
decorator (``pyorbslam_tpu/utils/precision.py``): world coordinates grow
with the distance travelled, and reduced-precision products turn into
multi-pixel reprojection error far from the origin.  On an NVIDIA card
the same hazard is TF32, which keeps about three decimal digits.
PyTorch's float32 matmul runs in full f32 by default, but cuDNN
convolutions allow TF32 by default; this module turns both off.
"""

from __future__ import annotations

import torch


def use_f32_matmuls() -> None:
    """Run every float32 matmul and convolution in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
