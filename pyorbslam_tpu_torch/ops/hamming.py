"""Hamming distance between packed 256-bit ORB descriptors.

Port of ``pyorbslam_tpu/ops/hamming.py`` (reference: Frame.py:324-326,
ORBMatcher.py:12-14).  Pairwise distances are a matrix product of the
unpacked 0/1 bit vectors:

    hamming(a, b) = popcnt(a) + popcnt(b) - 2 * bits(a) @ bits(b)^T

Descriptor words are int32 holding the JAX package's uint32 bits.  The
product runs in float32: every dot product is at most 256, so it is
exact, and PyTorch has no integer matmul on CUDA.  Popcounts sum the
unpacked bits, since PyTorch has no popcount op.
"""

from __future__ import annotations

import torch


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """int32 (..., 8) -> int8 0/1 bits (..., 256), bit j of word w at 32w + j.
    The arithmetic right shift of a negative word still leaves bit j in
    the lowest place, so ``& 1`` reads it correctly."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.int8)


def popcount(desc: torch.Tensor) -> torch.Tensor:
    """int32 (..., 8) -> int32 (...,): number of set bits."""
    return unpack_bits(desc).sum(dim=-1, dtype=torch.int32)


def hamming_matrix_bits(bits_a: torch.Tensor, pop_a: torch.Tensor,
                        bits_b: torch.Tensor, pop_b: torch.Tensor) -> torch.Tensor:
    """Pairwise distances (N, M) int32 from pre-unpacked bits (N, 256) /
    (M, 256) and popcounts."""
    common = (bits_a.to(torch.float32) @ bits_b.to(torch.float32).T).to(torch.int32)
    return pop_a[:, None] + pop_b[None, :] - 2 * common


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Full pairwise distance matrix (N, M) int32 from packed (N, 8)/(M, 8)."""
    return hamming_matrix_bits(unpack_bits(desc_a), popcount(desc_a),
                               unpack_bits(desc_b), popcount(desc_b))


def hamming_pairwise(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Element-wise distance between aligned rows: (N, 8), (N, 8) -> (N,)."""
    return popcount(desc_a ^ desc_b)
