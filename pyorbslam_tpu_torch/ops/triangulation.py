"""Epipolar-constrained matching + batched two-view triangulation.

Port of ``pyorbslam_tpu/ops/triangulation.py``.  Replaces
ORBMatcher.search_for_triangulation (ORBMatcher.py:584-711) and the
triangulation loop of LocalMapping.create_new_map_points
(LocalMapping.py:152-308) with one fixed-shape device program per
keyframe pair:

  * candidate matching runs over the full Hamming matrix between the two
    keyframes' landmark-free features, masked by the epipolar distance of
    kp2 to F12^T kp1 (< 3.84 * sigma2) and the distance-to-epipole guard;
  * accepted pairs are triangulated by batched 4x4 DLT SVD, with the
    reference's stereo fallback, parallax ordering, positive depth,
    reprojection chi2 (5.991 mono / 7.8 stereo), and scale-consistency
    gates applied as masks.

``jax.vmap`` over neighbors becomes a Python loop over the (small, fixed)
batch axis with the results stacked.  ``torch.argmin`` on ties: both
devices return the first minimum for these 2-D integer inputs, as
``jnp.argmin`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.ops import hamming as ham

TH_LOW = 50
BIG = 1_000_000


class TriangulationResult(NamedTuple):
    idx1: torch.Tensor     # (M,) feature index in KF1 (-1 invalid)
    idx2: torch.Tensor     # (M,) feature index in KF2
    pos_w: torch.Tensor    # (M, 3) world position
    valid: torch.Tensor    # (M,) bool


def _first_argmin(dist: torch.Tensor, dim: int) -> torch.Tensor:
    """argmin taking the lowest index among equal minima (``jnp.argmin``'s
    rule), made explicit: integer distances below BIG are scaled past the
    index range and the index added."""
    n = dist.shape[dim]
    shape = [1, 1]
    shape[dim] = n
    idx = torch.arange(n, device=dist.device, dtype=torch.int64).reshape(shape)
    return torch.argmin(dist.to(torch.int64) * n + idx, dim=dim)


def fundamental_from_poses(T1: torch.Tensor, T2: torch.Tensor,
                           K: torch.Tensor) -> torch.Tensor:
    """F12 = K1^-T [t12]x R12 K2^-1 (reference compute_f12,
    LocalMapping.py:310-326)."""
    R1, t1 = T1[:3, :3], T1[:3, 3]
    R2, t2 = T2[:3, :3], T2[:3, 3]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    zero = torch.zeros((), dtype=t12.dtype, device=t12.device)
    tx = torch.stack([
        torch.stack([zero, -t12[2], t12[1]]),
        torch.stack([t12[2], zero, -t12[0]]),
        torch.stack([-t12[1], t12[0], zero]),
    ])
    # inv_ex: no error check, so no read-back (``linalg.inv`` on a CUDA
    # tensor reads its status flag and waits for the device)
    Kinv = torch.linalg.inv_ex(K).inverse
    return Kinv.T @ tx @ R12 @ Kinv


def _dlt_null_vector(A: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """(N, 4, 4) DLT systems -> (N, 4) right singular vectors of their
    smallest singular values (up to sign), by inverse iteration on
    A^T A shifted by 1e-7 of its trace.  The JAX package takes
    ``jnp.linalg.svd``; ``torch.linalg.svd`` on a CUDA tensor reads a
    status flag back and waits for the device, ``solve_ex`` does not.
    The other singular values of a DLT system are orders of magnitude
    larger, so the iteration converges in two steps; four reach the
    float32 SVD's own accuracy (both within 3e-4 m of a float64 SVD on
    points 3-60 m away)."""
    M = A.transpose(-1, -2) @ A
    shift = 1e-7 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    M = M + shift[:, None, None] * torch.eye(4, dtype=A.dtype, device=A.device)
    v = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    v[:, 3] = 1.0
    for _ in range(iters):
        v = torch.linalg.solve_ex(M, v[..., None]).result[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def triangulate_pair(
    # KF1 (the new keyframe)
    xy1: torch.Tensor, oct1: torch.Tensor, desc1: torch.Tensor,
    ur1: torch.Tensor, depth1: torch.Tensor, free1: torch.Tensor,
    # KF2 (neighbor)
    xy2: torch.Tensor, oct2: torch.Tensor, desc2: torch.Tensor,
    ur2: torch.Tensor, depth2: torch.Tensor, free2: torch.Tensor,
    T1: torch.Tensor, T2: torch.Tensor,
    cam: torch.Tensor,            # [fx, fy, cx, cy, bf]
    baseline,                     # scalar camera baseline (m)
    scale_factors: torch.Tensor,  # (L,)
    level_sigma2: torch.Tensor,   # (L,)
    scale_factor: float = 1.2,
) -> TriangulationResult:
    dev = xy1.device
    fx, fy, cx, cy, bf = (cam[i] for i in range(5))
    zero = torch.zeros((), dtype=cam.dtype, device=dev)
    one = torch.ones((), dtype=cam.dtype, device=dev)
    K = torch.stack([torch.stack([fx, zero, cx]),
                     torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, one])])
    F12 = fundamental_from_poses(T1, T2, K)
    oct1 = oct1.long()
    oct2 = oct2.long()

    # ---- matching with epipolar gating ----
    dist = ham.hamming_matrix(desc1, desc2)          # (N1, N2)
    h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], 1)  # (N1, 3)
    lines2 = h1 @ F12                                 # a, b, c per kp1 row
    num = (
        lines2[:, None, 0] * xy2[None, :, 0]
        + lines2[:, None, 1] * xy2[None, :, 1]
        + lines2[:, None, 2]
    )
    den = lines2[:, 0] ** 2 + lines2[:, 1] ** 2
    dsqr = num * num / torch.clamp(den, min=1e-12)[:, None]
    epi_ok = dsqr < 3.84 * level_sigma2[oct2][None, :]

    # epipole of camera 1 in image 2 (skip features too close to it)
    Ow1 = -T1[:3, :3].T @ T1[:3, 3]
    C2 = T2[:3, :3] @ Ow1 + T2[:3, 3]
    invz = 1.0 / torch.where(torch.abs(C2[2]) < 1e-6,
                             torch.full_like(C2[2], 1e-6), C2[2])
    ex, ey = fx * C2[0] * invz + cx, fy * C2[1] * invz + cy
    de2 = (xy2[:, 0] - ex) ** 2 + (xy2[:, 1] - ey) ** 2
    far_from_epipole = de2[None, :] >= 100.0 * (scale_factors[oct2] ** 2)[None, :]

    mask = epi_ok & far_from_epipole & free1[:, None] & free2[None, :]
    dist = torch.where(mask, dist, torch.full_like(dist, BIG))
    best2 = _first_argmin(dist, 1)
    bestd = torch.gather(dist, 1, best2[:, None])[:, 0]
    # mutual best (stands in for the reference's per-node best with
    # ratio 0.6: stricter, favors precision)
    back = _first_argmin(dist, 0)
    n1 = xy1.shape[0]
    mutual = back[best2] == torch.arange(n1, device=dev)
    matched = (bestd <= TH_LOW) & mutual

    i2 = best2
    # ---- triangulation ----
    xn1 = torch.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy,
                       torch.ones_like(xy1[:, 0])], 1)
    xn2_all = torch.stack([(xy2[:, 0] - cx) / fx, (xy2[:, 1] - cy) / fy,
                           torch.ones_like(xy2[:, 0])], 1)
    xn2 = xn2_all[i2]
    ray1 = xn1 @ T1[:3, :3]          # Rwc1 @ xn1 rows
    ray2 = xn2 @ T2[:3, :3]
    cos_par = torch.einsum("ni,ni->n", ray1, ray2) / torch.clamp(
        torch.linalg.norm(ray1, dim=1) * torch.linalg.norm(ray2, dim=1),
        min=1e-9)

    # a Python float (``baseline`` may be one) or the caller's tensor: a
    # 0-dim tensor made from the host here would be an upload that waits
    # for the work queued before it
    half_b = baseline / 2

    def stereo_cos(depth):
        hb = (half_b.expand_as(depth) if isinstance(half_b, torch.Tensor)
              else torch.full_like(depth, half_b))
        return torch.cos(2 * torch.atan2(hb, torch.clamp(depth, min=1e-6)))

    st1 = ur1 >= 0
    st2 = (ur2 >= 0)[i2]
    cps1 = torch.where(st1, stereo_cos(depth1), cos_par + 1)
    cps2 = torch.where(st2, stereo_cos(depth2[i2]), cos_par + 1)
    cos_par_stereo = torch.minimum(cps1, cps2)

    use_dlt = (cos_par < cos_par_stereo) & (cos_par > 0) & (
        st1 | st2 | (cos_par < 0.9998))

    # batched DLT: A (N, 4, 4)
    P1 = T1[:3, :4]
    P2 = T2[:3, :4]
    A = torch.stack([
        xn1[:, 0:1] * P1[2] - P1[0],
        xn1[:, 1:2] * P1[2] - P1[1],
        xn2[:, 0:1] * P2[2] - P2[0],
        xn2[:, 1:2] * P2[2] - P2[1],
    ], dim=1)
    hom = _dlt_null_vector(A)
    w = torch.where(torch.abs(hom[:, 3]) < 1e-9,
                    torch.full_like(hom[:, 3], 1e-9), hom[:, 3])
    x_dlt = hom[:, :3] / w[:, None]

    # stereo fallbacks in world coords
    def unproject(T, xy, depth):
        z = depth
        x = (xy[:, 0] - cx) * z / fx
        y = (xy[:, 1] - cy) * z / fy
        pc = torch.stack([x, y, z], 1)
        Rwc = T[:3, :3].T
        Ow = -Rwc @ T[:3, 3]
        return pc @ T[:3, :3] + Ow

    x_st1 = unproject(T1, xy1, depth1)
    x_st2 = unproject(T2, xy2, depth2)[i2]

    from1 = st1 & (cps1 < cps2)
    from2 = st2 & (cps2 < cps1)
    x3d = torch.where(
        use_dlt[:, None], x_dlt,
        torch.where(from1[:, None], x_st1,
                    torch.where(from2[:, None], x_st2, x_dlt)))
    has_source = use_dlt | from1 | from2

    # ---- gates ----
    def reproj_ok(T, xy, oct_, ur, x3d):
        Pc = x3d @ T[:3, :3].T + T[:3, 3]
        z = Pc[:, 2]
        zi = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        u = fx * Pc[:, 0] * zi + cx
        v = fy * Pc[:, 1] * zi + cy
        e2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        s2 = level_sigma2[oct_]
        stereo = ur >= 0
        er = (u - bf * zi - ur) ** 2
        ok = torch.where(stereo, e2 + er <= 7.8 * s2, e2 <= 5.991 * s2)
        return ok & (z > 0)

    ok1 = reproj_ok(T1, xy1, oct1, ur1, x3d)
    ok2 = reproj_ok(T2, xy2[i2], oct2[i2], ur2[i2], x3d)

    Ow2 = -T2[:3, :3].T @ T2[:3, 3]
    d1 = torch.linalg.norm(x3d - Ow1, dim=1)
    d2 = torch.linalg.norm(x3d - Ow2, dim=1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = scale_factors[oct1] / scale_factors[oct2[i2]]
    rf = 1.5 * scale_factor
    scale_ok = (ratio_dist * rf >= ratio_oct) & (ratio_dist <= ratio_oct * rf)

    valid = matched & has_source & ok1 & ok2 & scale_ok & (d1 > 1e-6) & (d2 > 1e-6)
    minus1 = torch.full((n1,), -1, dtype=torch.int32, device=dev)
    return TriangulationResult(
        idx1=torch.where(valid, torch.arange(n1, dtype=torch.int32, device=dev),
                         minus1),
        idx2=torch.where(valid, i2.to(torch.int32), minus1),
        pos_w=x3d,
        valid=valid,
    )


def triangulate_batch(
    xy1, oct1, desc1, ur1, depth1, free1,
    # neighbor tensors with leading batch axis B:
    xy2, oct2, desc2, ur2, depth2, free2, T2,
    T1, cam, baseline, scale_factors, level_sigma2,
    scale_factor: float = 1.2,
) -> TriangulationResult:
    """Triangulate the new KF against B neighbors; every field gains a
    leading axis B."""
    rs = [
        triangulate_pair(
            xy1, oct1, desc1, ur1, depth1, free1,
            xy2[b], oct2[b], desc2[b], ur2[b], depth2[b], free2[b],
            T1, T2[b], cam, baseline, scale_factors, level_sigma2,
            scale_factor)
        for b in range(xy2.shape[0])
    ]
    return TriangulationResult(*(torch.stack(f) for f in zip(*rs)))


def pack_tri_batch(r: TriangulationResult) -> torch.Tensor:
    """(B, 6M) int32: [idx1 M | idx2 M | valid M | pos_w bits 3M]."""
    return torch.cat([
        r.idx1, r.idx2, r.valid.to(torch.int32),
        r.pos_w.contiguous().view(torch.int32).reshape(r.pos_w.shape[0], -1),
    ], dim=1)


def triangulate_batch_packed(*args, **kwargs) -> torch.Tensor:
    """:func:`triangulate_batch` with the result packed into one int32
    buffer (B, 6N): a single device->host read per keyframe insertion."""
    return pack_tri_batch(triangulate_batch(*args, **kwargs))


def unpack_tri_batch_np(packed: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Host inverse of :func:`triangulate_batch_packed`:
    (idx1, idx2, valid, pos_w)."""
    n = packed.shape[1] // 6
    return (
        packed[:, :n], packed[:, n: 2 * n],
        packed[:, 2 * n: 3 * n].astype(bool),
        np.ascontiguousarray(packed[:, 3 * n:]).view(np.float32).reshape(
            packed.shape[0], n, 3),
    )
