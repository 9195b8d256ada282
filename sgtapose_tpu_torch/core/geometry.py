"""Core geometry: affine transforms, image warps, Gaussian heatmap rendering,
quaternions, camera projection — the torch counterpart of
`sgtapose_tpu/core/geometry.py`, on whatever device the inputs lie. Point
sets and heatmap renders take any leading batch dims (the batched video
detector renders all its videos' priors in one call).

Conventions: quaternions are (w, x, y, z); image coordinates are (x, y) with
x along width; heatmaps are (H, W); images are HWC.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# -----------------------------------------------------------------------------
# Affine transforms
# -----------------------------------------------------------------------------


def _third_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Third triangle point: b + perp(a - b)."""
    d = a - b
    return b + torch.stack([-d[1], d[0]])


def get_affine_transform(
    center,
    scale,
    rot_deg,
    output_size: Tuple[int, int],
    shift=(0.0, 0.0),
    inv: bool = False,
) -> torch.Tensor:
    """2x3 affine matrix mapping a square crop of the source image (centered at
    `center`, side `scale`, rotated `rot_deg`) onto `output_size` (w, h),
    solved in closed form from 3 point pairs (float32, on center's device)."""
    center = _f32(center)
    dev = center.device
    scale = _f32(scale, dev)
    if scale.ndim == 0:
        scale = torch.stack([scale, scale])
    shift = _f32(shift, dev)
    dst_w, dst_h = output_size[0], output_size[1]

    rot = torch.deg2rad(_f32(rot_deg, dev))
    sn, cs = torch.sin(rot), torch.cos(rot)
    src_w = scale[0]
    src_dir = torch.stack([src_w * 0.5 * sn, -src_w * 0.5 * cs])
    dst_dir = _f32([0.0, -0.5 * dst_w], dev)

    src0 = center + scale * shift
    src1 = center + src_dir + scale * shift
    src2 = _third_point(src0, src1)
    dst0 = _f32([dst_w * 0.5, dst_h * 0.5], dev)
    dst1 = dst0 + dst_dir
    dst2 = _third_point(dst0, dst1)

    src = torch.stack([src0, src1, src2])  # (3,2)
    dst = torch.stack([dst0, dst1, dst2])
    if inv:
        src, dst = dst, src
    src_h = torch.cat([src, torch.ones(3, 1, device=dev)], dim=1)  # (3,3)
    At = torch.linalg.solve(src_h, dst)  # (3,2)
    return At.T.contiguous()  # (2,3)


def invert_affine(M: torch.Tensor) -> torch.Tensor:
    """Invert a 2x3 affine matrix."""
    A = M[:, :2]
    b = M[:, 2]
    Ainv = torch.linalg.inv(A)
    binv = -Ainv @ b
    return torch.cat([Ainv, binv[:, None]], dim=1)


def affine_points(pts: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Apply a 2x3 affine to (..., 2) points (elementwise, full f32)."""
    x = M[0, 0] * pts[..., 0] + M[0, 1] * pts[..., 1] + M[0, 2]
    y = M[1, 0] * pts[..., 0] + M[1, 1] * pts[..., 1] + M[1, 2]
    return torch.stack([x, y], dim=-1)


def affine_transform_and_clip(
    pts: torch.Tensor, M: torch.Tensor, width, height, raw_width, raw_height
) -> torch.Tensor:
    """Transform (..., N, 2) points, clip into [0, w-1]x[0, h-1]; points whose
    RAW coordinates fall outside the raw frame become (0, 0), which the
    renderer then skips."""
    new = affine_points(pts, M)
    new = torch.stack(
        [new[..., 0].clamp(0.0, width - 1.0), new[..., 1].clamp(0.0, height - 1.0)], dim=-1
    )
    in_raw = (
        (pts[..., 0] >= 0.0)
        & (pts[..., 0] < raw_width)
        & (pts[..., 1] >= 0.0)
        & (pts[..., 1] < raw_height)
    )
    return torch.where(in_raw[..., None], new, torch.zeros_like(new))


def warp_affine(image: torch.Tensor, M: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear warp of an (..., H, W, C) image by the FORWARD 2x3 affine `M`
    (dst <- src, like cv2.warpAffine with INTER_LINEAR); out-of-bounds reads
    are zero. Leading dims batch over frames that share `M`."""
    Minv = invert_affine(M)
    out_h, out_w = out_hw
    dev = image.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)
    src_x = Minv[0, 0] * gx + Minv[0, 1] * gy + Minv[0, 2]
    src_y = Minv[1, 0] * gx + Minv[1, 1] * gy + Minv[1, 2]

    h, w = image.shape[-3], image.shape[-2]
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        vals = image[..., yi.clamp(0, h - 1), xi.clamp(0, w - 1), :]
        return torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=dev))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def normalize_image(img: torch.Tensor, mean, std) -> torch.Tensor:
    """[0,255] HWC -> normalized float32 HWC."""
    img = img.to(torch.float32) / 255.0
    return (img - _f32(mean, img.device)) / _f32(std, img.device)


# -----------------------------------------------------------------------------
# Gaussian heatmap rendering
# -----------------------------------------------------------------------------


def render_gaussian_heatmap(
    centers: torch.Tensor,
    confidences: torch.Tensor,
    height: int,
    width: int,
    radius: int = 4,
    sigma: float = 2.0,
    per_class: bool = False,
    subpixel: bool = False,
) -> torch.Tensor:
    """Truncated Gaussians at integer-truncated centers, combined by max.

    x, y = int(center) (truncation toward zero); a splat is drawn only if its
    whole (2r+1)^2 window fits inside the map; scaled by `confidences`.
    centers: (..., K, 2) (x, y); confidences: (..., K). Returns (..., H, W),
    or (..., K, H, W) with per_class=True.
    """
    dev = centers.device
    cx = torch.trunc(centers[..., 0]).to(torch.int32)
    cy = torch.trunc(centers[..., 1]).to(torch.int32)
    drawable = (
        (cx - radius >= 0)
        & (cx + radius + 1 < width)
        & (cy - radius >= 0)
        & (cy + radius + 1 < height)
    )
    conf = confidences * drawable.to(confidences.dtype)

    gy = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    gx = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    dy = (gy - cy[..., None, None]).to(torch.float32)  # (..., K, H, W)
    dx = (gx - cx[..., None, None]).to(torch.float32)
    window = (dx.abs() <= radius) & (dy.abs() <= radius)
    if subpixel:
        dx = dx - (centers[..., 0] - cx.to(torch.float32))[..., None, None]
        dy = dy - (centers[..., 1] - cy.to(torch.float32))[..., None, None]
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * sigma * sigma))
    g = torch.where(window, g, torch.zeros((), device=dev)) * conf[..., None, None]
    if per_class:
        return g
    return g.amax(dim=-3)


def render_prior_heatmap(
    kp_projs_raw, trans_input, input_w, input_h, raw_width, raw_height,
    confidences=None, radius: int = 4, sigma: float = 2.0,
) -> torch.Tensor:
    """Noise-free prior heatmap (..., H_in, W_in) at network-input resolution
    from (..., K, 2) raw keypoints."""
    pts = affine_transform_and_clip(
        kp_projs_raw, trans_input, input_w, input_h, raw_width, raw_height
    )
    if confidences is None:
        confidences = torch.ones(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    return render_gaussian_heatmap(pts, confidences, input_h, input_w, radius, sigma)


def render_prior_heatmap_cls(
    kp_projs_raw, trans_output, output_w, output_h, raw_width, raw_height,
    confidences=None,
) -> torch.Tensor:
    """Per-class prior heatmaps (..., K, H_out, W_out) at output resolution
    from (..., K, 2) raw keypoints."""
    pts = affine_transform_and_clip(
        kp_projs_raw, trans_output, output_w, output_h, raw_width, raw_height
    )
    if confidences is None:
        confidences = torch.ones(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    return render_gaussian_heatmap(
        pts, confidences, output_h, output_w, radius=4, sigma=2.0, per_class=True
    )


# -----------------------------------------------------------------------------
# Quaternions (w, x, y, z) and projection
# -----------------------------------------------------------------------------


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-norm-insensitive quaternion (..., 4) wxyz -> rotation (..., 3, 3)."""
    r, i, j, k = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sq = (q * q).sum(-1)
    # tensor / tensor: forward-mode AD (torch.func.jacfwd in the LM solver)
    # of a python-scalar numerator gives float64 tangents
    two_s = torch.full_like(sq, 2.0) / sq
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) wxyz, Shepperd's
    method with a branchless pick of the dominant component."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(q_abs_sq.clamp(min=0.0))
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )  # (..., 4, 4)
    cand = cand / (2.0 * q_abs.clamp(min=0.1))[..., None]
    best = q_abs.argmax(dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def rotate_point_by_quat(pt: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points by (..., 4) quaternions as q p q*."""
    p = torch.cat([torch.zeros_like(pt[..., :1]), pt], dim=-1)
    qc = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    return quat_multiply(quat_multiply(q, p), qc)[..., 1:]


def project_points(x3d: torch.Tensor, R: torch.Tensor, t: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project (..., N, 3) points by pose (R (...,3,3), t (...,3)) and
    intrinsics K (3,3) -> (..., N, 2) pixels."""
    cam = x3d @ R.transpose(-1, -2) + t[..., None, :]
    uvw = cam @ K.T
    return uvw[..., :2] / uvw[..., 2:3]


def transform_points(x3d: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points through the rigid transform (R, t)."""
    return x3d @ R.transpose(-1, -2) + t[..., None, :]
