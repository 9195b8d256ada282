"""Masked EPnP + Levenberg-Marquardt PnP, the torch counterpart of
`sgtapose_tpu/core/pnp.py` (solve_pnp, pnp_reprojection_prior, register_gn
and the helpers they run).

The JAX solver is written with `lax.while_loop`, `lax.cond`, `fori_loop` and
`jax.jacfwd`. Here:
  * LM runs a fixed `max_iters` iterations with a per-problem `active` mask
    that freezes the state exactly where the JAX while-loop would stop;
  * each `cond` is computed both ways and selected with `torch.where`, and the
    three LM refinements solve_pnp may need (EPnP init, DLT init, canonical
    pose) run as ONE batched LM;
  * Jacobians come from `torch.func.jacfwd` (LM) or closed form (EPnP betas);
  * no `.item()`: the only host syncs are the error checks inside
    `torch.linalg.eigh`/`svd` (their inputs are sanitised first so a
    non-finite matrix poisons the result with NaN, as in JAX, instead of
    raising).

Batches (`pnp_reprojection_prior_batch` for the videos of the batched
detector, the eval harness's per-frame solves) are `torch.func.vmap` of the
single solve, as the JAX package vmaps it: every operation of a batch of problems (each with its 3 LM
starts) is one launch, so the launches per solve do not grow with the batch.
Each problem keeps its own semantics (mask, warm start, stopping point).

Eigen/singular vector signs differ between backends; the poses and
reprojections they lead to do not.
Quaternions are (w, x, y, z). Everything is float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from sgtapose_tpu_torch.core import geometry


class PnPResult(NamedTuple):
    success: torch.Tensor  # () bool
    quat: torch.Tensor  # (4,) wxyz
    trans: torch.Tensor  # (3,)


def _all_finite(M: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(M).flatten(-2).all(-1)


def _eigh(M: torch.Tensor):
    """Symmetrised eigh whose non-finite inputs give NaN outputs (JAX
    semantics) instead of a LAPACK/cuSOLVER error."""
    ok = _all_finite(M)
    M = torch.nan_to_num(M, nan=0.0, posinf=0.0, neginf=0.0)
    vals, vecs = torch.linalg.eigh(0.5 * (M + M.transpose(-1, -2)))
    nan = torch.full((), float("nan"), device=M.device)
    return (
        torch.where(ok[..., None], vals, nan),
        torch.where(ok[..., None, None], vecs, nan),
    )


def _svd(M: torch.Tensor):
    ok = _all_finite(M)
    M = torch.nan_to_num(M, nan=0.0, posinf=0.0, neginf=0.0)
    U, S, Vt = torch.linalg.svd(M)
    nan = torch.full((), float("nan"), device=M.device)
    return (
        torch.where(ok[..., None, None], U, nan),
        torch.where(ok[..., None], S, nan),
        torch.where(ok[..., None, None], Vt, nan),
    )


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    # *_ex: no host-side singularity check (a singular system yields
    # non-finite values, which the callers gate on, like jnp.linalg.solve)
    return torch.linalg.solve_ex(A, B)[0]


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A)[0]


def _rot_from_svd(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation U diag(1,1,det(U Vt)) Vt of a (..., 3, 3) matrix."""
    U, S, Vt = _svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    return U @ D @ Vt, S


# -----------------------------------------------------------------------------
# DLT initialization
# -----------------------------------------------------------------------------


def _normalize_2d(x2d: torch.Tensor, w: torch.Tensor):
    """Hartley normalization of weighted 2D points. Returns (x_norm, T 3x3)."""
    wsum = w.sum().clamp(min=1e-8)
    mean = (x2d * w[:, None]).sum(0) / wsum
    d = torch.sqrt(((x2d - mean) ** 2).sum(1) + 1e-12)
    mean_d = (d * w).sum() / wsum
    s = (2.0 ** 0.5) / mean_d.clamp(min=1e-8)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mean[0]]),
        torch.stack([zero, s, -s * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (x2d - mean) * s, T


def _normalize_3d(x3d: torch.Tensor, w: torch.Tensor):
    wsum = w.sum().clamp(min=1e-8)
    mean = (x3d * w[:, None]).sum(0) / wsum
    d = torch.sqrt(((x3d - mean) ** 2).sum(1) + 1e-12)
    mean_d = (d * w).sum() / wsum
    s = (3.0 ** 0.5) / mean_d.clamp(min=1e-8)
    return (x3d - mean) * s, s, mean


def dlt_init(x3d, x2d, K, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked DLT estimate of (R, t): the 12-vector nullspace of the weighted,
    Hartley-conditioned design matrix, projected onto SO(3)."""
    dev = x3d.device
    n = x3d.shape[0]
    xy1 = torch.cat([x2d, torch.ones_like(x2d[:, :1])], dim=1)
    xyn = (xy1 @ _inv(K).T)[:, :2]

    xn2, T2 = _normalize_2d(xyn, weights)
    xn3, s3, m3 = _normalize_3d(x3d, weights)

    zeros = torch.zeros(n, 4, device=dev)
    X_h = torch.cat([xn3, torch.ones(n, 1, device=dev)], dim=1)
    u = xn2[:, 0:1]
    v = xn2[:, 1:2]
    rows_u = torch.cat([X_h, zeros, -u * X_h], dim=1)
    rows_v = torch.cat([zeros, X_h, -v * X_h], dim=1)
    A = torch.cat([rows_u, rows_v], dim=0) * torch.cat([weights, weights])[:, None]
    _, vecs = _eigh(A.T @ A)
    P = vecs[:, 0].reshape(3, 4)  # smallest eigenvalue

    zero, one = torch.zeros_like(s3), torch.ones_like(s3)
    S3 = torch.stack([
        torch.stack([s3, zero, zero, -s3 * m3[0]]),
        torch.stack([zero, s3, zero, -s3 * m3[1]]),
        torch.stack([zero, zero, s3, -s3 * m3[2]]),
        torch.stack([zero, zero, zero, one]),
    ])
    P = _inv(T2) @ P @ S3

    # cheirality: make mean depth positive
    X_full = torch.cat([x3d, torch.ones(n, 1, device=dev)], dim=1)
    depths = X_full @ P[2]
    P = P * torch.where((depths * weights).sum() < 0, -1.0, 1.0)

    R, S = _rot_from_svd(P[:, :3])
    t = P[:, 3] / S.mean().clamp(min=1e-12)
    return R, t


# -----------------------------------------------------------------------------
# EPnP initialization (cv2.SOLVEPNP_EPNP's algorithm), masked, f32
# -----------------------------------------------------------------------------

_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _epnp_control_points(x3d, w) -> torch.Tensor:
    """Weighted centroid + the 3 PCA axes scaled by their std-devs, largest
    first; the weakest axis is floored so the basis stays invertible."""
    wsum = w.sum().clamp(min=1e-8)
    c0 = (x3d * w[:, None]).sum(0) / wsum
    d = (x3d - c0) * torch.sqrt(w)[:, None]
    vals, vecs = _eigh(d.T @ d / wsum)  # ascending
    floor = vals[2].clamp(min=1e-8) * 1e-6 + 1e-12
    scale = torch.sqrt(torch.maximum(vals, floor))
    cs = c0[None, :] + scale.flip(0)[:, None] * vecs.T.flip(0)
    return torch.cat([c0[None, :], cs], dim=0)  # (4,3)


def _epnp_barycentric(x3d, cw) -> torch.Tensor:
    """alphas (N,4): p_i = sum_j alpha_ij c_j, sum_j alpha_ij = 1."""
    CC = (cw[1:4] - cw[0]).T
    a123 = _solve(CC, (x3d - cw[0]).T).T
    return torch.cat([1.0 - a123.sum(1, keepdim=True), a123], dim=1)


def _epnp_nullspace(alphas, x2d, K, w) -> torch.Tensor:
    """The 4 smallest-eigenvalue vectors of M^T M as (4, 4, 3)."""
    fu, fv = K[0, 0], K[1, 1]
    uc, vc = K[0, 2], K[1, 2]
    n = x2d.shape[0]
    a = alphas
    zero = torch.zeros(n, 4, device=a.device)
    du = (uc - x2d[:, 0])[:, None] * a
    dv = (vc - x2d[:, 1])[:, None] * a
    rows_u = torch.stack([a * fu, zero, du], dim=2).reshape(n, 12)
    rows_v = torch.stack([zero, a * fv, dv], dim=2).reshape(n, 12)
    M = torch.cat([rows_u, rows_v], dim=0) * torch.cat([w, w])[:, None]
    _, vecs = _eigh(M.T @ M)
    return vecs[:, :4].T.reshape(4, 4, 3)


def _epnp_L_rho(v, cw):
    """L (6,10) and rho (6,) of the beta constraints. Beta-product order:
    [b0b0, b0b1, b1b1, b0b2, b1b2, b2b2, b0b3, b1b3, b2b3, b3b3]."""
    ii = [i for i, _ in _EPNP_PAIRS]
    jj = [j for _, j in _EPNP_PAIRS]
    dv = v[:, ii] - v[:, jj]  # (4,6,3)

    def dot(a, b):
        return (dv[a] * dv[b]).sum(1)

    L = torch.stack(
        [
            dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2),
            dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3),
        ],
        dim=1,
    )
    rho = ((cw[ii] - cw[jj]) ** 2).sum(1)
    return L, rho


def _lsq(A, b) -> torch.Tensor:
    """Regularised normal-equation least squares; A (..., m, k), b (..., m)."""
    AtA = A.transpose(-1, -2) @ A
    AtA = AtA + 1e-9 * torch.eye(A.shape[-1], device=A.device)
    return _solve(AtA, (A.transpose(-1, -2) @ b[..., None]))[..., 0]


def _betas_approx(L, rho) -> torch.Tensor:
    """The three cv2 epnp beta initializations, stacked (3,4)."""
    eps = 1e-8
    zero = torch.zeros((), device=L.device)
    # case 1: unknowns [b0b0, b0b1, b0b2, b0b3]
    x = _lsq(L[:, [0, 1, 3, 6]], rho)
    s = torch.where(x[0] < 0, -1.0, 1.0)
    b0 = torch.sqrt(x[0].abs())
    bd = b0.clamp(min=eps)
    b1 = torch.stack([b0, s * x[1] / bd, s * x[2] / bd, s * x[3] / bd])

    # case 2: unknowns [b0b0, b0b1, b1b1]
    x = _lsq(L[:, [0, 1, 2]], rho)
    b0 = torch.sqrt(x[0].abs())
    bb1 = torch.where(torch.sign(x[2]) == torch.sign(x[0]), torch.sqrt(x[2].abs()), zero)
    b0 = torch.where(x[1] < 0, -b0, b0)
    b2 = torch.stack([b0, bb1, zero, zero])

    # case 3: unknowns [b0b0, b0b1, b1b1, b0b2, b1b2]
    x = _lsq(L[:, [0, 1, 2, 3, 4]], rho)
    b0 = torch.sqrt(x[0].abs())
    bb1 = torch.where(torch.sign(x[2]) == torch.sign(x[0]), torch.sqrt(x[2].abs()), zero)
    b0 = torch.where(x[1] < 0, -b0, b0)
    bb2 = x[3] / torch.where(b0.abs() < eps, torch.full_like(b0, float("inf")), b0)
    b3 = torch.stack([b0, bb1, bb2, zero])
    return torch.stack([b1, b2, b3])


def _b10(b: torch.Tensor) -> torch.Tensor:
    b0, b1, b2, b3 = b.unbind(-1)
    return torch.stack(
        [b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2, b2 * b2,
         b0 * b3, b1 * b3, b2 * b3, b3 * b3], dim=-1)


def _db10(b: torch.Tensor) -> torch.Tensor:
    """d b10 / d b, (..., 10, 4)."""
    b0, b1, b2, b3 = b.unbind(-1)
    z = torch.zeros_like(b0)
    rows = [
        [2 * b0, z, z, z],
        [b1, b0, z, z],
        [z, 2 * b1, z, z],
        [b2, z, b0, z],
        [z, b2, b1, z],
        [z, z, 2 * b2, z],
        [b3, z, z, b0],
        [z, b3, z, b1],
        [z, z, b3, b2],
        [z, z, z, 2 * b3],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def _betas_gn(L, rho, betas, iters: int = 5) -> torch.Tensor:
    """cv2 epnp gauss_newton: fixed iterations on the 6 distance residuals;
    betas (..., 4) batched over candidates."""
    for _ in range(iters):
        r = (L @ _b10(betas)[..., None])[..., 0] - rho
        J = L @ _db10(betas)
        betas = betas - _lsq(J, r)
    return betas


def _epnp_pose(betas, v, alphas, x3d, w):
    """(R, t) per beta candidate (betas (P,4)) — camera-frame control
    points, point cloud, depth-sign fix, weighted Horn alignment."""
    ccs = torch.einsum("pk,kjc->pjc", betas, v)  # (P,4,3)
    pcs = alphas @ ccs  # (P,N,3)
    wsum = w.sum().clamp(min=1e-8)
    sgn = torch.where((pcs[..., 2] * w).sum(-1) < 0, -1.0, 1.0)
    pcs = pcs * sgn[:, None, None]
    pc0 = (pcs * w[:, None]).sum(1) / wsum  # (P,3)
    pw0 = (x3d * w[:, None]).sum(0) / wsum  # (3,)
    ABt = ((pcs - pc0[:, None]) * w[:, None]).transpose(-1, -2) @ (x3d - pw0)
    R, _ = _rot_from_svd(ABt)
    t = pc0 - R @ pw0
    return R, t


def _masked_mean_err(x3d, x2d, K, w, R, t, denom) -> torch.Tensor:
    """Weighted mean reprojection distance per pose (R (...,3,3), t (...,3))."""
    proj = geometry.project_points(x3d, R, t, K)
    return (torch.linalg.vector_norm(proj - x2d, dim=-1) * w).sum(-1) / denom


def epnp_init(x3d, x2d, K, weights, n_cases: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked EPnP (Lepetit et al.): the beta cases are Gauss-Newton-refined
    and the lowest-reprojection candidate wins, as in cv2. n_cases=1 solves
    only case 1."""
    cw = _epnp_control_points(x3d, weights)
    alphas = _epnp_barycentric(x3d, cw)
    v = _epnp_nullspace(alphas, x2d, K, weights)
    L, rho = _epnp_L_rho(v, cw)
    betas = _betas_gn(L, rho, _betas_approx(L, rho)[:n_cases])
    Rs, ts = _epnp_pose(betas, v, alphas, x3d, weights)
    errs = _masked_mean_err(x3d, x2d, K, weights, Rs, ts, weights.sum().clamp(min=1e-8))
    errs = torch.where(torch.isfinite(errs), errs, float("inf"))
    best = errs.argmin().reshape(1)  # first minimum, like jnp.argmin
    return Rs.index_select(0, best)[0], ts.index_select(0, best)[0]


# -----------------------------------------------------------------------------
# Reprojection LM refinement
# -----------------------------------------------------------------------------


def _reproj_residual(params, x3d, x2d, K, weights):
    """Weighted reprojection residual (2N,); params = (qw,qx,qy,qz,tx,ty,tz)."""
    q = params[:4]
    q = q / torch.linalg.vector_norm(q).clamp(min=1e-12)
    R = geometry.quat_to_matrix(q)
    proj = geometry.project_points(x3d, R, params[4:], K)
    return ((proj - x2d) * weights[:, None]).reshape(-1)


def refine_pose_lm(x3d, x2d, K, weights, quat_init, trans_init,
                   max_iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt on the plain reprojection residual with per-point
    weights. quat_init (..., 4) / trans_init (..., 3) may carry a leading
    batch of independent starts over the same correspondences; each start
    stops (freezes) on its own, exactly where the JAX while-loop stops."""
    single = quat_init.ndim == 1
    params = torch.cat([quat_init, trans_init], dim=-1).to(torch.float32)
    if single:
        params = params[None]
    P = params.shape[0]
    dev = params.device

    def res_fn(p):
        return _reproj_residual(p, x3d, x2d, K, weights)

    res_b = torch.func.vmap(res_fn)
    jac_b = torch.func.vmap(torch.func.jacfwd(res_fn))

    lam = torch.full((P,), 1e-3, device=dev)
    delta_norm = torch.ones(P, device=dev)
    for _ in range(max_iters):
        active = delta_norm > 1e-8
        r = res_b(params)  # (P,2N)
        J = jac_b(params)  # (P,2N,7)
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        H = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-9)
        delta = _solve(H, g[..., None])[..., 0]
        new_params = params - delta
        improved = (res_b(new_params) ** 2).sum(-1) < (r ** 2).sum(-1)
        step = active & improved
        params = torch.where(step[:, None], new_params, params)
        new_lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
        lam = torch.where(active, new_lam, lam)
        delta_norm = torch.where(active, torch.linalg.vector_norm(delta, dim=-1), delta_norm)
    q = params[:, :4]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    t = params[:, 4:]
    if single:
        return q[0], t[0]
    return q, t


def solve_pnp(
    x3d: torch.Tensor,
    x2d: torch.Tensor,
    K: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    refine_iters: int = 30,
    init: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> PnPResult:
    """Masked EPnP init + LM refine, with the JAX solver's DLT/canonical
    fallback when the EPnP-started solve ends above 3 px mean reprojection.

    init: optional (quat0, trans0, use_init) warm start; where use_init is
    True LM starts from it instead of the EPnP pose. success is False with
    fewer than 4 valid rows or a degenerate (non-finite / >1e3 px) solution.
    Both sides of each JAX `lax.cond` are computed and selected.
    """
    dev = x3d.device
    n = x3d.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    finite = torch.isfinite(x3d).all(1) & torch.isfinite(x2d).all(1)
    valid = valid & finite
    w = valid.to(torch.float32)
    x3d = torch.where(valid[:, None], x3d, torch.zeros((), device=dev))
    x2d = torch.where(valid[:, None], x2d, torch.zeros((), device=dev))

    R0, t0 = epnp_init(x3d, x2d, K, w)
    q0 = geometry.matrix_to_quat(R0)
    if init is not None:
        quat0, trans0, use_init = init
        q0 = torch.where(use_init, quat0.to(torch.float32), q0)
        t0 = torch.where(use_init, trans0.to(torch.float32), t0)

    n_valid = w.sum()
    centroid = (x3d * w[:, None]).sum(0) / n_valid.clamp(min=1.0)
    q_c = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    t_c = torch.tensor([0.0, 0.0, 2.0], device=dev) - centroid
    R_d, t_d = dlt_init(x3d, x2d, K, w)

    # the three starts: EPnP (a), DLT (b), canonical (e) — one batched LM
    qs, ts = refine_pose_lm(
        x3d, x2d, K, w,
        torch.stack([q0, geometry.matrix_to_quat(R_d), q_c]),
        torch.stack([t0, t_d, t_c]),
        max_iters=refine_iters,
    )
    errs = _masked_mean_err(x3d, x2d, K, w, geometry.quat_to_matrix(qs), ts,
                            n_valid.clamp(min=1.0))
    errs = torch.where(torch.isfinite(errs), errs, float("inf"))
    err_a = errs[0]
    use_b = errs[1] <= errs[2]
    q_be = torch.where(use_b, qs[1], qs[2])
    t_be = torch.where(use_b, ts[1], ts[2])
    # fallback candidates only count when the EPnP-started solve is poor
    fallback = err_a > 3.0
    q_b = torch.where(fallback, q_be, qs[0])
    t_b = torch.where(fallback, t_be, ts[0])
    err_b = torch.where(fallback, torch.minimum(errs[1], errs[2]), float("inf"))

    use_a = err_a <= err_b
    q = torch.where(use_a, qs[0], q_b)
    t = torch.where(use_a, ts[0], t_b)
    reproj_err = torch.minimum(err_a, err_b)
    ok = (
        (n_valid >= 4)
        & torch.isfinite(q).all()
        & torch.isfinite(t).all()
        & (reproj_err < 1e3)
    )
    q = torch.where(ok, q, q_c)
    t = torch.where(ok, t, torch.zeros(3, device=dev))
    return PnPResult(success=ok, quat=q, trans=t)


def pnp_reprojection_prior(
    prev_x3d, prev_x2d, next_x3d, K, valid=None, init=None,
) -> Tuple[torch.Tensor, torch.Tensor, PnPResult]:
    """PnP from the previous frame's (3D, 2D) pairs, then reproject the next
    frame's 3D keypoints: the temporal structure prior. Returns (success,
    next_2d_est (N,2), PnPResult)."""
    res = solve_pnp(prev_x3d, prev_x2d, K, valid, init=init)
    R = geometry.quat_to_matrix(res.quat)
    next_est = geometry.project_points(next_x3d, R, res.trans, K)
    return res.success, next_est, res


def pnp_reprojection_prior_batch(
    prev_x3d, prev_x2d, next_x3d, K, valid=None, init=None,
) -> Tuple[torch.Tensor, torch.Tensor, PnPResult]:
    """`pnp_reprojection_prior` over a leading batch dim of every argument but
    K (init: a tuple of batched (quat, trans, use_init)), as one batched solve.
    Returns (success (V,), next_2d_est (V,N,2), PnPResult of (V,...) fields)."""
    if valid is None:
        valid = torch.ones(prev_x3d.shape[:2], dtype=torch.bool, device=prev_x3d.device)
    if init is None:
        return torch.func.vmap(lambda a, b, c, v: pnp_reprojection_prior(a, b, c, K, v))(
            prev_x3d, prev_x2d, next_x3d, valid)
    return torch.func.vmap(
        lambda a, b, c, v, q0, t0, u: pnp_reprojection_prior(a, b, c, K, v, init=(q0, t0, u)))(
        prev_x3d, prev_x2d, next_x3d, valid, *init)


# -----------------------------------------------------------------------------
# Reference-parity weighted GN refiner (the eval harness's --rf refinement)
# -----------------------------------------------------------------------------


def _squared_residuals(params, x3d, x2d, K, weights):
    """Per-row SQUARED weighted reprojection errors plus a 2e8-weighted squared
    unit-quaternion constraint, the point rotated as q p q*. Returns (2N + 1,)."""
    q = params[:4]
    t = params[4:]
    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    cam = geometry.rotate_point_by_quat(x3d, q.expand(x3d.shape[0], 4)) + t
    u = (fx * cam[:, 0] + cx * cam[:, 2]) / cam[:, 2]
    v = (fy * cam[:, 1] + cy * cam[:, 2]) / cam[:, 2]
    rx = weights[:, 0] ** 2 * (x2d[:, 0] - u) ** 2
    ry = weights[:, 1] ** 2 * (x2d[:, 1] - v) ** 2
    sq = (q * q).sum()
    # tensor constants: forward-mode AD of a 0-dim tensor combined with a
    # Python scalar gives float64 tangents on torch 2.13 (as in quat_to_matrix)
    qn = sq - torch.ones_like(sq)
    constraint = torch.full_like(sq, 2e8) * qn * qn
    return torch.cat([torch.stack([rx, ry], dim=1).reshape(-1), constraint[None]])


def register_gn(x2d, x3d, quat_init, trans_init, weights, K,
                max_iters: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton on the SQUARED residuals with adaptive Levenberg damping
    and step acceptance, the JAX `register_gn` (its docstring gives the
    reference and the deviation): value <- value - (J^T J + lam diag) ^-1 J^T f
    until sum|delta| <= 1e-4 or `max_iters`. The JAX while-loop becomes
    `max_iters` fixed iterations that freeze the state once it would stop.
    weights: (N, 2). Under `torch.func.vmap` each problem stops on its own."""
    params = torch.cat([quat_init, trans_init]).to(torch.float32)
    dev = params.device

    def f_fn(p):
        return _squared_residuals(p, x3d, x2d, K, weights)

    jac_fn = torch.func.jacfwd(f_fn)
    lam = torch.full((), 1e-4, device=dev)
    delta_sum = torch.full((), 700.0, device=dev)
    for _ in range(max_iters):
        active = delta_sum > 1e-4
        f = f_fn(params)
        J = jac_fn(params)
        JtJ = J.T @ J
        H = JtJ + torch.diag(lam * (torch.diagonal(JtJ) + 1e-4))
        delta = _solve(H, (J.T @ f)[:, None])[:, 0]
        new_params = params - delta
        new_f = f_fn(new_params)
        ok = torch.isfinite(new_params).all() & ((new_f * new_f).sum() < (f * f).sum())
        params = torch.where(active & ok, new_params, params)
        new_lam = torch.where(ok, lam * 0.33, lam * 4.0).clamp(1e-8, 1e10)
        new_sum = torch.where(ok, delta.abs().sum(), torch.ones((), device=dev))
        new_sum = torch.where(new_lam >= 1e10, torch.zeros((), device=dev), new_sum)
        lam = torch.where(active, new_lam, lam)
        delta_sum = torch.where(active, new_sum, delta_sum)
    return params[:4], params[4:]
