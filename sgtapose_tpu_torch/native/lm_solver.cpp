// Native weighted Gauss-Newton/LM 6-DoF pose refiner (float64).
//
// TPU-native framework's counterpart of the reference's C++/Eigen shared
// library (ref: sgtapose/rf_tools/libtestso_final.so, exported symbol
//   LM(value_init[7], x2d[N*2], x3d[N*3], weights[(N+1)*2], camera[9],
//      ans[7], N)
// and its python mirror rf_tools/LM.py:128-266). Same C ABI, same objective:
// rows are SQUARED weighted reprojection residuals f_i = w_i^2 r_i^2 plus a
// 1e8-weighted squared unit-quaternion constraint; the update is
//   value <- value - (J^T J + 1e-4 I)^{-1} J^T f
// stopping when sum|delta| <= 1e-4 or 200 iterations.
//
// Written from the behavioral spec, not the reference binary: plain C++
// (no Eigen), Jacobian by central finite differences in float64 (the
// objective is smooth; 1e-7 steps give ~1e-9 relative accuracy), 7x7 solve
// by partial-pivot Gaussian elimination.
//
// The JAX path (sgtapose_tpu/core/pnp.py register_gn) is the on-device
// solver used by the eval harness; this library is the float64 host
// reference implementation (ABI-parity oracle vs the reference binary,
// see tests/test_native_lm.py and tests/test_parity_solvers.py), loaded
// via ctypes (sgtapose_tpu/native/__init__.py).
//
// kMaxN bounds the fixed Jacobian scratch; the Python wrapper rejects
// larger inputs with a clear error instead of truncating.

#include <cmath>
#include <cstring>

constexpr int kMaxN = 512;

namespace {

// rotate p by (possibly non-unit) quaternion via q p q* — matches the
// reference's symbolic expansion, which never normalizes.
inline void quat_rotate(const double q[4], const double p[3], double out[3]) {
  const double qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  // t = q * (0, p)
  const double tw = -qx * p[0] - qy * p[1] - qz * p[2];
  const double tx = qw * p[0] + qy * p[2] - qz * p[1];
  const double ty = qw * p[1] - qx * p[2] + qz * p[0];
  const double tz = qw * p[2] + qx * p[1] - qy * p[0];
  // out = t * conj(q)
  out[0] = -tw * qx + tx * qw - ty * qz + tz * qy;
  out[1] = -tw * qy + tx * qz + ty * qw - tz * qx;
  out[2] = -tw * qz - tx * qy + ty * qx + tz * qw;
}

// residual vector f (2n + 1 rows)
void residuals(const double value[7], const double* x2d, const double* x3d,
               const double* w, const double camera[9], int n, double* f) {
  const double fx = camera[0], cx = camera[2];
  const double fy = camera[4], cy = camera[5];
  const double* q = value;
  const double* t = value + 4;
  for (int i = 0; i < n; ++i) {
    double cam[3];
    quat_rotate(q, x3d + 3 * i, cam);
    cam[0] += t[0];
    cam[1] += t[1];
    cam[2] += t[2];
    const double u = (fx * cam[0] + cx * cam[2]) / cam[2];
    const double v = (fy * cam[1] + cy * cam[2]) / cam[2];
    const double wx = w[2 * i], wy = w[2 * i + 1];
    const double rx = x2d[2 * i] - u;
    const double ry = x2d[2 * i + 1] - v;
    f[2 * i] = wx * wx * rx * rx;
    f[2 * i + 1] = wy * wy * ry * ry;
  }
  const double qn = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] - 1.0;
  f[2 * n] = 2e8 * qn * qn;
}

// central-difference Jacobian, rows = 2n+1, cols = 7 (row-major)
void jacobian(const double value[7], const double* x2d, const double* x3d,
              const double* w, const double camera[9], int n, double* J) {
  const int m = 2 * n + 1;
  double vp[7], vm[7];
  double fp[2 * kMaxN + 1], fm[2 * kMaxN + 1];
  for (int k = 0; k < 7; ++k) {
    const double h = 1e-7 * (1.0 + std::fabs(value[k]));
    std::memcpy(vp, value, sizeof(vp));
    std::memcpy(vm, value, sizeof(vm));
    vp[k] += h;
    vm[k] -= h;
    residuals(vp, x2d, x3d, w, camera, n, fp);
    residuals(vm, x2d, x3d, w, camera, n, fm);
    const double inv2h = 1.0 / (2.0 * h);
    for (int r = 0; r < m; ++r) J[r * 7 + k] = (fp[r] - fm[r]) * inv2h;
  }
}

// solve A x = b for 7x7 A (destroys A, b); returns false if singular
bool solve7(double A[49], double b[7], double x[7]) {
  int piv[7];
  for (int i = 0; i < 7; ++i) piv[i] = i;
  for (int col = 0; col < 7; ++col) {
    int best = col;
    double mx = std::fabs(A[piv[col] * 7 + col]);
    for (int r = col + 1; r < 7; ++r) {
      const double v = std::fabs(A[piv[r] * 7 + col]);
      if (v > mx) { mx = v; best = r; }
    }
    if (mx < 1e-300) return false;
    int tmp = piv[col]; piv[col] = piv[best]; piv[best] = tmp;
    const double d = A[piv[col] * 7 + col];
    for (int r = col + 1; r < 7; ++r) {
      const double m = A[piv[r] * 7 + col] / d;
      if (m == 0.0) continue;
      for (int c = col; c < 7; ++c) A[piv[r] * 7 + c] -= m * A[piv[col] * 7 + c];
      b[piv[r]] -= m * b[piv[col]];
    }
  }
  for (int col = 6; col >= 0; --col) {
    double s = b[piv[col]];
    for (int c = col + 1; c < 7; ++c) s -= A[piv[col] * 7 + c] * x[c];
    x[col] = s / A[piv[col] * 7 + col];
  }
  return true;
}

}  // namespace

extern "C" {

// Reference-compatible entry point (same signature as the ref .so's `LM`).
// weights has (n+1)*2 doubles; the trailing pair is the (implicit-in-math)
// 1e8 constraint weight and is ignored here, matching how the reference's
// `fun` hardcodes the constraint scale.
void LM(const double* value_init, const double* x2d, const double* x3d,
        const double* weights, const double* camera, double* ans, int n) {
  if (n > kMaxN) n = kMaxN;  // scratch bound; wrapper raises before this
  const int m = 2 * n + 1;
  double value[7];
  std::memcpy(value, value_init, sizeof(value));

  double f[2 * kMaxN + 1];
  double J[(2 * kMaxN + 1) * 7];

  for (int iter = 0; iter < 200; ++iter) {
    residuals(value, x2d, x3d, weights, camera, n, f);
    jacobian(value, x2d, x3d, weights, camera, n, J);

    double JtJ[49];
    double Jtf[7];
    for (int a = 0; a < 7; ++a) {
      Jtf[a] = 0.0;
      for (int b = 0; b < 7; ++b) JtJ[a * 7 + b] = (a == b) ? 1e-4 : 0.0;
    }
    for (int r = 0; r < m; ++r) {
      const double* row = J + r * 7;
      for (int a = 0; a < 7; ++a) {
        Jtf[a] += row[a] * f[r];
        for (int b = a; b < 7; ++b) JtJ[a * 7 + b] += row[a] * row[b];
      }
    }
    for (int a = 0; a < 7; ++a)
      for (int b = 0; b < a; ++b) JtJ[a * 7 + b] = JtJ[b * 7 + a];

    double delta[7];
    if (!solve7(JtJ, Jtf, delta)) break;
    double dsum = 0.0;
    for (int k = 0; k < 7; ++k) {
      value[k] -= delta[k];
      dsum += std::fabs(delta[k]);
    }
    if (!(dsum > 1e-4)) break;  // also exits on NaN
  }
  std::memcpy(ans, value, sizeof(value));
}

}  // extern "C"
