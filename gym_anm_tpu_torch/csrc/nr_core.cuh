// Dense polar Newton-Raphson power flow for one env lane (float32): the
// body shared by the dense-NR kernel (nr_dense.cu) and the whole-transition
// kernel (step_fused.cu).
//
// The per-lane form of gym_anm_tpu/ops/pallas_nr.py::nr_core, in the same
// order of operations as its plain PyTorch twin
// gym_anm_tpu_torch/ops/nr_cuda.py::nr_core_plain:
//
// * flat start (theta = 0, |V| = 1, the slack pinned at 1 + 0j);
// * an optional chord prefix x <- x - J0inv F(x) with the constant
//   flat-start Jacobian inverse; a lane that ends it worse than it started
//   (or NaN) restarts from the flat start, keeping its iteration count;
// * max_iter true-NR steps: the full [2m, 2m] polar Jacobian at the carried
//   point and current I = YV, Gaussian elimination of [J | F] (pivot-free,
//   or partial pivoting on the first row of largest magnitude, as
//   jnp.argmax picks), back substitution, the step x <- x - dx.
//
// I = YV is an exact sequential float32 sum over k; the inf-norm of F
// tracks NaN explicitly (fmaxf drops it), so a NaN lane stops and is never
// reported converged.  A lane stops iterating once its mismatch is not above
// x_tol: the per-lane form of the TPU kernel's masked updates.
//
// The lane's state (V, I, F and the augmented system [J | F]) lives in a
// per-thread local array sized for the largest system, 2(n-1) <= kNNMax.

#pragma once

#include <math.h>

namespace nrcore {

constexpr int kNNMax = 64;             // largest 2(n-1): the 33-bus feeder
constexpr int kNMax = kNNMax / 2 + 1;  // buses, slack included
constexpr int kMMax = kNMax - 1;       // non-slack buses

struct Tables {
  const float* Yre;    // [n, n]
  const float* Yim;    // [n, n]
  const float* J0inv;  // [2m, 2m]
  int n;
};

struct Lane {
  float p[kMMax], q[kMMax];  // non-slack injections
  float theta[kMMax], vm[kMMax];
  float vr[kNMax], vi[kNMax], ir[kNMax], ii[kNMax];
  float vnr[kNMax], vni[kNMax];
  float F[kNNMax], dx[kNNMax];
  float Ab[kNNMax * (kNNMax + 1)];  // row-major [nn, nn + 1]
};

// max(a, b) that returns NaN when either is NaN (jnp.maximum).
__device__ inline float nanmax(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b); }

__device__ inline void construct_v(Lane& ln, int m) {
  ln.vr[0] = 1.0f;
  ln.vi[0] = 0.0f;
  for (int i = 0; i < m; ++i) {
    ln.vr[i + 1] = ln.vm[i] * cosf(ln.theta[i]);
    ln.vi[i + 1] = ln.vm[i] * sinf(ln.theta[i]);
  }
}

__device__ inline void yv(const Tables& t, Lane& ln) {
  const int n = t.n;
  for (int i = 0; i < n; ++i) {
    float ar = 0.0f, ai = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float yr = t.Yre[i * n + k], yi = t.Yim[i * n + k];
      ar = ar + (yr * ln.vr[k] - yi * ln.vi[k]);
      ai = ai + (yr * ln.vi[k] + yi * ln.vr[k]);
    }
    ln.ir[i] = ar;
    ln.ii[i] = ai;
  }
}

// V and I at (theta, vm), then F and its inf-norm (NaN if any entry is NaN).
__device__ inline float evaluate(const Tables& t, Lane& ln) {
  const int m = t.n - 1;
  construct_v(ln, m);
  yv(t, ln);
  float diff = 0.0f;
  bool nan = false;
  for (int i = 0; i < m; ++i) {
    const float vr = ln.vr[i + 1], vi = ln.vi[i + 1], ir = ln.ir[i + 1], ii = ln.ii[i + 1];
    const float fp = (vr * ir + vi * ii) - ln.p[i];
    const float fq = (vi * ir - vr * ii) - ln.q[i];
    ln.F[i] = fp;
    ln.F[m + i] = fq;
    const float a = fabsf(fp), c = fabsf(fq);
    if (isnan(a) || isnan(c)) nan = true;
    diff = fmaxf(diff, fmaxf(a, c));
  }
  return nan ? NAN : diff;
}

// The flat start: theta = 0, |V| = 1.
__device__ inline float flat_start(const Tables& t, Lane& ln) {
  for (int i = 0; i < t.n - 1; ++i) {
    ln.theta[i] = 0.0f;
    ln.vm[i] = 1.0f;
  }
  return evaluate(t, ln);
}

// [J | F] at the carried point (V, I): rows i, columns k over the non-slack
// buses; J = [[dSa_re, dSm_re], [dSa_im, dSm_im]].
__device__ inline void build_system(const Tables& t, Lane& ln) {
  const int n = t.n, m = n - 1, nn = 2 * m, w = nn + 1;
  for (int k = 0; k < n; ++k) {
    const float vmag = sqrtf(ln.vr[k] * ln.vr[k] + ln.vi[k] * ln.vi[k]);
    ln.vnr[k] = ln.vr[k] / vmag;
    ln.vni[k] = ln.vi[k] / vmag;
  }
  for (int i = 1; i < n; ++i) {
    const float a = ln.vr[i], b = ln.vi[i];
    const float t1_re = ln.vnr[i] * ln.ir[i] + ln.vni[i] * ln.ii[i];
    const float t1_im = ln.vni[i] * ln.ir[i] - ln.vnr[i] * ln.ii[i];
    float* top = ln.Ab + (i - 1) * w;
    float* bot = ln.Ab + (m + i - 1) * w;
    for (int k = 1; k < n; ++k) {
      const float yr = t.Yre[i * n + k], yi = t.Yim[i * n + k];
      const bool diag = i == k;
      const float yv_re = yr * ln.vr[k] - yi * ln.vi[k];
      const float yv_im = yr * ln.vi[k] + yi * ln.vr[k];
      const float w_re = (diag ? ln.ir[i] : 0.0f) - yv_re;
      const float w_im = (diag ? ln.ii[i] : 0.0f) - yv_im;
      const float u_re = yr * ln.vnr[k] - yi * ln.vni[k];
      const float u_im = yr * ln.vni[k] + yi * ln.vnr[k];
      top[k - 1] = a * w_im - b * w_re;                                // dSa_re
      bot[k - 1] = a * w_re + b * w_im;                                // dSa_im
      top[m + k - 1] = (diag ? t1_re : 0.0f) + (a * u_re + b * u_im);  // dSm_re
      bot[m + k - 1] = (diag ? t1_im : 0.0f) + (b * u_re - a * u_im);  // dSm_im
    }
  }
  for (int r = 0; r < nn; ++r) ln.Ab[r * w + nn] = ln.F[r];
}

// Solve [J | F] in place; the step goes to dx.  Back substitution carries
// each row's sum sum_{j>r} A_rj x_j, accumulated as the x_j become known
// (j descending), in F (no longer needed).
__device__ inline void solve_system(Lane& ln, int nn, bool pivot) {
  const int w = nn + 1;
  float* Ab = ln.Ab;
  for (int k = 0; k < nn; ++k) {
    if (pivot) {
      int piv = k;
      float best = -1.0f;
      for (int r = k; r < nn; ++r) {
        const float v = fabsf(Ab[r * w + k]);
        if (isnan(v)) {  // argmax returns the first NaN
          piv = r;
          break;
        }
        if (v > best) {
          best = v;
          piv = r;
        }
      }
      if (piv != k) {
        for (int c = 0; c < w; ++c) {
          const float tmp = Ab[k * w + c];
          Ab[k * w + c] = Ab[piv * w + c];
          Ab[piv * w + c] = tmp;
        }
      }
    }
    const float pv = Ab[k * w + k];
    for (int r = k + 1; r < nn; ++r) {
      const float f = Ab[r * w + k] / pv;
      for (int c = k + 1; c < w; ++c) Ab[r * w + c] = Ab[r * w + c] - f * Ab[k * w + c];
    }
  }
  for (int r = 0; r < nn; ++r) ln.F[r] = 0.0f;
  for (int k = nn - 1; k >= 0; --k) {
    const float x = (Ab[k * w + nn] - ln.F[k]) / Ab[k * w + k];
    ln.dx[k] = x;
    for (int r = 0; r < k; ++r) ln.F[r] = ln.F[r] + Ab[r * w + k] * x;
  }
}

// The whole solve for one lane with injections ln.p, ln.q.  On return ln.vr,
// ln.vi, ln.ir, ln.ii describe the last accepted point; *diff_out is its
// mismatch inf-norm and *it_out the chord + NR iterations taken.
__device__ inline void solve(const Tables& t, Lane& ln, float x_tol, int max_iter, int chord_iters, bool pivot,
                             float* diff_out, int* it_out) {
  const int m = t.n - 1, nn = 2 * m;
  float diff = flat_start(t, ln);
  int it = 0;
  if (chord_iters > 0) {
    const float diff0 = diff;
    for (int c = 0; c < chord_iters && diff > x_tol; ++c) {  // NaN stops the lane
      for (int i = 0; i < nn; ++i) {
        float acc = 0.0f;
        for (int j = 0; j < nn; ++j) acc = acc + t.J0inv[i * nn + j] * ln.F[j];
        ln.dx[i] = acc;
      }
      for (int i = 0; i < m; ++i) {
        ln.theta[i] = ln.theta[i] - ln.dx[i];
        ln.vm[i] = ln.vm[i] - ln.dx[m + i];
      }
      diff = evaluate(t, ln);
      ++it;
    }
    if (!isfinite(diff) || diff > diff0) diff = flat_start(t, ln);  // worsened: restart
  }
  for (int k = 0; k < max_iter && diff > x_tol; ++k) {
    build_system(t, ln);
    solve_system(ln, nn, pivot);
    for (int i = 0; i < m; ++i) {
      ln.theta[i] = ln.theta[i] - ln.dx[i];
      ln.vm[i] = ln.vm[i] - ln.dx[m + i];
    }
    diff = evaluate(t, ln);
    ++it;
  }
  *diff_out = diff;
  *it_out = it;
}

}  // namespace nrcore
