// Tree-structured Newton-Raphson power flow for radial grids, one thread per
// env lane (float32).
//
// Replaces the TPU kernel gym_anm_tpu/ops/pallas_tree.py::_tree_tile_kernel.
// It computes the same thing per lane: the exact polar NR power flow of a
// radial grid from a flat start (theta = 0, |V| = 1, slack pinned at 1+0j).
// Each iteration evaluates V, I = YV over the tree edges (diagonal, parent
// read through the runs, children pushed through the runs) and the mismatch
// F = V conj(I) - S; a lane whose inf-norm is above x_tol builds the 2x2
// polar Jacobian blocks D/L/U, eliminates leaf to root (effective diagonal,
// adjugate inverse, Schur push of M U and M b to the parent, M = L D^-1),
// back-substitutes root first and takes the step.  The mismatch is
// evaluated once after each update and carried, so `diff` is always the
// mismatch of the returned point.  A lane whose mismatch is not above x_tol
// (NaN included) stops: the per-lane form of the TPU kernel's masked update
// and whole-tile early exit, with the same iteration counts.
//
// Layout: every [S, B] array is batch-last, so thread b reads s*B + b and
// neighbouring threads read neighbouring addresses.  The slot schedule
// (levels (off, W), runs (src, k, dst) per level, ycols [S, 8]) is read from
// device arrays in runtime loops, so one binary serves every grid size.
//
// What bounds it on an H100: per-lane state lives in the caller's scratch
// buffer ([N_PLANES, S, B] float32), so every step is scratch traffic through
// L2 and device memory (about 30 planes of S*B floats per iteration), and at
// B = 4096 with 128 threads a block the launch has only 32 blocks for 132
// SMs.  Keeping the state in registers or shared memory, and filling the
// card, is later work.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;

// Columns of the per-slot static table ycols [S, 8].
enum { YC_DIAG_RE, YC_DIAG_IM, YC_UP_RE, YC_UP_IM, YC_DOWN_RE, YC_DOWN_IM, YC_HASPAR, YC_PAD };

// Planes of the per-lane scratch buffer, each [S, B].
enum Plane {
  TH, VM,              // carried point: angle and magnitude
  VR, VI,              // V at the point
  VPR, VPI,            // parent voltage of each slot (slack parent: 1+0j)
  IR, II,              // I = YV
  FP, FQ,              // mismatch
  D00, D01, D10, D11,  // diagonal Jacobian block
  L00, L01, L10, L11,  // J[parent, node]
  U00, U01, U10, U11,  // J[node, parent]
  A00, A01, A10, A11,  // Schur accumulators, then D^-1
  AB0, AB1,            // rhs accumulators, then the effective rhs
  X0, X1,              // step
  XP0, XP1,            // parent step read through the runs
  N_PLANES
};

struct Lane {
  float* base;
  int S, B, b;
  __device__ float& at(int plane, int s) const { return base[((size_t)plane * S + s) * B + b]; }
};

struct Schedule {
  const float* yc;       // [S, 8]
  const int* levels;     // [n_levels, 2] (off, W)
  const int* run_ptr;    // [n_levels + 1]
  const int* runs;       // [R, 3] (src, k, dst)
  int S, n_levels;
  __device__ float y(int s, int c) const { return yc[s * 8 + c]; }
};

__device__ inline void cmul(float ar, float ai, float br, float bi, float& cr, float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

// 2x2 polar Jacobian block for row-bus voltage (a, b), current term w and
// Y vn term u (solve_load_flow.py:123-164).
__device__ inline void blocks(float a, float b, float wre, float wim, float ure, float uim,
                              float& j00, float& j01, float& j10, float& j11) {
  j00 = a * wim - b * wre;
  j10 = a * wre + b * wim;
  j01 = a * ure + b * uim;
  j11 = b * ure - a * uim;
}

// V, parent voltages, I = YV and F at the carried point; returns the
// inf-norm of F (NaN if any entry is NaN).
__device__ float eval_point(const Lane& ln, const Schedule& sc, const float* p, const float* q) {
  const int S = sc.S, B = ln.B, b = ln.b;
  for (int s = 0; s < S; ++s) {
    const float th = ln.at(TH, s), vm = ln.at(VM, s);
    ln.at(VR, s) = vm * cosf(th);
    ln.at(VI, s) = vm * sinf(th);
    ln.at(VPR, s) = 1.0f;
    ln.at(VPI, s) = 0.0f;
    ln.at(IR, s) = 0.0f;
    ln.at(II, s) = 0.0f;
  }
  const int n_runs = sc.run_ptr[sc.n_levels];
  for (int r = 0; r < n_runs; ++r) {
    const int src = sc.runs[3 * r], k = sc.runs[3 * r + 1], dst = sc.runs[3 * r + 2];
    for (int i = 0; i < k; ++i) {
      ln.at(VPR, src + i) = ln.at(VR, dst + i);
      ln.at(VPI, src + i) = ln.at(VI, dst + i);
    }
  }
  // Child contributions y_down * v pushed to the parent.
  for (int r = 0; r < n_runs; ++r) {
    const int src = sc.runs[3 * r], k = sc.runs[3 * r + 1], dst = sc.runs[3 * r + 2];
    for (int i = 0; i < k; ++i) {
      float cr, ci;
      cmul(sc.y(src + i, YC_DOWN_RE), sc.y(src + i, YC_DOWN_IM), ln.at(VR, src + i), ln.at(VI, src + i), cr, ci);
      ln.at(IR, dst + i) += cr;
      ln.at(II, dst + i) += ci;
    }
  }
  float diff = 0.0f;
  bool nan = false;
  for (int s = 0; s < S; ++s) {
    const float vr = ln.at(VR, s), vi = ln.at(VI, s);
    float dr, di, ur, ui;
    cmul(sc.y(s, YC_DIAG_RE), sc.y(s, YC_DIAG_IM), vr, vi, dr, di);
    cmul(sc.y(s, YC_UP_RE), sc.y(s, YC_UP_IM), ln.at(VPR, s), ln.at(VPI, s), ur, ui);
    const float ir = dr + ur + ln.at(IR, s);
    const float ii = di + ui + ln.at(II, s);
    const float realm = 1.0f - sc.y(s, YC_PAD);
    const float fp = realm * (vr * ir + vi * ii - p[(size_t)s * B + b]);
    const float fq = realm * (vi * ir - vr * ii - q[(size_t)s * B + b]);
    ln.at(IR, s) = ir;
    ln.at(II, s) = ii;
    ln.at(FP, s) = fp;
    ln.at(FQ, s) = fq;
    const float a = fabsf(fp), c = fabsf(fq);
    if (isnan(a) || isnan(c)) nan = true;
    diff = fmaxf(diff, fmaxf(a, c));
  }
  return nan ? NAN : diff;
}

// The NR step X = J^-1 F at the evaluated point.
__device__ void newton_step(const Lane& ln, const Schedule& sc) {
  const int S = sc.S;
  // Full-width block assembly (order-independent).
  for (int s = 0; s < S; ++s) {
    const float vr = ln.at(VR, s), vi = ln.at(VI, s);
    const float vpr = ln.at(VPR, s), vpi = ln.at(VPI, s);
    const float ir = ln.at(IR, s), ii = ln.at(II, s);
    const float vmag = sqrtf(vr * vr + vi * vi);
    const float vnr = vr / vmag, vni = vi / vmag;
    const float pmag = sqrtf(vpr * vpr + vpi * vpi);
    const float pnr = vpr / pmag, pni = vpi / pmag;
    const float hp = sc.y(s, YC_HASPAR), pad = sc.y(s, YC_PAD);
    const float ydr = sc.y(s, YC_DIAG_RE), ydi = sc.y(s, YC_DIAG_IM);
    const float yur = sc.y(s, YC_UP_RE), yui = sc.y(s, YC_UP_IM);
    const float ywr = sc.y(s, YC_DOWN_RE), ywi = sc.y(s, YC_DOWN_IM);
    float yvr, yvi, ure, uim, wre, wim, j00, j01, j10, j11;

    // Diagonal: w = I - Y_ii v ; u = Y_ii vn ; t1 = vn conj(I).
    cmul(ydr, ydi, vr, vi, yvr, yvi);
    cmul(ydr, ydi, vnr, vni, ure, uim);
    const float t1r = vnr * ir + vni * ii;
    const float t1i = vni * ir - vnr * ii;
    blocks(vr, vi, ir - yvr, ii - yvi, ure, uim, j00, j01, j10, j11);
    ln.at(D00, s) = j00 + pad;  // pad slots: identity diagonal block
    ln.at(D01, s) = j01 + t1r;
    ln.at(D10, s) = j10;
    ln.at(D11, s) = j11 + t1i + pad;
    // L = J[par, node]: row voltage v_par, w = -Y_down v, u = Y_down vn.
    cmul(ywr, ywi, vr, vi, wre, wim);
    cmul(ywr, ywi, vnr, vni, ure, uim);
    blocks(vpr, vpi, -wre, -wim, ure, uim, j00, j01, j10, j11);
    ln.at(L00, s) = hp * j00;
    ln.at(L01, s) = hp * j01;
    ln.at(L10, s) = hp * j10;
    ln.at(L11, s) = hp * j11;
    // U = J[node, par]: row voltage v, w = -Y_up v_par, u = Y_up vn_par.
    cmul(yur, yui, vpr, vpi, wre, wim);
    cmul(yur, yui, pnr, pni, ure, uim);
    blocks(vr, vi, -wre, -wim, ure, uim, j00, j01, j10, j11);
    ln.at(U00, s) = hp * j00;
    ln.at(U01, s) = hp * j01;
    ln.at(U10, s) = hp * j10;
    ln.at(U11, s) = hp * j11;
    ln.at(A00, s) = 0.0f;
    ln.at(A01, s) = 0.0f;
    ln.at(A10, s) = 0.0f;
    ln.at(A11, s) = 0.0f;
    ln.at(AB0, s) = 0.0f;
    ln.at(AB1, s) = 0.0f;
  }

  // Leaf-to-root elimination.
  for (int l = 0; l < sc.n_levels; ++l) {
    const int off = sc.levels[2 * l], W = sc.levels[2 * l + 1];
    for (int s = off; s < off + W; ++s) {
      const float d00 = ln.at(D00, s) - ln.at(A00, s);
      const float d01 = ln.at(D01, s) - ln.at(A01, s);
      const float d10 = ln.at(D10, s) - ln.at(A10, s);
      const float d11 = ln.at(D11, s) - ln.at(A11, s);
      const float b0 = ln.at(FP, s) - ln.at(AB0, s);
      const float b1 = ln.at(FQ, s) - ln.at(AB1, s);
      const float det = d00 * d11 - d01 * d10;
      ln.at(A00, s) = d11 / det;
      ln.at(A01, s) = -d01 / det;
      ln.at(A10, s) = -d10 / det;
      ln.at(A11, s) = d00 / det;
      ln.at(AB0, s) = b0;
      ln.at(AB1, s) = b1;
    }
    // Push the Schur complement to the parents: M = L D^-1, M U and M b.
    for (int r = sc.run_ptr[l]; r < sc.run_ptr[l + 1]; ++r) {
      const int src = sc.runs[3 * r], k = sc.runs[3 * r + 1], dst = sc.runs[3 * r + 2];
      for (int i = 0; i < k; ++i) {
        const int s = src + i, t = dst + i;
        const float i00 = ln.at(A00, s), i01 = ln.at(A01, s), i10 = ln.at(A10, s), i11 = ln.at(A11, s);
        const float l00 = ln.at(L00, s), l01 = ln.at(L01, s), l10 = ln.at(L10, s), l11 = ln.at(L11, s);
        const float m00 = l00 * i00 + l01 * i10;
        const float m01 = l00 * i01 + l01 * i11;
        const float m10 = l10 * i00 + l11 * i10;
        const float m11 = l10 * i01 + l11 * i11;
        const float u00 = ln.at(U00, s), u01 = ln.at(U01, s), u10 = ln.at(U10, s), u11 = ln.at(U11, s);
        const float b0 = ln.at(AB0, s), b1 = ln.at(AB1, s);
        ln.at(A00, t) += m00 * u00 + m01 * u10;
        ln.at(A01, t) += m00 * u01 + m01 * u11;
        ln.at(A10, t) += m10 * u00 + m11 * u10;
        ln.at(A11, t) += m10 * u01 + m11 * u11;
        ln.at(AB0, t) += m00 * b0 + m01 * b1;
        ln.at(AB1, t) += m10 * b0 + m11 * b1;
      }
    }
  }

  // Back-substitution, root level first (slack parents read 0).
  for (int l = sc.n_levels - 1; l >= 0; --l) {
    const int off = sc.levels[2 * l], W = sc.levels[2 * l + 1];
    for (int s = off; s < off + W; ++s) {
      ln.at(XP0, s) = 0.0f;
      ln.at(XP1, s) = 0.0f;
    }
    for (int r = sc.run_ptr[l]; r < sc.run_ptr[l + 1]; ++r) {
      const int src = sc.runs[3 * r], k = sc.runs[3 * r + 1], dst = sc.runs[3 * r + 2];
      for (int i = 0; i < k; ++i) {
        ln.at(XP0, src + i) = ln.at(X0, dst + i);
        ln.at(XP1, src + i) = ln.at(X1, dst + i);
      }
    }
    for (int s = off; s < off + W; ++s) {
      const float xp0 = ln.at(XP0, s), xp1 = ln.at(XP1, s);
      const float r0 = ln.at(AB0, s) - (ln.at(U00, s) * xp0 + ln.at(U01, s) * xp1);
      const float r1 = ln.at(AB1, s) - (ln.at(U10, s) * xp0 + ln.at(U11, s) * xp1);
      ln.at(X0, s) = ln.at(A00, s) * r0 + ln.at(A01, s) * r1;
      ln.at(X1, s) = ln.at(A10, s) * r0 + ln.at(A11, s) * r1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tree_nr_kernel(const float* __restrict__ p, const float* __restrict__ q, Schedule sc, int B, float x_tol,
               int max_iter, float* __restrict__ scratch, float* __restrict__ v_re, float* __restrict__ v_im,
               float* __restrict__ diff_out, int* __restrict__ n_iter_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Lane ln{scratch, sc.S, B, b};
  for (int s = 0; s < sc.S; ++s) {
    ln.at(TH, s) = 0.0f;
    ln.at(VM, s) = 1.0f;
  }
  float diff = eval_point(ln, sc, p, q);
  int it = 0;
  for (int k = 0; k < max_iter; ++k) {
    const bool active = diff > x_tol;  // NaN freezes the lane
    if (!active) break;
    newton_step(ln, sc);
    for (int s = 0; s < sc.S; ++s) {
      ln.at(TH, s) -= ln.at(X0, s);
      ln.at(VM, s) -= ln.at(X1, s);
    }
    ++it;
    diff = eval_point(ln, sc, p, q);
  }
  for (int s = 0; s < sc.S; ++s) {
    v_re[(size_t)s * B + b] = ln.at(VR, s);
    v_im[(size_t)s * B + b] = ln.at(VI, s);
  }
  diff_out[b] = diff;
  n_iter_out[b] = it;
}

}  // namespace

extern "C" int tree_nr_scratch_planes() { return N_PLANES; }

// p, q, v_re, v_im: [S, B]; scratch: [tree_nr_scratch_planes(), S, B];
// diff, n_iter: [B].  All device pointers; `stream` is a cudaStream_t.
extern "C" int tree_nr_solve_f32(const float* p, const float* q, const float* ycols, const int* levels,
                                 const int* run_ptr, const int* runs, int S, int n_levels, int B, float x_tol,
                                 int max_iter, float* scratch, float* v_re, float* v_im, float* diff,
                                 int* n_iter, void* stream) {
  const Schedule sc{ycols, levels, run_ptr, runs, S, n_levels};
  const int blocks = (B + kThreads - 1) / kThreads;
  tree_nr_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, q, sc, B, x_tol, max_iter, scratch, v_re, v_im, diff, n_iter);
  return static_cast<int>(cudaGetLastError());
}
