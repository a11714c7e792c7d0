// Tree-structured Newton-Raphson power flow of one env lane on a radial grid,
// solved by a team of threads (float32): the body shared by the tree-NR
// kernel (tree_nr.cu) and the whole-transition kernel's tree form
// (step_fused.cu).
//
// Per lane, in the order of operations of the plain twin
// gym_anm_tpu_torch/ops/tree_cuda.py::tree_newton_plain: the exact polar NR
// power flow from a flat start (theta = 0, |V| = 1, slack pinned at 1+0j)
// or, given a warm point, from whichever of {warm, flat} has the smaller
// finite mismatch.  Each iteration evaluates V, I = YV over the tree edges
// and the mismatch F = V conj(I) - S; a lane whose inf-norm is above x_tol
// builds the 2x2 polar Jacobian blocks D/L/U, eliminates leaf to root
// (effective diagonal, adjugate inverse, Schur complement M U and M b with
// M = L D^-1), back-substitutes root first and takes the step.  A lane
// whose mismatch is not above x_tol (NaN included) stops.
//
// The design (tree_nr.cu says what it answers):
//
// * a lane is solved by a team of T threads (T = 8 for S <= 16, T = 32
//   above).  The S-wide stages (evaluation, block assembly, update) split
//   the slots s = t (mod T); the elimination and the back substitution
//   split each level's W slots the same way, with a team barrier between
//   levels;
// * the lane's state lives in shared memory, 22 planes of S floats (the
//   point, the injections, V, I, F, D, L, U), reused as the step goes:
//   after a slot is eliminated D holds its inverse, F its effective rhs and
//   then its step, L its Schur push M U and I its push M b;
// * the schedule (the admittance columns, each slot's parent and children,
//   the levels) is staged once per block in shared memory;
// * sums keep the plain twin's order: a parent gathers its children's
//   contributions (y_down v in the evaluation, M U and M b in the
//   elimination) in the order of the runs, which is the order the plain
//   twin pushes them in;
// * all teams of a warp run the warp's loop until its last lane is done,
//   frozen lanes updating nothing, so every barrier and vote is
//   warp-uniform: a kernel keeps every thread of a warp to the end, lanes
//   past the batch included;
// * the mismatch norm is a team max with an explicit NaN flag (fmaxf drops
//   NaN), so a NaN lane freezes and is never reported converged.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace treecore {

constexpr unsigned kFull = 0xffffffffu;

// Columns of the per-slot static table ycols [S, 8].
enum { YC_DIAG_RE, YC_DIAG_IM, YC_UP_RE, YC_UP_IM, YC_DOWN_RE, YC_DOWN_IM, YC_HASPAR, YC_PAD, YC_COLS };

// Planes of a lane's shared-memory region, each S floats.
enum Plane {
  TH, VM,              // carried point: angle and magnitude
  PP, PQ,              // injections
  VR, VI,              // V at the point
  IR, II,              // I = YV; once the slot is eliminated, its push M b
  FP, FQ,              // mismatch; then the effective rhs; then the step
  D00, D01, D10, D11,  // diagonal block; then the effective block's inverse
  L00, L01, L10, L11,  // J[parent, node]; then the slot's push M U
  U00, U01, U10, U11,  // J[node, parent]
  N_PLANES
};

// A team size and the most lanes a block holds.  Every thread of a warp
// takes part in every barrier, so a block's lanes are whole teams.
template <int kTeam, int kLanes>
struct SizeClass {
  static constexpr int T = kTeam;
  static constexpr int kLanesMax = kLanes;
  static constexpr int kThreadsMax = kTeam * kLanes;
};
using SmallClass = SizeClass<8, 16>;  // S <= kSmallSlots (ANM6: S = 5)
using LargeClass = SizeClass<32, 8>;  // the feeders
constexpr int kSmallSlots = 16;

// The schedule's device tables, as the host hands them over.
struct Tables {
  const float* ycols;  // [S, 8]
  const int* par;      // [S] parent slot, -1 under the slack
  const int* ch;       // [maxC, S] children in run order, -1 padded
  const int* levels;   // [n_levels, 2] (off, W), leaves first
  int S, maxC, n_levels;
};

// The schedule as the block's shared copy holds it.
struct Sched {
  const float* yc;  // [8, S]: column c of slot s at c * S + s
  const int* par;
  const int* ch;
  const int* lv;
  int S, maxC, n_levels;
  __device__ float y(int c, int s) const { return yc[c * S + s]; }
};

// 4-byte words of the block's schedule copy.
__host__ __device__ inline int table_words(int S, int maxC, int n_levels) {
  return YC_COLS * S + (1 + maxC) * S + 2 * n_levels;
}

// Floats between consecutive lanes of a block, for the planes and `extra`
// floats after them: teams sharing a warp start 8 banks apart (mod 32); one
// team a warp needs no padding.
__host__ __device__ inline int lane_floats(int S, int team, int extra = 0) {
  const int f = N_PLANES * S + extra;
  return team < 32 ? ((f + 31) / 32) * 32 + 8 : f;
}

// Copy the schedule into the front of the block's shared memory (all
// threads of the block take part); ycols goes transposed to [8, S] so that
// a team's threads read consecutive words.
__device__ inline Sched stage_schedule(const Tables& t, float* smem) {
  const int S = t.S;
  float* yc = smem;
  int* par = reinterpret_cast<int*>(smem + YC_COLS * S);
  int* ch = par + S;
  int* lv = ch + t.maxC * S;
  for (int i = threadIdx.x; i < YC_COLS * S; i += blockDim.x) yc[(i % YC_COLS) * S + i / YC_COLS] = t.ycols[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) par[i] = t.par[i];
  for (int i = threadIdx.x; i < t.maxC * S; i += blockDim.x) ch[i] = t.ch[i];
  for (int i = threadIdx.x; i < 2 * t.n_levels; i += blockDim.x) lv[i] = t.levels[i];
  __syncthreads();
  return Sched{yc, par, ch, lv, S, t.maxC, t.n_levels};
}

struct Lane {
  float* r;
  int S;
  __device__ float& at(int plane, int s) const { return r[plane * S + s]; }
};

template <int T>
struct Team {
  int t;
  __device__ void sync() const { __syncwarp(kFull); }
  __device__ float xor_(float v, int o) const { return __shfl_xor_sync(kFull, v, o, T); }
  __device__ int xor_(int v, int o) const { return __shfl_xor_sync(kFull, v, o, T); }
  // max over the team, NaN if any thread saw NaN (fmaxf drops it).
  __device__ float max_nan(float v, bool nan) const {
    int flag = nan ? 1 : 0;
    for (int o = T / 2; o > 0; o >>= 1) {
      v = fmaxf(v, xor_(v, o));
      flag |= xor_(flag, o);
    }
    return flag ? NAN : v;
  }
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

// The parent voltage of slot s (the slack's 1+0j above the root level).
__device__ inline void parent_v(const Sched& sc, const Lane& ln, int s, float& vpr, float& vpi) {
  const int pa = sc.par[s];
  vpr = pa >= 0 ? ln.at(VR, pa) : 1.0f;
  vpi = pa >= 0 ? ln.at(VI, pa) : 0.0f;
}

// V, I = YV and F at the carried point; returns the inf-norm of F (NaN if
// any entry is NaN) to every thread of the team.
template <int T>
__device__ float eval_point(const Team<T>& tm, const Sched& sc, const Lane& ln) {
  const int S = sc.S;
  for (int s = tm.t; s < S; s += T) {
    const float th = ln.at(TH, s), vm = ln.at(VM, s);
    ln.at(VR, s) = vm * cosf(th);
    ln.at(VI, s) = vm * sinf(th);
  }
  tm.sync();
  float diff = 0.0f;
  bool nan = false;
  for (int s = tm.t; s < S; s += T) {
    const float vr = ln.at(VR, s), vi = ln.at(VI, s);
    float vpr, vpi;
    parent_v(sc, ln, s, vpr, vpi);
    // The children's y_down v, in run order.
    float air = 0.0f, aii = 0.0f;
    for (int c = 0; c < sc.maxC; ++c) {
      const int k = sc.ch[c * S + s];
      if (k < 0) break;
      float cr, ci;
      cmul(sc.y(YC_DOWN_RE, k), sc.y(YC_DOWN_IM, k), ln.at(VR, k), ln.at(VI, k), cr, ci);
      air = air + cr;
      aii = aii + ci;
    }
    float dr, di, ur, ui;
    cmul(sc.y(YC_DIAG_RE, s), sc.y(YC_DIAG_IM, s), vr, vi, dr, di);
    cmul(sc.y(YC_UP_RE, s), sc.y(YC_UP_IM, s), vpr, vpi, ur, ui);
    const float ir = dr + ur + air;
    const float ii = di + ui + aii;
    const float realm = 1.0f - sc.y(YC_PAD, s);
    const float fp = realm * (vr * ir + vi * ii - ln.at(PP, s));
    const float fq = realm * (vi * ir - vr * ii - ln.at(PQ, s));
    ln.at(IR, s) = ir;
    ln.at(II, s) = ii;
    ln.at(FP, s) = fp;
    ln.at(FQ, s) = fq;
    const float a = fabsf(fp), c = fabsf(fq);
    if (isnan(a) || isnan(c)) nan = true;
    diff = fmaxf(diff, fmaxf(a, c));
  }
  const float d = tm.max_nan(diff, nan);
  tm.sync();
  return d;
}

// Full-width block assembly at the evaluated point.
template <int T>
__device__ void assemble(const Team<T>& tm, const Sched& sc, const Lane& ln) {
  for (int s = tm.t; s < sc.S; s += T) {
    const float vr = ln.at(VR, s), vi = ln.at(VI, s);
    float vpr, vpi;
    parent_v(sc, ln, s, vpr, vpi);
    const float ir = ln.at(IR, s), ii = ln.at(II, s);
    const float vmag = sqrtf(vr * vr + vi * vi);
    const float vnr = vr / vmag, vni = vi / vmag;
    const float pmag = sqrtf(vpr * vpr + vpi * vpi);
    const float pnr = vpr / pmag, pni = vpi / pmag;
    const float hp = sc.y(YC_HASPAR, s), pad = sc.y(YC_PAD, s);
    const float ydr = sc.y(YC_DIAG_RE, s), ydi = sc.y(YC_DIAG_IM, s);
    const float yur = sc.y(YC_UP_RE, s), yui = sc.y(YC_UP_IM, s);
    const float ywr = sc.y(YC_DOWN_RE, s), ywi = sc.y(YC_DOWN_IM, s);
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
  }
  tm.sync();
}

// Leaf-to-root elimination: each slot gathers its children's pushes, inverts
// its effective diagonal block and computes its own push to its parent.
template <int T>
__device__ void eliminate(const Team<T>& tm, const Sched& sc, const Lane& ln) {
  const int S = sc.S;
  for (int l = 0; l < sc.n_levels; ++l) {
    const int off = sc.lv[2 * l], end = off + sc.lv[2 * l + 1];
    for (int s = off + tm.t; s < end; s += T) {
      float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f, ab0 = 0.0f, ab1 = 0.0f;
      for (int c = 0; c < sc.maxC; ++c) {
        const int k = sc.ch[c * S + s];
        if (k < 0) break;
        a00 = a00 + ln.at(L00, k);
        a01 = a01 + ln.at(L01, k);
        a10 = a10 + ln.at(L10, k);
        a11 = a11 + ln.at(L11, k);
        ab0 = ab0 + ln.at(IR, k);
        ab1 = ab1 + ln.at(II, k);
      }
      const float d00 = ln.at(D00, s) - a00;
      const float d01 = ln.at(D01, s) - a01;
      const float d10 = ln.at(D10, s) - a10;
      const float d11 = ln.at(D11, s) - a11;
      const float b0 = ln.at(FP, s) - ab0;
      const float b1 = ln.at(FQ, s) - ab1;
      const float det = d00 * d11 - d01 * d10;
      const float i00 = d11 / det, i01 = -d01 / det, i10 = -d10 / det, i11 = d00 / det;
      ln.at(D00, s) = i00;
      ln.at(D01, s) = i01;
      ln.at(D10, s) = i10;
      ln.at(D11, s) = i11;
      ln.at(FP, s) = b0;
      ln.at(FQ, s) = b1;
      if (sc.par[s] < 0) continue;
      // The push to the parent: M = L D^-1, then M U and M b.
      const float l00 = ln.at(L00, s), l01 = ln.at(L01, s), l10 = ln.at(L10, s), l11 = ln.at(L11, s);
      const float m00 = l00 * i00 + l01 * i10;
      const float m01 = l00 * i01 + l01 * i11;
      const float m10 = l10 * i00 + l11 * i10;
      const float m11 = l10 * i01 + l11 * i11;
      const float u00 = ln.at(U00, s), u01 = ln.at(U01, s), u10 = ln.at(U10, s), u11 = ln.at(U11, s);
      ln.at(L00, s) = m00 * u00 + m01 * u10;
      ln.at(L01, s) = m00 * u01 + m01 * u11;
      ln.at(L10, s) = m10 * u00 + m11 * u10;
      ln.at(L11, s) = m10 * u01 + m11 * u11;
      ln.at(IR, s) = m00 * b0 + m01 * b1;
      ln.at(II, s) = m10 * b0 + m11 * b1;
    }
    tm.sync();
  }
}

// Back substitution, root level first (slack parents read 0); the step
// overwrites the effective rhs.
template <int T>
__device__ void back_substitute(const Team<T>& tm, const Sched& sc, const Lane& ln) {
  for (int l = sc.n_levels - 1; l >= 0; --l) {
    const int off = sc.lv[2 * l], end = off + sc.lv[2 * l + 1];
    for (int s = off + tm.t; s < end; s += T) {
      const int pa = sc.par[s];
      const float xp0 = pa >= 0 ? ln.at(FP, pa) : 0.0f;
      const float xp1 = pa >= 0 ? ln.at(FQ, pa) : 0.0f;
      const float r0 = ln.at(FP, s) - (ln.at(U00, s) * xp0 + ln.at(U01, s) * xp1);
      const float r1 = ln.at(FQ, s) - (ln.at(U10, s) * xp0 + ln.at(U11, s) * xp1);
      ln.at(FP, s) = ln.at(D00, s) * r0 + ln.at(D01, s) * r1;
      ln.at(FQ, s) = ln.at(D10, s) * r0 + ln.at(D11, s) * r1;
    }
    tm.sync();
  }
}

// Write the flat start (or, given th and vm, lane b's column of a warm
// point) into the carried point; the caller syncs the team.
template <int T>
__device__ void set_point(const Team<T>& tm, const Lane& ln, const float* th, const float* vm, int B, int b) {
  for (int s = tm.t; s < ln.S; s += T) {
    const size_t g = (size_t)s * B + b;
    ln.at(TH, s) = th != nullptr ? th[g] : 0.0f;
    ln.at(VM, s) = vm != nullptr ? vm[g] : 1.0f;
  }
}

// The whole solve of one lane whose injections the team has written to PP
// and PQ: the flat start or, given a warm point (th_w, vm_w: [S, B], column
// bb), the best of {warm, flat}, then up to max_iter NR steps.  A lane that
// is not `valid` (past the batch) runs along with its warp and never takes
// a step.  On return VR, VI, IR, II hold the last evaluated point for every
// slot; returns its mismatch inf-norm and *it_out the NR steps taken.
template <int T>
__device__ float newton(const Team<T>& tm, const Sched& sc, const Lane& ln, bool valid, const float* th_w,
                        const float* vm_w, int B, int bb, float x_tol, int max_iter, int* it_out) {
  set_point(tm, ln, nullptr, nullptr, B, bb);
  tm.sync();
  float diff = eval_point(tm, sc, ln);
  if (th_w != nullptr) {
    // Best of {warm, flat}: the warm point where its mismatch is finite and
    // smaller than the flat start's.
    set_point(tm, ln, valid ? th_w : nullptr, valid ? vm_w : nullptr, B, bb);
    tm.sync();
    const float diff_w = eval_point(tm, sc, ln);
    const bool use_w = isfinite(diff_w) && diff_w < diff;
    if (__any_sync(kFull, !use_w)) {
      // Back to the flat start where it won; a team that keeps its warm
      // point evaluates it again, bit for bit.
      if (!use_w) set_point(tm, ln, nullptr, nullptr, B, bb);
      tm.sync();
      eval_point(tm, sc, ln);
    }
    if (use_w) diff = diff_w;
  }

  int it = 0;
  for (int k = 0; k < max_iter; ++k) {
    const bool active = valid && diff > x_tol;  // NaN freezes the lane
    if (!__any_sync(kFull, active)) break;
    assemble(tm, sc, ln);
    eliminate(tm, sc, ln);
    back_substitute(tm, sc, ln);
    if (active) {
      for (int s = tm.t; s < sc.S; s += T) {
        ln.at(TH, s) = ln.at(TH, s) - ln.at(FP, s);
        ln.at(VM, s) = ln.at(VM, s) - ln.at(FQ, s);
      }
    }
    tm.sync();
    // A frozen lane evaluates its unchanged point again, bit for bit.
    const float d = eval_point(tm, sc, ln);
    if (active) {
      diff = d;
      ++it;
    }
  }
  *it_out = it;
  return diff;
}

}  // namespace treecore
