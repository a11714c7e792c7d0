// Tree-structured Newton-Raphson power flow for radial grids, one team of
// threads per env lane (float32).
//
// Replaces the TPU kernel gym_anm_tpu/ops/pallas_tree.py::_tree_tile_kernel,
// cold and warm.  It computes the same thing per lane: the exact polar NR
// power flow of a radial grid from a flat start (theta = 0, |V| = 1, slack
// pinned at 1+0j) or, given a warm point, from whichever of {warm, flat} has
// the smaller finite mismatch.  Each iteration evaluates V, I = YV over the
// tree edges and the mismatch F = V conj(I) - S; a lane whose inf-norm is
// above x_tol builds the 2x2 polar Jacobian blocks D/L/U, eliminates leaf to
// root (effective diagonal, adjugate inverse, Schur complement M U and M b
// with M = L D^-1), back-substitutes root first and takes the step.  A lane
// whose mismatch is not above x_tol (NaN included) stops: the TPU kernel's
// masked update and early exit, with the same iteration counts.  It is the
// order of operations of the plain twin
// gym_anm_tpu_torch/ops/tree_cuda.py::solve_pfe_tree_plain, bit for bit
// under --fmad=false.
//
// What bounded the one-thread-per-lane design it replaces: every per-lane
// value lived in a [32, S, B] float32 scratch buffer in device memory (73 MB
// at S = 140 and B = 4096, more than the 50 MB L2), read and written several
// times a step, and 128 threads a block gave 32 blocks for 132 SMs.
//
// This design:
//
// * a lane is solved by a team of T threads (T = 8 for S <= 16, T = 32
//   above; two template instances).  The S-wide stages (evaluation, block
//   assembly, update) split the slots s = t (mod T); the elimination and the
//   back substitution split each level's W slots the same way, with a team
//   barrier between levels;
// * the lane's state lives in dynamic shared memory, 22 planes of S floats
//   (the point, the injections, V, I, F, D, L, U), reused as the step goes:
//   after a slot is eliminated D holds its inverse, F its effective rhs and
//   then its step, L its Schur push M U and I its push M b;
// * the schedule (the admittance columns, each slot's parent and children,
//   the levels) is staged once per block in shared memory;
// * sums keep the plain twin's order: a parent gathers its children's
//   contributions (y_down v in the evaluation, M U and M b in the
//   elimination) in the order of the runs, which is the order the plain
//   twin pushes them in;
// * all teams of a warp run the warp's loop until its last lane is done,
//   frozen lanes updating nothing (the TPU kernel's whole-tile early exit),
//   so every barrier and vote is warp-uniform;
// * the mismatch norm is a team max with an explicit NaN flag (fmaxf drops
//   NaN), so a NaN lane freezes and is never reported converged;
// * each lane's first thread adds the lane's iterations, and whether it
//   ended at the budget unconverged, to the process's device counters, so a
//   replayed CUDA graph counts too.
//
// What bounds it now: not bytes (a lane reads p, q and writes V, 16 S bytes:
// 9.2 MB at S = 140, B = 4096, 3 us at 3.35 TB/s) nor operations
// (tree_nr_flops_per_lane: 39 S an evaluation, 212 S an NR step; 0.27 GFLOP
// for two NR steps at S = 140, B = 4096, 4 us at 67 TFLOP/s) but latency:
// per NR step 2 x (levels) dependent, mostly narrow level stages (19-20 at
// the feeders, 1-20 slots wide) each ending at a barrier, with divides in
// the chain, so the lanes that run the most NR steps set the time.  Shared
// memory (88 S bytes a lane) caps the resident lanes at S = 140 below the 31
// an SM that B = 4096 asks for, so that grid runs in two waves.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// the CUDA error of the launch (or of the shared-memory opt-in before it).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "nr_core.cuh"

namespace {

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

struct Args {
  const float* p;      // [S, B]
  const float* q;      // [S, B]
  const float* th_w;   // [S, B] warm point, or null for a cold start
  const float* vm_w;   // [S, B]
  const float* ycols;  // [S, 8]
  const int* par;      // [S] parent slot, -1 under the slack
  const int* ch;       // [maxC, S] children in run order, -1 padded
  const int* levels;   // [n_levels, 2] (off, W), leaves first
  int S, maxC, n_levels, B, max_iter;
  float x_tol;
  float* v_re;         // [S, B]
  float* v_im;         // [S, B]
  float* diff;         // [B]
  int* n_iter;         // [B]
  unsigned long long* counts;  // [2] the process's counters
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

// Floats between consecutive lanes of a block: teams sharing a warp start 8
// banks apart (mod 32); one team a warp needs no padding.
__host__ __device__ inline int lane_floats(int S, int team) {
  const int f = N_PLANES * S;
  return team < 32 ? ((f + 31) / 32) * 32 + 8 : f;
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
  // max over the team, NaN if any thread saw NaN (fmaxf drops it).
  __device__ float max_nan(float v, bool nan) const {
    int flag = nan ? 1 : 0;
    for (int o = T / 2; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(kFull, v, o, T));
      flag |= __shfl_xor_sync(kFull, flag, o, T);
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

template <class C>
__global__ void __launch_bounds__(C::kThreadsMax)
tree_nr_kernel(Args a) {
  constexpr int T = C::T;
  float* smem = nrcore::dynamic_smem();
  const int S = a.S;

  // The schedule, once per block; ycols transposed to [8, S] so that a
  // team's threads read consecutive words.
  float* yc = smem;
  int* par = reinterpret_cast<int*>(smem + YC_COLS * S);
  int* ch = par + S;
  int* lv = ch + a.maxC * S;
  for (int i = threadIdx.x; i < YC_COLS * S; i += blockDim.x) yc[(i % YC_COLS) * S + i / YC_COLS] = a.ycols[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) par[i] = a.par[i];
  for (int i = threadIdx.x; i < a.maxC * S; i += blockDim.x) ch[i] = a.ch[i];
  for (int i = threadIdx.x; i < 2 * a.n_levels; i += blockDim.x) lv[i] = a.levels[i];
  __syncthreads();
  const Sched sc{yc, par, ch, lv, S, a.maxC, a.n_levels};

  const int slot = threadIdx.x / T;
  const int b = blockIdx.x * (blockDim.x / T) + slot;
  const bool valid = b < a.B;
  if (!__any_sync(kFull, valid)) return;  // a whole warp past the batch
  const Team<T> tm{(int)(threadIdx.x % T)};
  const Lane ln{smem + table_words(S, a.maxC, a.n_levels) + slot * lane_floats(S, T), S};
  // Lanes past the batch run with zero injections from the flat start and
  // never count as active.
  const int bb = valid ? b : 0;
  for (int s = tm.t; s < S; s += T) {
    ln.at(PP, s) = valid ? a.p[(size_t)s * a.B + bb] : 0.0f;
    ln.at(PQ, s) = valid ? a.q[(size_t)s * a.B + bb] : 0.0f;
  }
  set_point(tm, ln, nullptr, nullptr, a.B, bb);
  tm.sync();
  float diff = eval_point(tm, sc, ln);
  if (a.th_w != nullptr) {
    // Best of {warm, flat}: the warm point where its mismatch is finite and
    // smaller than the flat start's.
    set_point(tm, ln, valid ? a.th_w : nullptr, valid ? a.vm_w : nullptr, a.B, bb);
    tm.sync();
    const float diff_w = eval_point(tm, sc, ln);
    const bool use_w = isfinite(diff_w) && diff_w < diff;
    if (__any_sync(kFull, !use_w)) {
      // Back to the flat start where it won; a team that keeps its warm
      // point evaluates it again, bit for bit.
      if (!use_w) set_point(tm, ln, nullptr, nullptr, a.B, bb);
      tm.sync();
      eval_point(tm, sc, ln);
    }
    if (use_w) diff = diff_w;
  }

  int it = 0;
  for (int k = 0; k < a.max_iter; ++k) {
    const bool active = valid && diff > a.x_tol;  // NaN freezes the lane
    if (!__any_sync(kFull, active)) break;
    assemble(tm, sc, ln);
    eliminate(tm, sc, ln);
    back_substitute(tm, sc, ln);
    if (active) {
      for (int s = tm.t; s < S; s += T) {
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
  // The process's counters: the lane's NR iterations, and whether it ended
  // at the budget unconverged.
  if (valid && tm.t == 0) {
    atomicAdd(&a.counts[0], (unsigned long long)it);
    if (it == a.max_iter && !(diff <= a.x_tol)) atomicAdd(&a.counts[1], 1ull);
  }
  if (!valid) return;
  for (int s = tm.t; s < S; s += T) {
    a.v_re[(size_t)s * a.B + b] = ln.at(VR, s);
    a.v_im[(size_t)s * a.B + b] = ln.at(VI, s);
  }
  if (tm.t == 0) {
    a.diff[b] = diff;
    a.n_iter[b] = it;
  }
}

template <class C>
cudaError_t geometry(int S, int maxC, int n_levels, bool occupancy, nrcore::Geometry* g) {
  if (!nrcore::plan<C>(lane_floats(S, C::T), table_words(S, maxC, n_levels), g)) return cudaErrorInvalidValue;
  if (g->threads % 32 != 0) return cudaErrorInvalidValue;  // warps are whole: every barrier names all 32 threads
  return nrcore::prepare<tree_nr_kernel<C>>(g, occupancy);
}

bool valid_sizes(int S, int maxC, int n_levels) { return S >= 1 && maxC >= 1 && n_levels >= 1; }

}  // namespace

// The launch geometry for a schedule of S slots, at most maxC children a
// slot and n_levels levels: out = [threads a lane, lanes a block, threads a
// block, dynamic shared bytes a block, resident blocks an SM].
extern "C" int tree_nr_geometry(int S, int maxC, int n_levels, int* out) {
  if (!valid_sizes(S, maxC, n_levels)) return static_cast<int>(cudaErrorInvalidValue);
  nrcore::Geometry g;
  const cudaError_t err = S <= kSmallSlots ? geometry<SmallClass>(S, maxC, n_levels, true, &g)
                                           : geometry<LargeClass>(S, maxC, n_levels, true, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {g.team, g.lanes, g.threads, g.smem, g.blocks_per_sm};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
}

// p, q, th_w, vm_w, v_re, v_im: [S, B] (th_w and vm_w both null for a cold
// start); ycols: [S, 8]; par: [S]; children: [maxC, S]; levels:
// [n_levels, 2]; diff, n_iter: [B]; counts: [2], to which the launch adds
// the lanes' iterations and the lanes that ended at max_iter unconverged.
// All device pointers; `stream` is a cudaStream_t.
extern "C" int tree_nr_solve_f32(const float* p, const float* q, const float* th_w, const float* vm_w,
                                 const float* ycols, const int* par, const int* children, const int* levels,
                                 int S, int maxC, int n_levels, int B, float x_tol, int max_iter, float* v_re,
                                 float* v_im, float* diff, int* n_iter, unsigned long long* counts, void* stream) {
  if (!valid_sizes(S, maxC, n_levels) || B <= 0 || (th_w == nullptr) != (vm_w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{p, q, th_w, vm_w, ycols, par, children, levels, S, maxC, n_levels, B, max_iter, x_tol,
               v_re, v_im, diff, n_iter, counts};
  const auto st = static_cast<cudaStream_t>(stream);
  nrcore::Geometry g;
  cudaError_t err;
  if (S <= kSmallSlots) {
    err = geometry<SmallClass>(S, maxC, n_levels, false, &g);
    if (err == cudaSuccess) err = nrcore::launch(tree_nr_kernel<SmallClass>, g, B, st, a);
  } else {
    err = geometry<LargeClass>(S, maxC, n_levels, false, &g);
    if (err == cudaSuccess) err = nrcore::launch(tree_nr_kernel<LargeClass>, g, B, st, a);
  }
  return static_cast<int>(err);
}
