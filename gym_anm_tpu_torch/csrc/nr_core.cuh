// Dense polar Newton-Raphson power flow for one env lane, solved by a team of
// threads (float32): the body shared by the dense-NR kernel (nr_dense.cu) and
// the whole-transition kernel (step_fused.cu).
//
// The per-lane form of gym_anm_tpu/ops/pallas_nr.py::nr_core, in the order
// of operations of its plain PyTorch twin
// gym_anm_tpu_torch/ops/nr_cuda.py::nr_core_plain:
//
// * flat start (theta = 0, |V| = 1, the slack pinned at 1 + 0j) or, given
//   a warm point, whichever of {warm, flat} has the smaller mismatch (the
//   warm point only where its mismatch is finite and strictly smaller);
// * an optional chord prefix x <- x - J0inv F(x) with the constant
//   flat-start Jacobian inverse; a lane that ends it worse than it started
//   (or NaN) restarts from the flat start, keeping its iteration count;
// * max_iter true-NR steps: the full [2m, 2m] polar Jacobian at the carried
//   point and current I = YV, Gaussian elimination of [J | F] (pivot-free,
//   or partial pivoting on the first row of largest magnitude, as
//   jnp.argmax picks), back substitution, the step x <- x - dx.
//
// What bounds it on an H100: the elimination, about (2/3) nn^3 dependent
// multiply-subtract updates a lane per NR step at nn = 2(n-1) (87k at
// nn = 64).  Done serially by one thread out of local memory, with one warp
// per SM, it was bound by memory latency at well under 0.1% of the card's
// operation rate.  The team design answers that:
//
// * a lane is solved by a team of T threads inside one warp (T = 8 for
//   nn <= 16, T = 32 for nn <= 64, two template instances), synchronised
//   with __syncwarp and reduced with shuffles on the team's own mask, so
//   teams of one warp may stop at different iterations;
// * the lane's state lives in dynamic shared memory: [J | F] row-major with
//   the odd row stride w = nn + 1 (the threads of a team reading rows
//   r, r + 1, ... at one column hit distinct banks), then V, I, F, dx,
//   theta, |V|, p, q.  With T < 32 a lane's region is a multiple of 32
//   floats plus 8, so the teams of one warp fall on disjoint banks too;
// * Y (and J0inv when a chord prefix runs) is staged once per block in
//   shared memory with an odd row stride;
// * many lanes a block and many blocks an SM keep several warps resident
//   to hide the shared-memory latency.
//
// The work splits so that every sum keeps its order and each result its
// bits: thread t owns the non-slack buses s = t (mod T) (V, I = YV with each
// row's sum sequential over k, F, the Jacobian rows of the bus, the step)
// and the system rows r = t (mod T) (the pivot search, the row update
// A_rc - f A_kc, the back-substitution sums, the chord product).  The
// inf-norm of F is a shuffle max with an explicit NaN flag, so a NaN lane
// stops and is never reported converged; the pivot is a team argmax that
// returns the first NaN, else the first maximal row.  Every thread of a
// team reads the same reduced mismatch, so the loop decisions are uniform
// across the team.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nrcore {

constexpr int kNNMax = 64;  // largest 2(n-1): the 33-bus feeder
constexpr int kBigIndex = 0x7fffffff;

// The two size classes: the largest system and the team size T.
template <int kNN, int kTeam>
struct SizeClass {
  static constexpr int NN = kNN;
  static constexpr int T = kTeam;
  static constexpr int kRows = kNN / kTeam;  // system rows a thread owns
  static constexpr int kLanesMax = 16;  // lanes a block, at most
  static constexpr int kThreadsMax = kLanesMax * kTeam;
  // Kernels declare __launch_bounds__(kThreadsMax, 1): with the minimum of
  // one block an SM, ptxas keeps the team body in registers without spills.
};
using SmallClass = SizeClass<16, 8>;  // ANM6 (nn = 10)
using LargeClass = SizeClass<64, 32>;  // the 33-bus feeder (nn = 64)

struct Tables {
  const float* Yre;    // [n, n]
  const float* Yim;    // [n, n]
  const float* J0inv;  // [2m, 2m]
  int n;
};

// Y and J0inv where the kernel reads them, with their row strides.
struct TableView {
  const float* yre;
  const float* yim;
  const float* j0;
  int ys, js;
};

// Float offsets of a lane's state inside its shared-memory region.  The
// first `scratch` floats hold [J | F]; a caller may overlay other scratch
// there before and after the solve.  `tail` floats follow the NR state.
struct Layout {
  int n, m, nn, w;
  int scratch;
  int p, q, theta, vm, vr, vi, ir, ii, vnr, vni, F, dx, tail;
  int stride;  // floats between consecutive lanes of a block
};

__host__ __device__ inline Layout make_layout(int n, int team, int scratch_min, int tail_floats) {
  Layout L;
  L.n = n;
  L.m = n - 1;
  L.nn = 2 * L.m;
  L.w = L.nn + 1;
  L.scratch = L.nn * L.w > scratch_min ? L.nn * L.w : scratch_min;
  int o = L.scratch;
  L.p = o; o += L.m;
  L.q = o; o += L.m;
  L.theta = o; o += L.m;
  L.vm = o; o += L.m;
  L.vr = o; o += n;
  L.vi = o; o += n;
  L.ir = o; o += n;
  L.ii = o; o += n;
  L.vnr = o; o += n;
  L.vni = o; o += n;
  L.F = o; o += L.nn;
  L.dx = o; o += L.nn;
  L.tail = o; o += tail_floats;
  // Teams sharing a warp start 8 banks apart (mod 32); one team a warp
  // needs no padding.
  L.stride = team < 32 ? ((o + 31) / 32) * 32 + 8 : o;
  return L;
}

// Floats of the per-block table copy.
__host__ __device__ inline int table_floats(int n, bool chord) {
  const int nn = 2 * (n - 1);
  return 2 * n * (n | 1) + (chord ? nn * (nn + 1) : 0);
}

__device__ inline float* dynamic_smem() {
  extern __shared__ float4 nrcore_smem[];
  return reinterpret_cast<float*>(nrcore_smem);
}

// Copy the tables into the block's shared memory (all threads of the block
// take part).
__device__ inline TableView stage_tables(const Tables& t, float* tab, bool chord) {
  const int n = t.n, nn = 2 * (n - 1);
  const int ys = n | 1, js = nn + 1;
  float* yre = tab;
  float* yim = tab + n * ys;
  float* j0 = yim + n * ys;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, k = e - i * n;
    yre[i * ys + k] = __ldg(t.Yre + e);
    yim[i * ys + k] = __ldg(t.Yim + e);
  }
  if (chord) {
    for (int e = threadIdx.x; e < nn * nn; e += blockDim.x) {
      const int i = e / nn, k = e - i * nn;
      j0[i * js + k] = __ldg(t.J0inv + e);
    }
  }
  __syncthreads();
  return TableView{yre, yim, j0, ys, js};
}

// The team of threads that solves one lane: its rank and its warp mask.
template <int T>
struct Team {
  int t;
  unsigned mask;

  __device__ static Team make() {
    const int lane = threadIdx.x & 31;
    const int base = (lane / T) * T;
    return Team{lane - base, T == 32 ? 0xffffffffu : ((1u << T) - 1u) << base};
  }
  __device__ void sync() const { __syncwarp(mask); }
  __device__ float shfl(float v, int src) const { return __shfl_sync(mask, v, src, T); }
  __device__ float xor_(float v, int o) const { return __shfl_xor_sync(mask, v, o, T); }
  __device__ int xor_(int v, int o) const { return __shfl_xor_sync(mask, v, o, T); }

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

// max(a, b) that returns NaN when either is NaN (jnp.maximum).
__device__ inline float nanmax(float a, float b) { return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b); }

// One lane's state: its region of shared memory and the layout.
struct Lane {
  float* s;
  const Layout& L;
  __device__ float& p(int i) const { return s[L.p + i]; }
  __device__ float& q(int i) const { return s[L.q + i]; }
  __device__ float& theta(int i) const { return s[L.theta + i]; }
  __device__ float& vm(int i) const { return s[L.vm + i]; }
  __device__ float& vr(int i) const { return s[L.vr + i]; }
  __device__ float& vi(int i) const { return s[L.vi + i]; }
  __device__ float& ir(int i) const { return s[L.ir + i]; }
  __device__ float& ii(int i) const { return s[L.ii + i]; }
  __device__ float& F(int i) const { return s[L.F + i]; }
  __device__ float& dx(int i) const { return s[L.dx + i]; }
  __device__ float* A() const { return s; }  // [J | F], row stride L.w
};

// I = YV of bus i: the sequential sum over k.
__device__ inline void current(const TableView& tv, const Lane& ln, int i) {
  const int n = ln.L.n;
  const float* yr_row = tv.yre + i * tv.ys;
  const float* yi_row = tv.yim + i * tv.ys;
  float ar = 0.0f, ai = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float yr = yr_row[k], yi = yi_row[k];
    ar = ar + (yr * ln.vr(k) - yi * ln.vi(k));
    ai = ai + (yr * ln.vi(k) + yi * ln.vr(k));
  }
  ln.ir(i) = ar;
  ln.ii(i) = ai;
}

// V and I of the non-slack buses at (theta, vm), then F and its inf-norm
// (NaN if any entry is NaN).  The slack's current is left to finish().
template <int T>
__device__ inline float evaluate(const Team<T>& tm, const TableView& tv, const Lane& ln) {
  const int m = ln.L.m;
  for (int s = tm.t; s < m; s += T) {
    ln.vr(s + 1) = ln.vm(s) * cosf(ln.theta(s));
    ln.vi(s + 1) = ln.vm(s) * sinf(ln.theta(s));
  }
  tm.sync();
  float diff = 0.0f;
  bool nan = false;
  for (int s = tm.t; s < m; s += T) {
    const int i = s + 1;
    current(tv, ln, i);
    const float vr = ln.vr(i), vi = ln.vi(i), ir = ln.ir(i), ii = ln.ii(i);
    const float fp = (vr * ir + vi * ii) - ln.p(s);
    const float fq = (vi * ir - vr * ii) - ln.q(s);
    ln.F(s) = fp;
    ln.F(m + s) = fq;
    const float a = fabsf(fp), c = fabsf(fq);
    if (isnan(a) || isnan(c)) nan = true;
    diff = fmaxf(diff, fmaxf(a, c));
  }
  tm.sync();
  return tm.max_nan(diff, nan);
}

// The flat start: theta = 0, |V| = 1.
template <int T>
__device__ inline float flat_start(const Team<T>& tm, const TableView& tv, const Lane& ln) {
  for (int s = tm.t; s < ln.L.m; s += T) {
    ln.theta(s) = 0.0f;
    ln.vm(s) = 1.0f;
  }
  return evaluate(tm, tv, ln);
}

// x <- x - dx on the team's buses (dx written by the whole team before).
template <int T>
__device__ inline void take_step(const Team<T>& tm, const Lane& ln) {
  const int m = ln.L.m;
  for (int s = tm.t; s < m; s += T) {
    ln.theta(s) = ln.theta(s) - ln.dx(s);
    ln.vm(s) = ln.vm(s) - ln.dx(m + s);
  }
}

// [J | F] at the carried point (V, I): bus i's rows i-1 (real part) and
// m+i-1 (imaginary part), columns k over the non-slack buses;
// J = [[dSa_re, dSm_re], [dSa_im, dSm_im]].
template <int T>
__device__ inline void build_system(const Team<T>& tm, const TableView& tv, const Lane& ln) {
  const Layout& L = ln.L;
  const int n = L.n, m = L.m, nn = L.nn, w = L.w;
  float* vnr = ln.s + L.vnr;
  float* vni = ln.s + L.vni;
  for (int s = tm.t; s < m; s += T) {
    const int k = s + 1;
    const float vmag = sqrtf(ln.vr(k) * ln.vr(k) + ln.vi(k) * ln.vi(k));
    vnr[k] = ln.vr(k) / vmag;
    vni[k] = ln.vi(k) / vmag;
  }
  tm.sync();
  for (int s = tm.t; s < m; s += T) {
    const int i = s + 1;
    const float a = ln.vr(i), b = ln.vi(i);
    const float t1_re = vnr[i] * ln.ir(i) + vni[i] * ln.ii(i);
    const float t1_im = vni[i] * ln.ir(i) - vnr[i] * ln.ii(i);
    float* top = ln.A() + s * w;
    float* bot = ln.A() + (m + s) * w;
    const float* yr_row = tv.yre + i * tv.ys;
    const float* yi_row = tv.yim + i * tv.ys;
    for (int k = 1; k < n; ++k) {
      const float yr = yr_row[k], yi = yi_row[k];
      const bool diag = i == k;
      const float yv_re = yr * ln.vr(k) - yi * ln.vi(k);
      const float yv_im = yr * ln.vi(k) + yi * ln.vr(k);
      const float w_re = (diag ? ln.ir(i) : 0.0f) - yv_re;
      const float w_im = (diag ? ln.ii(i) : 0.0f) - yv_im;
      const float u_re = yr * vnr[k] - yi * vni[k];
      const float u_im = yr * vni[k] + yi * vnr[k];
      top[k - 1] = a * w_im - b * w_re;                                // dSa_re
      bot[k - 1] = a * w_re + b * w_im;                                // dSa_im
      top[m + k - 1] = (diag ? t1_re : 0.0f) + (a * u_re + b * u_im);  // dSm_re
      bot[m + k - 1] = (diag ? t1_im : 0.0f) + (b * u_re - a * u_im);  // dSm_im
    }
    top[nn] = ln.F(s);
    bot[nn] = ln.F(m + s);
  }
  tm.sync();
}

// The team's pivot for column k: the first row r >= k whose |A_rk| is NaN,
// else the first row of largest |A_rk| (torch/jnp.argmax).  Each thread
// scans its own rows in increasing order; the team then keeps the NaN, then
// the larger value, then the lower row.
template <class C>
__device__ inline int pivot_row(const Team<C::T>& tm, const float* A, int w, int nn, int k) {
  int best = kBigIndex;
  float bv = -1.0f;
  int bnan = 0;
#pragma unroll
  for (int j = 0; j < C::kRows; ++j) {
    const int r = tm.t + j * C::T;
    if (r >= k && r < nn && !bnan) {
      const float v = fabsf(A[r * w + k]);
      if (isnan(v)) {
        bnan = 1;
        best = r;
      } else if (v > bv) {
        bv = v;
        best = r;
      }
    }
  }
  for (int o = C::T / 2; o > 0; o >>= 1) {
    const float ov = tm.xor_(bv, o);
    const int oi = tm.xor_(best, o), onan = tm.xor_(bnan, o);
    const bool take = onan != bnan ? onan > bnan : (bnan ? oi < best : (ov > bv || (ov == bv && oi < best)));
    if (take) {
      bv = ov;
      best = oi;
      bnan = onan;
    }
  }
  return best;
}

// Solve [J | F] in place; the step goes to dx.  Row r belongs to thread
// r mod T.  Back substitution carries each row's sum sum_{j>r} A_rj x_j in
// a register of the row's owner, accumulated as the x_j become known
// (j descending); the owner of row k hands its sum to the team with a
// shuffle, and every thread forms x_k from it.
template <class C>
__device__ inline void solve_system(const Team<C::T>& tm, const Lane& ln, bool pivot) {
  constexpr int T = C::T;
  const int nn = ln.L.nn, w = ln.L.w;
  float* A = ln.A();
  for (int k = 0; k < nn; ++k) {
    if (pivot) {
      const int piv = pivot_row<C>(tm, A, w, nn, k);
      if (piv != k) {  // the same for the whole team
        tm.sync();
        for (int c = tm.t; c < w; c += T) {
          const float tmp = A[k * w + c];
          A[k * w + c] = A[piv * w + c];
          A[piv * w + c] = tmp;
        }
        tm.sync();
      }
    }
    const float pv = A[k * w + k];
    float f[C::kRows];
    bool act[C::kRows];
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) {
      const int r = tm.t + j * T;
      act[j] = r > k && r < nn;
      f[j] = act[j] ? A[r * w + k] / pv : 0.0f;
    }
    for (int c = k + 1; c < w; ++c) {
      const float akc = A[k * w + c];
#pragma unroll
      for (int j = 0; j < C::kRows; ++j) {
        float* arc = A + (tm.t + j * T) * w + c;
        if (act[j]) *arc = *arc - f[j] * akc;
      }
    }
    tm.sync();
  }
  float acc[C::kRows];
#pragma unroll
  for (int j = 0; j < C::kRows; ++j) acc[j] = 0.0f;
  for (int k = nn - 1; k >= 0; --k) {
    const int owner = k % T, jk = k / T;
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) mine = j == jk ? acc[j] : mine;
    const float sum = tm.shfl(mine, owner);
    const float x = (A[k * w + nn] - sum) / A[k * w + k];
    if (tm.t == owner) ln.dx(k) = x;
#pragma unroll
    for (int j = 0; j < C::kRows; ++j) {
      const int r = tm.t + j * T;
      if (r < k) acc[j] = acc[j] + A[r * w + k] * x;
    }
  }
  tm.sync();
}

// dx = J0inv F, each row's sum sequential over j.
template <int T>
__device__ inline void chord_step(const Team<T>& tm, const TableView& tv, const Lane& ln) {
  const int nn = ln.L.nn;
  for (int i = tm.t; i < nn; i += T) {
    const float* row = tv.j0 + i * tv.js;
    float acc = 0.0f;
    for (int j = 0; j < nn; ++j) acc = acc + row[j] * ln.F(j);
    ln.dx(i) = acc;
  }
  tm.sync();
}

// A warm point for one lane: its column b of theta and |V| [m, B] in device
// memory (sanitised by the caller), or th == nullptr for a cold start.  It
// is read where it is used, so it takes no shared memory.
struct WarmPoint {
  const float* th;
  const float* vm;
  int B, b;
};

// The whole solve for one lane with injections ln.p, ln.q (written by the
// threads that own their buses).  On return ln.vr, ln.vi, ln.ir, ln.ii
// describe the last accepted point for every bus, slack included, and are
// visible to the whole team; the return value is its mismatch inf-norm and
// *it_out the chord + NR iterations taken.
template <class C>
__device__ inline float solve(const Team<C::T>& tm, const TableView& tv, const Lane& ln, float x_tol, int max_iter,
                              int chord_iters, bool pivot, int* it_out,
                              WarmPoint warm = WarmPoint{nullptr, nullptr, 0, 0}) {
  if (tm.t == 0) {
    ln.vr(0) = 1.0f;
    ln.vi(0) = 0.0f;
  }
  float diff = flat_start(tm, tv, ln);
  if (warm.th != nullptr) {
    // Best of {warm, flat}: the warm point where its mismatch is finite and
    // smaller than the flat start's (a tie keeps the flat start).  The flat
    // start's state is not kept; where it wins it is evaluated again, bit
    // for bit.  diff is the team's reduction, so the choice is the team's.
    for (int s = tm.t; s < ln.L.m; s += C::T) {
      ln.theta(s) = warm.th[(size_t)s * warm.B + warm.b];
      ln.vm(s) = warm.vm[(size_t)s * warm.B + warm.b];
    }
    const float diff_w = evaluate(tm, tv, ln);
    if (isfinite(diff_w) && diff_w < diff) {
      diff = diff_w;
    } else {
      flat_start(tm, tv, ln);
    }
  }
  int it = 0;
  if (chord_iters > 0) {
    const float diff0 = diff;
    for (int c = 0; c < chord_iters && diff > x_tol; ++c) {  // NaN stops the lane
      chord_step(tm, tv, ln);
      take_step(tm, ln);
      diff = evaluate(tm, tv, ln);
      ++it;
    }
    if (!isfinite(diff) || diff > diff0) diff = flat_start(tm, tv, ln);  // worsened: restart
  }
  for (int k = 0; k < max_iter && diff > x_tol; ++k) {
    build_system(tm, tv, ln);
    solve_system<C>(tm, ln, pivot);
    take_step(tm, ln);
    diff = evaluate(tm, tv, ln);
    ++it;
  }
  if (tm.t == 0) current(tv, ln, 0);  // the slack's current, at the final V
  tm.sync();
  *it_out = it;
  return diff;
}

// ---------------------------------------------------------------------------
// Host side: launch geometry.

// The launch geometry of one team kernel: threads a lane, lanes a block,
// threads a block, dynamic shared bytes a block and, when asked, the blocks
// the runtime keeps resident on one SM.
struct Geometry {
  int team, lanes, threads, smem, blocks_per_sm;
};

// Devices whose opt-in is remembered; a larger ordinal opts in at every
// call.
constexpr int kMaxDevices = 64;

// The current device, or -1 if the runtime cannot say.
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// The most dynamic shared memory one block may opt in to on the current
// device (0 if the runtime cannot say).
inline int smem_optin_bytes() {
  const int dev = current_device();
  int bytes = 0;
  if (dev >= 0) cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// Lanes a block and bytes for a lane region of `lane_floats` and tables of
// `tab_floats`: as many lanes as the shared memory of one block holds, up
// to C::kLanesMax.  Returns false if not even one lane fits.
template <class C>
inline bool plan(int lane_floats, int tab_floats, Geometry* g) {
  const int avail = smem_optin_bytes() - 4 * tab_floats;
  int lanes = avail / (4 * lane_floats);
  if (lanes > C::kLanesMax) lanes = C::kLanesMax;
  if (lanes < 1) return false;
  g->team = C::T;
  g->lanes = lanes;
  g->threads = lanes * C::T;
  g->smem = 4 * (tab_floats + lanes * lane_floats);
  g->blocks_per_sm = 0;
  return true;
}

// Allow kernel K the dynamic shared memory of `g` on the current device
// (needed above 48 KB; the opt-in is made once a device for each larger
// size) and, with `occupancy`, read the blocks one SM keeps resident.
template <auto K>
inline cudaError_t prepare(Geometry* g, bool occupancy) {
  static int allowed[kMaxDevices] = {};
  const int dev = current_device();
  cudaError_t err = cudaSuccess;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (g->smem > 48 * 1024 && !(known && g->smem <= allowed[dev])) {
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
    if (err != cudaSuccess) return err;
    if (known) allowed[dev] = g->smem;
  }
  if (occupancy) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g->blocks_per_sm, K, g->threads, g->smem);
  return err;
}

template <typename... KArgs, typename... Args>
inline cudaError_t launch(void (*kernel)(KArgs...), const Geometry& g, int B, cudaStream_t stream, Args... args) {
  const int blocks = (B + g.lanes - 1) / g.lanes;
  kernel<<<blocks, g.threads, g.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace nrcore
