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
// This design: a team of threads a lane, the lane's state in shared memory
// and the schedule staged once a block (tree_core.cuh, whose solve this
// kernel and the whole-transition kernel's tree form share); all teams of a
// warp run the warp's loop until its last lane is done (the TPU kernel's
// whole-tile early exit); each lane's first thread adds the lane's
// iterations, and whether it ended at the budget unconverged, to the
// process's device counters, so a replayed CUDA graph counts too.
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
#include "tree_core.cuh"

namespace {

using namespace treecore;

struct Args {
  const float* p;      // [S, B]
  const float* q;      // [S, B]
  const float* th_w;   // [S, B] warm point, or null for a cold start
  const float* vm_w;   // [S, B]
  Tables sched;
  int B, max_iter;
  float x_tol;
  float* v_re;         // [S, B]
  float* v_im;         // [S, B]
  float* diff;         // [B]
  int* n_iter;         // [B]
  unsigned long long* counts;  // [2] the process's counters
};

template <class C>
__global__ void __launch_bounds__(C::kThreadsMax)
tree_nr_kernel(Args a) {
  constexpr int T = C::T;
  float* smem = nrcore::dynamic_smem();
  const int S = a.sched.S;
  const Sched sc = stage_schedule(a.sched, smem);

  const int slot = threadIdx.x / T;
  const int b = blockIdx.x * (blockDim.x / T) + slot;
  const bool valid = b < a.B;
  if (!__any_sync(kFull, valid)) return;  // a whole warp past the batch
  const Team<T> tm{(int)(threadIdx.x % T)};
  const Lane ln{smem + table_words(S, sc.maxC, sc.n_levels) + slot * lane_floats(S, T), S};
  // Lanes past the batch run with zero injections from the flat start and
  // never count as active.
  const int bb = valid ? b : 0;
  for (int s = tm.t; s < S; s += T) {
    ln.at(PP, s) = valid ? a.p[(size_t)s * a.B + bb] : 0.0f;
    ln.at(PQ, s) = valid ? a.q[(size_t)s * a.B + bb] : 0.0f;
  }
  int it;
  const float diff = newton(tm, sc, ln, valid, a.th_w, a.vm_w, a.B, bb, a.x_tol, a.max_iter, &it);
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
  const Args a{p, q, th_w, vm_w, Tables{ycols, par, children, levels, S, maxC, n_levels}, B, max_iter, x_tol,
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
