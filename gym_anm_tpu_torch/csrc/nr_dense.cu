// Dense batched Newton-Raphson power flow, one team of threads per env lane
// (float32).
//
// Replaces the TPU kernel gym_anm_tpu/ops/pallas_nr.py::_nr_tile_kernel, cold
// and warm.  Each team runs nrcore::solve (nr_core.cuh) for its lane: the
// flat start (or, given a warm point, the better of {warm, flat}), an
// optional chord prefix, then up to max_iter true-NR steps with a full
// [2m, 2m] Jacobian and Gaussian elimination, pivot-free or with partial
// pivoting.  The warm form is a runtime flag: null th_w/vm_w is a cold
// start.  The warm point is read from device memory where it is used, so
// both forms have one launch geometry.
//
// What bounds it on an H100: the elimination, ~(2/3) nn^3 updates a lane per
// NR step, each a shared-memory load and store; at nn = 64 that is shared-
// memory bandwidth and latency, not device memory (the inputs and outputs
// are a few hundred bytes a lane) and not arithmetic.  The design answers it
// with a team of T threads on each lane's system in shared memory (8 threads
// for nn <= 16, 32 for nn <= 64) and as many lanes a block as one block's
// shared memory holds, up to 16: at nn = 64 that is 11-12 lanes, one warp
// each, against one warp an SM for the per-thread design it replaces.
//
// Layout: p, q, th_w, vm_w [m, B] and v_re, v_im [n, B] are batch-last; the
// threads of a team read and write their own buses' rows at s*B + b.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// the CUDA error of the launch (or of the shared-memory opt-in before it).

#include <cuda_runtime.h>

#include "nr_core.cuh"

namespace {

template <class C>
__global__ void __launch_bounds__(C::kThreadsMax, 1)
nr_dense_kernel(nrcore::Tables t, const float* __restrict__ p, const float* __restrict__ q,
                const float* __restrict__ th_w, const float* __restrict__ vm_w, int B, float x_tol, int max_iter,
                int chord_iters, int pivot, float* __restrict__ v_re, float* __restrict__ v_im,
                float* __restrict__ diff_out, int* __restrict__ n_iter_out) {
  float* smem = nrcore::dynamic_smem();
  const nrcore::TableView tv = nrcore::stage_tables(t, smem, chord_iters > 0);
  const int slot = threadIdx.x / C::T;
  const int b = blockIdx.x * (blockDim.x / C::T) + slot;
  if (b >= B) return;  // a whole team: no thread of it syncs again
  const auto tm = nrcore::Team<C::T>::make();
  const nrcore::Layout L = nrcore::make_layout(t.n, C::T, 0, 0);
  const nrcore::Lane ln{smem + nrcore::table_floats(t.n, chord_iters > 0) + slot * L.stride, L};
  const int n = t.n, m = n - 1;
  for (int s = tm.t; s < m; s += C::T) {
    ln.p(s) = p[(size_t)s * B + b];
    ln.q(s) = q[(size_t)s * B + b];
  }
  int it;
  const float diff =
      nrcore::solve<C>(tm, tv, ln, x_tol, max_iter, chord_iters, pivot != 0, &it, nrcore::WarmPoint{th_w, vm_w, B, b});
  for (int i = tm.t; i < n; i += C::T) {
    v_re[(size_t)i * B + b] = ln.vr(i);
    v_im[(size_t)i * B + b] = ln.vi(i);
  }
  if (tm.t == 0) {
    diff_out[b] = diff;
    n_iter_out[b] = it;
  }
}

template <class C>
cudaError_t geometry(int n, int chord_iters, bool occupancy, nrcore::Geometry* g) {
  const nrcore::Layout L = nrcore::make_layout(n, C::T, 0, 0);
  if (!nrcore::plan<C>(L.stride, nrcore::table_floats(n, chord_iters > 0), g)) return cudaErrorInvalidValue;
  return nrcore::prepare<nr_dense_kernel<C>>(g, occupancy);
}

bool small_system(int n) { return 2 * (n - 1) <= nrcore::SmallClass::NN; }

}  // namespace

// The launch geometry for an n-bus grid: out = [threads a lane, lanes a
// block, threads a block, dynamic shared bytes a block, resident blocks an
// SM].
extern "C" int nr_dense_geometry(int n, int chord_iters, int* out) {
  if (n < 2 || 2 * (n - 1) > nrcore::kNNMax) return static_cast<int>(cudaErrorInvalidValue);
  nrcore::Geometry g;
  const cudaError_t err = small_system(n) ? geometry<nrcore::SmallClass>(n, chord_iters, true, &g)
                                          : geometry<nrcore::LargeClass>(n, chord_iters, true, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {g.team, g.lanes, g.threads, g.smem, g.blocks_per_sm};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
}

// Y_re, Y_im: [n, n]; J0inv: [2m, 2m]; p, q: [m, B]; th_w, vm_w: [m, B] (both
// null: a cold start); v_re, v_im: [n, B]; diff, n_iter: [B].  All device
// pointers; `stream` is a cudaStream_t.
extern "C" int nr_dense_solve_f32(const float* Y_re, const float* Y_im, const float* J0inv, const float* p,
                                  const float* q, const float* th_w, const float* vm_w, int n, int B, float x_tol,
                                  int max_iter, int chord_iters, int pivot, float* v_re, float* v_im, float* diff,
                                  int* n_iter, void* stream) {
  if ((th_w == nullptr) != (vm_w == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 2 || 2 * (n - 1) > nrcore::kNNMax || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const nrcore::Tables t{Y_re, Y_im, J0inv, n};
  const auto s = static_cast<cudaStream_t>(stream);
  nrcore::Geometry g;
  cudaError_t err;
  if (small_system(n)) {
    err = geometry<nrcore::SmallClass>(n, chord_iters, false, &g);
    if (err == cudaSuccess)
      err = nrcore::launch(nr_dense_kernel<nrcore::SmallClass>, g, B, s, t, p, q, th_w, vm_w, B, x_tol, max_iter,
                           chord_iters, pivot, v_re, v_im, diff, n_iter);
  } else {
    err = geometry<nrcore::LargeClass>(n, chord_iters, false, &g);
    if (err == cudaSuccess)
      err = nrcore::launch(nr_dense_kernel<nrcore::LargeClass>, g, B, s, t, p, q, th_w, vm_w, B, x_tol, max_iter,
                           chord_iters, pivot, v_re, v_im, diff, n_iter);
  }
  return static_cast<int>(err);
}
