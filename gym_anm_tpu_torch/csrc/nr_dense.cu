// Dense batched Newton-Raphson power flow, one thread per env lane (float32).
//
// Replaces the TPU kernel gym_anm_tpu/ops/pallas_nr.py::_nr_tile_kernel (its
// cold-start form; the warm-start variant is not ported).  Each thread runs
// nrcore::solve (nr_core.cuh) for its lane: flat start, an optional chord
// prefix, then up to max_iter true-NR steps with a full [2m, 2m] Jacobian and
// Gaussian elimination, pivot-free or with partial pivoting.
//
// Layout: p, q [m, B] and v_re, v_im [n, B] are batch-last, so thread b reads
// and writes s*B + b and neighbouring threads touch neighbouring addresses.
// Y and J0inv are read from device memory by every thread (the same address
// across a warp).
//
// What bounds it on an H100: the elimination, about (2/3) nn^3 operations a
// lane per NR step at nn = 2(n-1), done serially by one thread out of a
// per-thread local array (4.2K floats at nn = 64): local-memory traffic
// through L1/L2, not arithmetic, sets the pace.  With 32 threads a block,
// B = 4096 makes 128 one-warp blocks, about one per SM, so each warp has its
// SM's L1 to itself.  What the simple design leaves on the table: the
// system in registers or shared memory, several threads cooperating on one
// lane's elimination at nn = 64, and occupancy beyond one warp per SM.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "nr_core.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
nr_dense_kernel(nrcore::Tables t, const float* __restrict__ p, const float* __restrict__ q, int B, float x_tol,
                int max_iter, int chord_iters, int pivot, float* __restrict__ v_re, float* __restrict__ v_im,
                float* __restrict__ diff_out, int* __restrict__ n_iter_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = t.n, m = n - 1;
  nrcore::Lane ln;
  for (int i = 0; i < m; ++i) {
    ln.p[i] = p[(size_t)i * B + b];
    ln.q[i] = q[(size_t)i * B + b];
  }
  float diff;
  int it;
  nrcore::solve(t, ln, x_tol, max_iter, chord_iters, pivot != 0, &diff, &it);
  for (int i = 0; i < n; ++i) {
    v_re[(size_t)i * B + b] = ln.vr[i];
    v_im[(size_t)i * B + b] = ln.vi[i];
  }
  diff_out[b] = diff;
  n_iter_out[b] = it;
}

}  // namespace

// Y_re, Y_im: [n, n]; J0inv: [2m, 2m]; p, q: [m, B]; v_re, v_im: [n, B];
// diff, n_iter: [B].  All device pointers; `stream` is a cudaStream_t.
extern "C" int nr_dense_solve_f32(const float* Y_re, const float* Y_im, const float* J0inv, const float* p,
                                  const float* q, int n, int B, float x_tol, int max_iter, int chord_iters,
                                  int pivot, float* v_re, float* v_im, float* diff, int* n_iter, void* stream) {
  if (n < 2 || 2 * (n - 1) > nrcore::kNNMax || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const nrcore::Tables t{Y_re, Y_im, J0inv, n};
  const int blocks = (B + kThreads - 1) / kThreads;
  nr_dense_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, p, q, B, x_tol, max_iter, chord_iters, pivot, v_re, v_im, diff, n_iter);
  return static_cast<int>(cudaGetLastError());
}
