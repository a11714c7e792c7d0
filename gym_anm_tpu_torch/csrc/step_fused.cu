// The whole physics transition, one thread per env lane (float32).
//
// Replaces the TPU kernel gym_anm_tpu/ops/pallas_step.py::_step_tile_kernel
// (with its projection helper _project_lanes_in_kernel).  Per lane, in the
// order of operations of its plain PyTorch twin
// gym_anm_tpu_torch/ops/step_cuda.py::fused_transition_plain:
//
//  1. loads: clip to [p_min, p_max], Q = P * qp;
//  2. generator potentials clipped; storage SoC-rate caps on (dis)charging;
//  3. exact projection of each generator's and storage unit's set-point onto
//     its capability polytope {G x <= h}: the point, then the feet of the
//     perpendiculars (row r), then the vertices (rows r < s), as listed in
//     the static candidate table, with a running minimum of the squared
//     distance (strict <, so ties resolve as on the TPU) and eps = 1e-5;
//  4. the SoC update;
//  5. device assembly (slack 0) and bus aggregation through the device->bus
//     CSR table, summing each bus's devices in device order;
//  6. the dense NR solve (nrcore::solve, nr_core.cuh);
//  7. slack recovery (a NaN slack power becomes +inf);
//  8. branch currents, flows and the signed apparent power s_max;
//  9. e_loss and the constraint penalty.
//
// Layout: the lane inputs arrive packed batch-last, [K_in, B] (soc, P_load,
// P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des); the outputs leave
// packed, [K_out, B], in FusedStepOutputs order plus the NR iteration count.
// The grid tables are small device arrays read by every thread.
//
// What bounds it on an H100: the NR solve inside it (see nr_dense.cu): one
// thread does a lane's elimination out of a per-thread local array, so
// local-memory traffic sets the pace; the other stages are a few hundred
// operations a lane.  32 threads a block: at B = 4096, 128 one-warp blocks
// on 132 SMs.  What the simple design leaves on the table: the NR state in
// registers or shared memory, several threads on one lane's solve, and the
// grid tables in shared memory.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "nr_core.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kDevMax = 64;   // devices, slack included
constexpr int kRowsMax = 16;  // halfspace rows of a capability polytope
constexpr int kGenMax = 16;   // non-slack generators
constexpr float kEps = 1e-5f;

// Float tables, int tables and sizes, in the order of the host arrays
// (gym_anm_tpu_torch/ops/step_cuda.py: FLOAT_TABLES, INT_TABLES, DIMS).
enum FTab { F_YRE, F_YIM, F_J0INV, F_GX, F_GY, F_H0, F_LOADC, F_GENC, F_DESC, F_BUSV, F_ELOSS, F_RATE, F_BRCOEF,
            N_FTAB };
enum ITab { I_LOAD_POS, I_GEN_POS, I_DES_POS, I_BUS_PTR, I_BUS_DEV, I_BR_FT, I_RER, I_CAND, N_ITAB };
enum Dim { D_N, D_D, D_L, D_NLOAD, D_NGEN, D_NDES, D_NRER, D_SLACK, D_ROWS, D_CAP_ROW, D_FLOOR_ROW, D_NCAND, N_DIM };

struct Step {
  const float* f[N_FTAB];
  const int* i[N_ITAB];
  int dim[N_DIM];
  float delta_t, dt_lamb;
};

using nrcore::nanmax;

__device__ inline float clip(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }

__device__ inline float sgn(float x) { return isnan(x) ? x : (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f)); }

// One device's polytope rows for this lane.
struct Poly {
  const float* gx;  // [R] normals
  const float* gy;
  float h[kRowsMax], tol[kRowsMax];
  bool hfin[kRowsMax];
  int R;

  __device__ bool feasible(float x, float y) const {
    bool ok = true;
    for (int r = 0; r < R; ++r) {
      const bool active = isfinite(gx[r]) && isfinite(gy[r]) && hfin[r];
      if (active && !(gx[r] * x + gy[r] * y <= h[r] + tol[r])) ok = false;
    }
    return ok;
  }
};

// Exact projection of (px, py) onto {G x <= h}.
__device__ void project(const Step& T, const Poly& P, float px, float py, float* x_out, float* y_out) {
  float bx = px, by = py;
  float bd = P.feasible(px, py) ? 0.0f : INFINITY;
  const int* cand = T.i[I_CAND];
  for (int k = 0; k < T.dim[D_NCAND]; ++k) {
    const int r = cand[2 * k], s = cand[2 * k + 1];
    const float gxr = P.gx[r], gyr = P.gy[r];
    const bool gfin_r = isfinite(gxr) && isfinite(gyr);
    float x, y;
    bool valid;
    if (s < 0) {  // foot of the perpendicular onto row r
      const float gg = gxr * gxr + gyr * gyr;
      const float gg_safe = gg > 0.0f ? gg : 1.0f;
      const float coef = ((gxr * px + gyr * py) - P.h[r]) / gg_safe;
      x = px - coef * gxr;
      y = py - coef * gyr;
      valid = (fabsf(gxr) + fabsf(gyr) > 0.0f) && gfin_r && P.hfin[r];
    } else {  // vertex of rows r and s
      const float gxs = P.gx[s], gys = P.gy[s];
      const float det = gxr * gys - gyr * gxs;
      const float nrm2 = (gxr * gxr + gyr * gyr) * (gxs * gxs + gys * gys);
      const float nrm = sqrtf(nanmax(nrm2, 0.0f));
      const bool det_ok = isfinite(det) && (fabsf(det) > kEps * nanmax(1.0f, nrm));
      const float safe_det = det_ok ? det : 1.0f;
      x = (P.h[r] * gys - P.h[s] * gyr) / safe_det;
      y = (gxr * P.h[s] - gxs * P.h[r]) / safe_det;
      valid = det_ok && P.hfin[r] && P.hfin[s];
    }
    const float dx = x - px, dy = y - py;
    const float d = dx * dx + dy * dy;
    if (valid && isfinite(x) && isfinite(y) && P.feasible(x, y) && d < bd) {
      bx = x;
      by = y;
      bd = d;
    }
  }
  *x_out = bx;
  *y_out = by;
}

__global__ void __launch_bounds__(kThreads)
step_fused_kernel(Step T, const float* __restrict__ in, float* __restrict__ out, int B, float x_tol, int max_iter,
                  int chord_iters, int pivot) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = T.dim[D_N], d = T.dim[D_D], L = T.dim[D_L];
  const int n_load = T.dim[D_NLOAD], n_gen = T.dim[D_NGEN], n_des = T.dim[D_NDES], R = T.dim[D_ROWS];
  const float dt = T.delta_t;
  // Input and output row offsets.
  const int in_pload = n_des, in_ppot = in_pload + n_load, in_psg = in_ppot + n_gen, in_qsg = in_psg + n_gen;
  const int in_psd = in_qsg + n_gen, in_qsd = in_psd + n_des;
  const int o_devq = d, o_soc = 2 * d, o_ppot = o_soc + n_des, o_vre = o_ppot + n_gen, o_vim = o_vre + n;
  const int o_ire = o_vim + n, o_iim = o_ire + n, o_busp = o_iim + n, o_busq = o_busp + n, o_br = o_busq + n;
  const int o_eloss = o_br + 9 * L;
  auto IN = [&](int row) { return in[(size_t)row * B + b]; };
  auto OUT = [&](int row, float v) { out[(size_t)row * B + b] = v; };

  const float zero = IN(0) * 0.0f;
  float dev_p[kDevMax], dev_q[kDevMax];
  for (int k = 0; k < d; ++k) dev_p[k] = dev_q[k] = zero;

  // 1. Loads.
  const float* loadc = T.f[F_LOADC];
  for (int i = 0; i < n_load; ++i) {
    const float lp = clip(IN(in_pload + i), loadc[3 * i], loadc[3 * i + 1]);
    const int pos = T.i[I_LOAD_POS][i];
    dev_p[pos] = lp;
    dev_q[pos] = lp * loadc[3 * i + 2];
  }
  // 2. Generator potentials.
  float p_pot[kGenMax];
  for (int i = 0; i < n_gen; ++i) {
    p_pot[i] = clip(IN(in_ppot + i), T.f[F_GENC][2 * i], T.f[F_GENC][2 * i + 1]);
    OUT(o_ppot + i, p_pot[i]);
  }
  // 3-4. Projection of every controllable device, then the SoC update.
  const float* desc = T.f[F_DESC];
  const int cap_row = T.dim[D_CAP_ROW], floor_row = T.dim[D_FLOOR_ROW];
  for (int c = 0; c < n_gen + n_des; ++c) {
    const bool gen = c < n_gen;
    const int j = gen ? c : c - n_gen;
    float soc = 0.0f, eff = 1.0f, dcap = 0.0f, ccap = 0.0f;
    if (!gen) {
      soc = IN(j);
      eff = desc[3 * j + 2];
      dcap = eff * (soc - desc[3 * j]) / dt;
      ccap = -(soc - desc[3 * j + 1]) / (dt * eff);
    }
    Poly P;
    P.gx = T.f[F_GX] + c * R;
    P.gy = T.f[F_GY] + c * R;
    P.R = R;
    for (int r = 0; r < R; ++r) {
      float h = T.f[F_H0][c * R + r];
      if (r == cap_row) h = gen ? p_pot[j] : dcap;
      else if (r == floor_row && !gen) h = ccap;
      P.h[r] = h;
      P.hfin[r] = isfinite(h);
      P.tol[r] = kEps * (1.0f + (P.hfin[r] ? fabsf(h) : 0.0f));
    }
    float x, y;
    project(T, P, IN(gen ? in_psg + j : in_psd + j), IN(gen ? in_qsg + j : in_qsd + j), &x, &y);
    const int pos = (gen ? T.i[I_GEN_POS] : T.i[I_DES_POS])[j];
    dev_p[pos] = x;
    dev_q[pos] = y;
    if (!gen) {
      const float s = x <= 0.0f ? soc - (dt * eff) * x : soc - (dt * x) / eff;
      OUT(o_soc + j, clip(s, desc[3 * j], desc[3 * j + 1]));
    }
  }
  // 5. Bus aggregation of the non-slack buses (the slack bus takes the
  // recovered slack power below).
  nrcore::Lane ln;
  const int* bus_ptr = T.i[I_BUS_PTR];
  const int* bus_dev = T.i[I_BUS_DEV];
  for (int bb = 1; bb < n; ++bb) {
    float ap = zero, aq = zero;
    for (int k = bus_ptr[bb]; k < bus_ptr[bb + 1]; ++k) {
      ap = k == bus_ptr[bb] ? dev_p[bus_dev[k]] : ap + dev_p[bus_dev[k]];
      aq = k == bus_ptr[bb] ? dev_q[bus_dev[k]] : aq + dev_q[bus_dev[k]];
    }
    ln.p[bb - 1] = ap;
    ln.q[bb - 1] = aq;
    OUT(o_busp + bb, ap);
    OUT(o_busq + bb, aq);
  }
  // 6. Power flow.
  const nrcore::Tables nt{T.f[F_YRE], T.f[F_YIM], T.f[F_J0INV], n};
  float diff;
  int it;
  nrcore::solve(nt, ln, x_tol, max_iter, chord_iters, pivot != 0, &diff, &it);
  // 7. Slack recovery.
  const float p0 = isnan(ln.ir[0]) ? INFINITY : ln.ir[0];
  const float q0 = isnan(ln.ii[0]) ? INFINITY : -ln.ii[0];
  const int slack = T.dim[D_SLACK];
  dev_p[slack] = p0;
  dev_q[slack] = q0;
  OUT(o_busp, p0);
  OUT(o_busq, q0);
  for (int k = 0; k < d; ++k) {
    OUT(k, dev_p[k]);
    OUT(o_devq + k, dev_q[k]);
  }
  for (int bb = 0; bb < n; ++bb) {
    OUT(o_vre + bb, ln.vr[bb]);
    OUT(o_vim + bb, ln.vi[bb]);
    OUT(o_ire + bb, ln.ir[bb]);
    OUT(o_iim + bb, ln.ii[bb]);
  }
  // 8. Branch currents and flows.
  float br_pen = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int f = T.i[I_BR_FT][2 * l], t = T.i[I_BR_FT][2 * l + 1];
    const float* cf = T.f[F_BRCOEF] + 8 * l;  // aff, aft, atf, att as (re, im)
    const float vfr = ln.vr[f], vfi = ln.vi[f], vtr = ln.vr[t], vti = ln.vi[t];
    const float if_re = cf[0] * vfr - cf[1] * vfi + cf[2] * vtr - cf[3] * vti;
    const float if_im = cf[0] * vfi + cf[1] * vfr + cf[2] * vti + cf[3] * vtr;
    const float it_re = cf[6] * vtr - cf[7] * vti + cf[4] * vfr - cf[5] * vfi;
    const float it_im = cf[6] * vti + cf[7] * vtr + cf[4] * vfi + cf[5] * vfr;
    const float p_f = vfr * if_re + vfi * if_im;
    const float q_f = vfi * if_re - vfr * if_im;
    const float p_t = vtr * it_re + vti * it_im;
    const float q_t = vti * it_re - vtr * it_im;
    const float s_f = sqrtf(p_f * p_f + q_f * q_f);
    const float s_t = sqrtf(p_t * p_t + q_t * q_t);
    const float s_m = sgn(p_f) * nanmax(s_f, s_t);
    const float vals[9] = {if_re, if_im, it_re, it_im, p_f, q_f, p_t, q_t, s_m};
    for (int k = 0; k < 9; ++k) OUT(o_br + k * L + l, vals[k]);
    br_pen = br_pen + nanmax(0.0f, fabsf(s_m) - T.f[F_RATE][l]);
  }
  // 9. Reward terms.
  float e_loss = 0.0f;
  for (int k = 0; k < d; ++k) e_loss = e_loss + T.f[F_ELOSS][k] * dev_p[k];
  for (int r = 0; r < T.dim[D_NRER]; ++r) {
    const int gi = T.i[I_RER][2 * r], dpos = T.i[I_RER][2 * r + 1];
    e_loss = e_loss + nanmax(0.0f, p_pot[gi] - dev_p[dpos]);
  }
  e_loss = e_loss * dt;
  float v_pen = 0.0f;
  const float* busv = T.f[F_BUSV];
  for (int bb = 0; bb < n; ++bb) {
    const float vm = sqrtf(ln.vr[bb] * ln.vr[bb] + ln.vi[bb] * ln.vi[bb]);
    v_pen = v_pen + (nanmax(0.0f, vm - busv[2 * bb + 1]) + nanmax(0.0f, busv[2 * bb] - vm));
  }
  OUT(o_eloss, e_loss);
  OUT(o_eloss + 1, (v_pen + br_pen) * T.dt_lamb);
  OUT(o_eloss + 2, diff);
  OUT(o_eloss + 3, (float)it);
}

}  // namespace

extern "C" int step_fused_sizes(int* n_ftab, int* n_itab, int* n_dim) {
  *n_ftab = N_FTAB;
  *n_itab = N_ITAB;
  *n_dim = N_DIM;
  return 0;
}

// ftab: host array of N_FTAB device pointers (float tables); itab: host array
// of N_ITAB device pointers (int32 tables); dims: host array of N_DIM ints.
// lanes_in: [K_in, B]; lanes_out: [K_out, B].  `stream` is a cudaStream_t.
extern "C" int step_fused_f32(const void* const* ftab, const void* const* itab, const int* dims, float delta_t,
                              float dt_lamb, const float* lanes_in, float* lanes_out, int B, float x_tol,
                              int max_iter, int chord_iters, int pivot, void* stream) {
  Step T;
  for (int k = 0; k < N_FTAB; ++k) T.f[k] = static_cast<const float*>(ftab[k]);
  for (int k = 0; k < N_ITAB; ++k) T.i[k] = static_cast<const int*>(itab[k]);
  for (int k = 0; k < N_DIM; ++k) T.dim[k] = dims[k];
  T.delta_t = delta_t;
  T.dt_lamb = dt_lamb;
  const int n = T.dim[D_N];
  if (n < 2 || 2 * (n - 1) > nrcore::kNNMax || T.dim[D_D] > kDevMax || T.dim[D_ROWS] > kRowsMax ||
      T.dim[D_NGEN] > kGenMax || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kThreads - 1) / kThreads;
  step_fused_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(T, lanes_in, lanes_out, B, x_tol,
                                                                                 max_iter, chord_iters, pivot);
  return static_cast<int>(cudaGetLastError());
}
