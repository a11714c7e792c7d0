// The whole physics transition, one team of threads per env lane (float32).
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
//     the static candidate table, keeping the first candidate of least
//     squared distance (the strict < of a sequential running minimum, as on
//     the TPU), with eps = 1e-5;
//  4. the SoC update;
//  5. device assembly (slack 0) and bus aggregation through the device->bus
//     CSR table, summing each bus's devices in device order;
//  6. the dense NR solve (nrcore::solve, nr_core.cuh);
//  7. slack recovery (a NaN slack power becomes +inf);
//  8. branch currents, flows and the signed apparent power s_max;
//  9. e_loss and the constraint penalty.
//
// What bounds it on an H100: the NR solve inside it (see nr_dense.cu and
// nr_core.cuh); outside it, serial per-lane work, the largest part the
// projection (47 candidates for each controllable device, each tested
// against every polytope row).  The design answers both with one team of T
// threads per lane, the team of the NR solve: loads, potentials and the
// polytope rows split by device and row; the projection's (device,
// candidate) pairs split over the team, each thread keeping a running
// minimum over its own candidates in increasing order and the team then
// reducing by (distance, candidate index), which picks what the sequential
// scan picks; bus aggregation one thread per bus, branch flows one thread
// per branch.  The three order-sensitive sums (e_loss, the voltage and the
// branch penalties) stay sequential on one thread.  dev_p, dev_q and the
// potentials live in the lane's shared-memory region; the polytope rows and
// the branch penalties are scratch overlaid on the NR system.
//
// Layout: the lane inputs arrive packed batch-last, [K_in, B] (soc, P_load,
// P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des); the outputs leave
// packed, [K_out, B], in FusedStepOutputs order plus the NR iteration count.
// Y (and J0inv with a chord prefix) is staged in shared memory per block;
// the other grid tables are small device arrays read through the read-only
// cache.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// the CUDA error of the launch (or of the shared-memory opt-in before it).

#include <cuda_runtime.h>
#include <math.h>

#include "nr_core.cuh"

namespace {

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

// The lane's region: the NR layout, then dev_p [d], dev_q [d] and the
// clipped potentials [n_gen]; the scratch in front holds the polytope rows
// (h and tol, [C, R] each) before the solve and the branch penalties [L]
// after it.
__host__ __device__ inline nrcore::Layout step_layout(const int* dim, int team) {
  const int C = dim[D_NGEN] + dim[D_NDES];
  const int poly = 2 * C * dim[D_ROWS];
  const int scratch = poly > dim[D_L] ? poly : dim[D_L];
  return nrcore::make_layout(dim[D_N], team, scratch, 2 * dim[D_D] + dim[D_NGEN]);
}

// One device's polytope for this lane: the normals (a read-only table) and
// this step's right-hand sides and tolerances (the lane's scratch).
struct Poly {
  const float* gx;  // [R]
  const float* gy;
  const float* h;
  const float* tol;
  int R;

  __device__ bool feasible(float x, float y) const {
    bool ok = true;
    for (int r = 0; r < R; ++r) {
      const float gxr = __ldg(gx + r), gyr = __ldg(gy + r);
      const bool active = isfinite(gxr) && isfinite(gyr) && isfinite(h[r]);
      if (active && !(gxr * x + gyr * y <= h[r] + tol[r])) ok = false;
    }
    return ok;
  }
};

// Candidate k of the projection of (px, py): the foot onto row r (s < 0) or
// the vertex of rows r and s.  Returns whether it counts, with its point and
// squared distance.
__device__ inline bool candidate(const Poly& P, int r, int s, float px, float py, float* x_out, float* y_out,
                                 float* d_out) {
  const float gxr = __ldg(P.gx + r), gyr = __ldg(P.gy + r);
  const bool gfin_r = isfinite(gxr) && isfinite(gyr);
  const bool hfin_r = isfinite(P.h[r]);
  float x, y;
  bool valid;
  if (s < 0) {
    const float gg = gxr * gxr + gyr * gyr;
    const float gg_safe = gg > 0.0f ? gg : 1.0f;
    const float coef = ((gxr * px + gyr * py) - P.h[r]) / gg_safe;
    x = px - coef * gxr;
    y = py - coef * gyr;
    valid = (fabsf(gxr) + fabsf(gyr) > 0.0f) && gfin_r && hfin_r;
  } else {
    const float gxs = __ldg(P.gx + s), gys = __ldg(P.gy + s);
    const float det = gxr * gys - gyr * gxs;
    const float nrm2 = (gxr * gxr + gyr * gyr) * (gxs * gxs + gys * gys);
    const float nrm = sqrtf(nanmax(nrm2, 0.0f));
    const bool det_ok = isfinite(det) && (fabsf(det) > kEps * nanmax(1.0f, nrm));
    const float safe_det = det_ok ? det : 1.0f;
    x = (P.h[r] * gys - P.h[s] * gyr) / safe_det;
    y = (gxr * P.h[s] - gxs * P.h[r]) / safe_det;
    valid = det_ok && hfin_r && isfinite(P.h[s]);
  }
  const float dx = x - px, dy = y - py;
  *x_out = x;
  *y_out = y;
  *d_out = dx * dx + dy * dy;
  return valid && isfinite(x) && isfinite(y) && P.feasible(x, y);
}

// Exact projection of (px, py) onto one device's polytope by the team.
// Thread t takes the list entries e = t - 1 (mod T), e = -1 being the point
// itself (distance 0 if feasible, else inf), and keeps the first of least
// distance among its own; the team then keeps the least (distance, entry).
template <int T>
__device__ void project(const nrcore::Team<T>& tm, const Step& S, const Poly& P, float px, float py, float* x_out,
                        float* y_out) {
  float bx = px, by = py, bd = INFINITY;
  int bi = nrcore::kBigIndex;
  if (tm.t == 0) {
    bd = P.feasible(px, py) ? 0.0f : INFINITY;
    bi = -1;
  }
  const int* cand = S.i[I_CAND];
  const int n_cand = S.dim[D_NCAND];
  for (int k = tm.t == 0 ? T - 1 : tm.t - 1; k < n_cand; k += T) {
    float x, y, d;
    if (candidate(P, __ldg(cand + 2 * k), __ldg(cand + 2 * k + 1), px, py, &x, &y, &d) && d < bd) {
      bx = x;
      by = y;
      bd = d;
      bi = k;
    }
  }
  for (int o = T / 2; o > 0; o >>= 1) {
    const float ox = tm.xor_(bx, o), oy = tm.xor_(by, o), od = tm.xor_(bd, o);
    const int oi = tm.xor_(bi, o);
    if (od < bd || (od == bd && oi < bi)) {
      bx = ox;
      by = oy;
      bd = od;
      bi = oi;
    }
  }
  *x_out = bx;
  *y_out = by;
}

template <class C>
__global__ void __launch_bounds__(C::kThreadsMax, 1)
step_fused_kernel(Step S, const float* __restrict__ in, float* __restrict__ out, int B, float x_tol, int max_iter,
                  int chord_iters, int pivot) {
  constexpr int T = C::T;
  const int n = S.dim[D_N], d = S.dim[D_D], L = S.dim[D_L];
  const nrcore::Tables nt{S.f[F_YRE], S.f[F_YIM], S.f[F_J0INV], n};
  float* smem = nrcore::dynamic_smem();
  const nrcore::TableView tv = nrcore::stage_tables(nt, smem, chord_iters > 0);
  const int slot = threadIdx.x / T;
  const int b = blockIdx.x * (blockDim.x / T) + slot;
  if (b >= B) return;  // a whole team: no thread of it syncs again
  const auto tm = nrcore::Team<T>::make();
  const int t = tm.t;
  const nrcore::Layout Lay = step_layout(S.dim, T);
  const nrcore::Lane ln{smem + nrcore::table_floats(n, chord_iters > 0) + slot * Lay.stride, Lay};
  float* dev_p = ln.s + Lay.tail;
  float* dev_q = dev_p + d;
  float* p_pot = dev_q + d;

  const int n_load = S.dim[D_NLOAD], n_gen = S.dim[D_NGEN], n_des = S.dim[D_NDES], R = S.dim[D_ROWS];
  const int n_ctl = n_gen + n_des;
  const float dt = S.delta_t;
  // Input and output row offsets.
  const int in_pload = n_des, in_ppot = in_pload + n_load, in_psg = in_ppot + n_gen, in_qsg = in_psg + n_gen;
  const int in_psd = in_qsg + n_gen, in_qsd = in_psd + n_des;
  const int o_devq = d, o_soc = 2 * d, o_ppot = o_soc + n_des, o_vre = o_ppot + n_gen, o_vim = o_vre + n;
  const int o_ire = o_vim + n, o_iim = o_ire + n, o_busp = o_iim + n, o_busq = o_busp + n, o_br = o_busq + n;
  const int o_eloss = o_br + 9 * L;
  auto IN = [&](int row) { return in[(size_t)row * B + b]; };
  auto OUT = [&](int row, float v) { out[(size_t)row * B + b] = v; };
  const float* loadc = S.f[F_LOADC];
  const float* genc = S.f[F_GENC];
  const float* desc = S.f[F_DESC];

  const float zero = IN(0) * 0.0f;
  for (int k = t; k < d; k += T) dev_p[k] = dev_q[k] = zero;
  tm.sync();
  // 1. Loads.
  for (int i = t; i < n_load; i += T) {
    const float lp = clip(IN(in_pload + i), __ldg(loadc + 3 * i), __ldg(loadc + 3 * i + 1));
    const int pos = __ldg(S.i[I_LOAD_POS] + i);
    dev_p[pos] = lp;
    dev_q[pos] = lp * __ldg(loadc + 3 * i + 2);
  }
  // 2. Generator potentials.
  for (int i = t; i < n_gen; i += T) {
    p_pot[i] = clip(IN(in_ppot + i), __ldg(genc + 2 * i), __ldg(genc + 2 * i + 1));
    OUT(o_ppot + i, p_pot[i]);
  }
  tm.sync();
  // 3. This step's polytope rows: the potential caps the generators, the
  // SoC-rate caps the storage units; every row's tolerance.
  float* poly_h = ln.s;
  float* poly_tol = ln.s + n_ctl * R;
  const int cap_row = S.dim[D_CAP_ROW], floor_row = S.dim[D_FLOOR_ROW];
  for (int e = t; e < n_ctl * R; e += T) {
    const int c = e / R, r = e - c * R;
    const bool gen = c < n_gen;
    float h = __ldg(S.f[F_H0] + e);
    if (!gen && (r == cap_row || r == floor_row)) {
      const int j = c - n_gen;
      const float soc = IN(j), eff = __ldg(desc + 3 * j + 2);
      h = r == cap_row ? eff * (soc - __ldg(desc + 3 * j)) / dt : -(soc - __ldg(desc + 3 * j + 1)) / (dt * eff);
    } else if (gen && r == cap_row) {
      h = p_pot[c];
    }
    poly_h[e] = h;
    poly_tol[e] = kEps * (1.0f + (isfinite(h) ? fabsf(h) : 0.0f));
  }
  tm.sync();
  // 3-4. The projection of every controllable device, then the SoC update.
  for (int c = 0; c < n_ctl; ++c) {
    const bool gen = c < n_gen;
    const int j = gen ? c : c - n_gen;
    const Poly P{S.f[F_GX] + c * R, S.f[F_GY] + c * R, poly_h + c * R, poly_tol + c * R, R};
    float x, y;
    project(tm, S, P, IN(gen ? in_psg + j : in_psd + j), IN(gen ? in_qsg + j : in_qsd + j), &x, &y);
    if (t == c % T) {
      const int pos = __ldg((gen ? S.i[I_GEN_POS] : S.i[I_DES_POS]) + j);
      dev_p[pos] = x;
      dev_q[pos] = y;
      if (!gen) {
        const float soc = IN(j), eff = __ldg(desc + 3 * j + 2);
        const float s = x <= 0.0f ? soc - (dt * eff) * x : soc - (dt * x) / eff;
        OUT(o_soc + j, clip(s, __ldg(desc + 3 * j), __ldg(desc + 3 * j + 1)));
      }
    }
  }
  tm.sync();
  // 5. Bus aggregation of the non-slack buses (the slack bus takes the
  // recovered slack power below).
  const int* bus_ptr = S.i[I_BUS_PTR];
  const int* bus_dev = S.i[I_BUS_DEV];
  for (int s = t; s < n - 1; s += T) {
    const int lo = __ldg(bus_ptr + s + 1), hi = __ldg(bus_ptr + s + 2);
    float ap = zero, aq = zero;
    for (int k = lo; k < hi; ++k) {
      const int dv = __ldg(bus_dev + k);
      ap = k == lo ? dev_p[dv] : ap + dev_p[dv];
      aq = k == lo ? dev_q[dv] : aq + dev_q[dv];
    }
    ln.p(s) = ap;
    ln.q(s) = aq;
    OUT(o_busp + s + 1, ap);
    OUT(o_busq + s + 1, aq);
  }
  // 6. Power flow (the scratch above is free again).
  int it;
  const float diff = nrcore::solve<C>(tm, tv, ln, x_tol, max_iter, chord_iters, pivot != 0, &it);
  // 7. Slack recovery.
  if (t == 0) {
    const float p0 = isnan(ln.ir(0)) ? INFINITY : ln.ir(0);
    const float q0 = isnan(ln.ii(0)) ? INFINITY : -ln.ii(0);
    const int slack = S.dim[D_SLACK];
    dev_p[slack] = p0;
    dev_q[slack] = q0;
    OUT(o_busp, p0);
    OUT(o_busq, q0);
  }
  tm.sync();
  for (int k = t; k < d; k += T) {
    OUT(k, dev_p[k]);
    OUT(o_devq + k, dev_q[k]);
  }
  for (int i = t; i < n; i += T) {
    OUT(o_vre + i, ln.vr(i));
    OUT(o_vim + i, ln.vi(i));
    OUT(o_ire + i, ln.ir(i));
    OUT(o_iim + i, ln.ii(i));
  }
  // 8. Branch currents and flows, one thread a branch; each branch's
  // penalty term goes to the scratch for the sequential sum below.
  float* br_term = ln.s;
  for (int l = t; l < L; l += T) {
    const int f = __ldg(S.i[I_BR_FT] + 2 * l), to = __ldg(S.i[I_BR_FT] + 2 * l + 1);
    const float* cf = S.f[F_BRCOEF] + 8 * l;  // aff, aft, atf, att as (re, im)
    float c[8];
    for (int k = 0; k < 8; ++k) c[k] = __ldg(cf + k);
    const float vfr = ln.vr(f), vfi = ln.vi(f), vtr = ln.vr(to), vti = ln.vi(to);
    const float if_re = c[0] * vfr - c[1] * vfi + c[2] * vtr - c[3] * vti;
    const float if_im = c[0] * vfi + c[1] * vfr + c[2] * vti + c[3] * vtr;
    const float it_re = c[6] * vtr - c[7] * vti + c[4] * vfr - c[5] * vfi;
    const float it_im = c[6] * vti + c[7] * vtr + c[4] * vfi + c[5] * vfr;
    const float p_f = vfr * if_re + vfi * if_im;
    const float q_f = vfi * if_re - vfr * if_im;
    const float p_t = vtr * it_re + vti * it_im;
    const float q_t = vti * it_re - vtr * it_im;
    const float s_f = sqrtf(p_f * p_f + q_f * q_f);
    const float s_t = sqrtf(p_t * p_t + q_t * q_t);
    const float s_m = sgn(p_f) * nanmax(s_f, s_t);
    const float vals[9] = {if_re, if_im, it_re, it_im, p_f, q_f, p_t, q_t, s_m};
    for (int k = 0; k < 9; ++k) OUT(o_br + k * L + l, vals[k]);
    br_term[l] = nanmax(0.0f, fabsf(s_m) - __ldg(S.f[F_RATE] + l));
  }
  tm.sync();
  // 9. Reward terms: the three order-sensitive sums, on one thread.
  if (t == 0) {
    float br_pen = 0.0f;
    for (int l = 0; l < L; ++l) br_pen = br_pen + br_term[l];
    float e_loss = 0.0f;
    for (int k = 0; k < d; ++k) e_loss = e_loss + __ldg(S.f[F_ELOSS] + k) * dev_p[k];
    for (int r = 0; r < S.dim[D_NRER]; ++r) {
      const int gi = __ldg(S.i[I_RER] + 2 * r), dpos = __ldg(S.i[I_RER] + 2 * r + 1);
      e_loss = e_loss + nanmax(0.0f, p_pot[gi] - dev_p[dpos]);
    }
    e_loss = e_loss * dt;
    float v_pen = 0.0f;
    const float* busv = S.f[F_BUSV];
    for (int i = 0; i < n; ++i) {
      const float vm = sqrtf(ln.vr(i) * ln.vr(i) + ln.vi(i) * ln.vi(i));
      v_pen = v_pen + (nanmax(0.0f, vm - __ldg(busv + 2 * i + 1)) + nanmax(0.0f, __ldg(busv + 2 * i) - vm));
    }
    OUT(o_eloss, e_loss);
    OUT(o_eloss + 1, (v_pen + br_pen) * S.dt_lamb);
    OUT(o_eloss + 2, diff);
    OUT(o_eloss + 3, (float)it);
  }
}

template <class C>
cudaError_t geometry(const int* dims, int chord_iters, bool occupancy, nrcore::Geometry* g) {
  const nrcore::Layout L = step_layout(dims, C::T);
  if (!nrcore::plan<C>(L.stride, nrcore::table_floats(dims[D_N], chord_iters > 0), g))
    return cudaErrorInvalidValue;
  return nrcore::prepare<step_fused_kernel<C>>(g, occupancy);
}

bool valid_dims(const int* dims) {
  const int n = dims[D_N];
  return n >= 2 && 2 * (n - 1) <= nrcore::kNNMax && dims[D_D] >= 1 && dims[D_ROWS] >= 1;
}

bool small_system(int n) { return 2 * (n - 1) <= nrcore::SmallClass::NN; }

}  // namespace

extern "C" int step_fused_sizes(int* n_ftab, int* n_itab, int* n_dim) {
  *n_ftab = N_FTAB;
  *n_itab = N_ITAB;
  *n_dim = N_DIM;
  return 0;
}

// The launch geometry for a grid of sizes `dims` (host array of N_DIM ints):
// out = [threads a lane, lanes a block, threads a block, dynamic shared
// bytes a block, resident blocks an SM].
extern "C" int step_fused_geometry(const int* dims, int chord_iters, int* out) {
  if (!valid_dims(dims)) return static_cast<int>(cudaErrorInvalidValue);
  nrcore::Geometry g;
  const cudaError_t err = small_system(dims[D_N]) ? geometry<nrcore::SmallClass>(dims, chord_iters, true, &g)
                                                  : geometry<nrcore::LargeClass>(dims, chord_iters, true, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[5] = {g.team, g.lanes, g.threads, g.smem, g.blocks_per_sm};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
}

// ftab: host array of N_FTAB device pointers (float tables); itab: host array
// of N_ITAB device pointers (int32 tables); dims: host array of N_DIM ints.
// lanes_in: [K_in, B]; lanes_out: [K_out, B].  `stream` is a cudaStream_t.
extern "C" int step_fused_f32(const void* const* ftab, const void* const* itab, const int* dims, float delta_t,
                              float dt_lamb, const float* lanes_in, float* lanes_out, int B, float x_tol,
                              int max_iter, int chord_iters, int pivot, void* stream) {
  if (!valid_dims(dims) || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Step S;
  for (int k = 0; k < N_FTAB; ++k) S.f[k] = static_cast<const float*>(ftab[k]);
  for (int k = 0; k < N_ITAB; ++k) S.i[k] = static_cast<const int*>(itab[k]);
  for (int k = 0; k < N_DIM; ++k) S.dim[k] = dims[k];
  S.delta_t = delta_t;
  S.dt_lamb = dt_lamb;
  const auto s = static_cast<cudaStream_t>(stream);
  nrcore::Geometry g;
  cudaError_t err;
  if (small_system(dims[D_N])) {
    err = geometry<nrcore::SmallClass>(dims, chord_iters, false, &g);
    if (err == cudaSuccess)
      err = nrcore::launch(step_fused_kernel<nrcore::SmallClass>, g, B, s, S, lanes_in, lanes_out, B, x_tol, max_iter,
                           chord_iters, pivot);
  } else {
    err = geometry<nrcore::LargeClass>(dims, chord_iters, false, &g);
    if (err == cudaSuccess)
      err = nrcore::launch(step_fused_kernel<nrcore::LargeClass>, g, B, s, S, lanes_in, lanes_out, B, x_tol, max_iter,
                           chord_iters, pivot);
  }
  return static_cast<int>(err);
}
