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
//  6. the NR solve: on a radial grid (one with a tree schedule) without a
//     chord prefix or pivoting, the tree solve (treecore::newton,
//     tree_core.cuh, K1's body) on the grid's slots; otherwise the dense
//     solve (nrcore::solve, nr_core.cuh);
//  7. slack recovery (a NaN slack power becomes +inf);
//  8. branch currents, flows and the signed apparent power s_max;
//  9. e_loss and the constraint penalty.
//
// What bounds it on an H100: the NR solve inside it, and how many lanes a
// card holds at once.  The dense form eliminates the lane's whole
// [2m, 2m | F] system (64 pivot steps at feeder33's 33 buses), which at
// ~20 KB of shared memory a lane keeps 11 lanes on an SM, so 4,096 lanes
// take 2.8 latency-bound waves; it takes at most 64 unknowns.  A radial
// grid's Jacobian eliminates leaf to root with no fill-in, so the tree form
// solves each NR step in O(S) 2x2-block operations from 22 planes of S
// floats (2.8 KB at S = 32), at any S whose lane a block can hold: with the
// stages' own state a lane takes 3.7 KB at S = 32, and 4,096 lanes fit the
// card in one wave (kTreeThreadsPerSM).  Past kLargeSlots the planes
// dominate (12.3 KB of a lane's 13.7 KB at the 141-bus feeder's S = 140):
// there the scratch overlays planes that are dead in its stage (WideClass),
// 16 lanes share a block, one block an SM, and 4,096 lanes take two waves,
// as in the tree-NR kernel's two blocks of 8.  Outside the solve: serial
// per-lane work, the largest part the projection (47 candidates for each
// controllable device, each tested against every polytope row).  The
// design answers both with one team of T threads per lane, the team of
// the NR solve: loads, potentials and the polytope rows split by device
// and row; the projection's (device, candidate) pairs split over the team,
// each thread keeping a running minimum over its own candidates in
// increasing order and the team then reducing by (distance, candidate
// index), which picks what the sequential scan picks; bus aggregation one
// thread per bus (the tree form: per slot, in slot order), branch flows one
// thread per branch.  The three order-sensitive sums (e_loss, the voltage
// and the branch penalties) stay sequential on one thread.  dev_p, dev_q
// and the potentials live in the lane's shared-memory region; the polytope
// rows and the branch penalties are scratch, overlaid on the dense form's
// NR system; the tree form keeps them after its planes or, past
// kLargeSlots, overlays them on planes the solve is not using.  Each lane's
// first thread adds the lane's iterations, and whether it ended
// unconverged, to the process's device counters, so a replayed CUDA graph
// counts too.
//
// Layout: the lane inputs arrive packed batch-last, [K_in, B] (soc, P_load,
// P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des); the outputs leave
// packed, [K_out, B], in FusedStepOutputs order plus the NR iteration count.
// The dense form stages Y (and J0inv with a chord prefix) in shared memory
// per block, the tree form the schedule; the other grid tables are small
// device arrays read through the read-only cache.  The tree form returns V
// and I (the slack's current the sequential sum over row 0 of Y, as the
// dense form takes it) in bus order; its iterations go to this kernel's
// counters, not to the tree-NR kernel's.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream, does not synchronise and allocates nothing; the function returns
// the CUDA error of the launch (or of the shared-memory opt-in before it).

#include <cuda_runtime.h>
#include <math.h>

#include "nr_core.cuh"
#include "tree_core.cuh"

namespace {

constexpr float kEps = 1e-5f;

// Float tables, int tables and sizes, in the order of the host arrays
// (gym_anm_tpu_torch/ops/step_cuda.py: FLOAT_TABLES, INT_TABLES, DIMS).
enum FTab { F_YRE, F_YIM, F_J0INV, F_GX, F_GY, F_H0, F_LOADC, F_GENC, F_DESC, F_BUSV, F_ELOSS, F_RATE, F_BRCOEF,
            N_FTAB };
enum ITab { I_LOAD_POS, I_GEN_POS, I_DES_POS, I_BUS_PTR, I_BUS_DEV, I_BR_FT, I_RER, I_CAND, N_ITAB };
enum Dim { D_N, D_D, D_L, D_NLOAD, D_NGEN, D_NDES, D_NRER, D_SLACK, D_ROWS, D_CAP_ROW, D_FLOOR_ROW, D_NCAND, N_DIM };
// The tree form's schedule tables and sizes (step_cuda.py: TREE_TABLES,
// TREE_DIMS).
enum TTab { T_YCOLS, T_PAR, T_CH, T_LEVELS, T_SLOT_BUS, T_BUS_SLOT, N_TTAB };
enum TDim { TD_S, TD_MAXC, TD_NLEVELS, N_TDIM };

// Threads an SM the tree form is built to keep resident (its launch
// bound): 32 warps, so one wave holds 4,096 lanes of 32 slots on 132 SMs.
constexpr int kTreeThreadsPerSM = 1024;

// The tree form's size classes: treecore's two (S <= kSmallSlots, then
// S <= kLargeSlots, the 33-bus feeders) keep the scratch after the planes;
// past kLargeSlots WideClass overlays it on the planes and a block holds up
// to 16 lanes: at S = 140 one block of 16 such lanes fits an SM's shared
// memory, where two blocks of 8 lanes that keep the scratch do not.
constexpr int kLargeSlots = 32;
using WideClass = treecore::SizeClass<32, 16>;
template <class C>
constexpr bool kScratchInPlanes = false;
template <>
constexpr bool kScratchInPlanes<WideClass> = true;

struct Step {
  const float* f[N_FTAB];
  const int* i[N_ITAB];
  int dim[N_DIM];
  float delta_t, dt_lamb;
  unsigned long long* counts;  // [2] the process's counters
};

// The grid's schedule for the tree form.
struct TreeStep {
  treecore::Tables sched;
  const long long* slot_bus;  // [S] bus - 1 of each slot, n - 1 at a pad slot
  const long long* bus_slot;  // [n - 1] the slot of bus i + 1
};

using nrcore::nanmax;

__device__ inline float clip(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }

__device__ inline float sgn(float x) { return isnan(x) ? x : (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f)); }

// Floats of a lane's scratch: the polytope rows (h and tol, [C, R] each)
// before the solve, the branch penalties [L] after it.
__host__ __device__ inline int step_scratch(const int* dim) {
  const int poly = 2 * (dim[D_NGEN] + dim[D_NDES]) * dim[D_ROWS];
  return poly > dim[D_L] ? poly : dim[D_L];
}

// The dense form's lane region: the NR layout, with the scratch in front,
// then dev_p [d], dev_q [d] and the clipped potentials [n_gen].
__host__ __device__ inline nrcore::Layout step_layout(const int* dim, int team) {
  return nrcore::make_layout(dim[D_N], team, step_scratch(dim), 2 * dim[D_D] + dim[D_NGEN]);
}

// The tree form's floats after the lane's planes: dev_p, dev_q, the
// potentials and (unless class C overlays it on the planes) the scratch.
template <class C>
__host__ __device__ inline int tree_tail_floats(const int* dim) {
  return 2 * dim[D_D] + dim[D_NGEN] + (kScratchInPlanes<C> ? 0 : step_scratch(dim));
}

// The epilogue's count on the process's counters, by the lane's first
// thread: its iterations and whether it ended unconverged (NaN included).
__device__ inline void count(const Step& S, int t, int it, float diff, float x_tol) {
  if (t != 0) return;
  atomicAdd(&S.counts[0], (unsigned long long)it);
  if (!(diff <= x_tol)) atomicAdd(&S.counts[1], 1ull);
}

// Lane b's columns of the packed inputs and outputs.  A lane past the batch
// (tree form) reads lane 0's inputs and writes nothing.
struct LaneIO {
  const float* in;
  float* out;
  int B, b;
  bool write;
  __device__ float get(int row) const { return in[(size_t)row * B + b]; }
  __device__ void put(int row, float v) const {
    if (write) out[(size_t)row * B + b] = v;
  }
};

// Row offsets of the packed inputs (soc at 0) and outputs (dev_p at 0).
struct Rows {
  int pload, ppot, psg, qsg, psd, qsd;
  int devq, soc, ppot_out, vre, vim, ire, iim, busp, busq, br, eloss;
};

__device__ inline Rows rows(const int* dim) {
  const int n = dim[D_N], d = dim[D_D], L = dim[D_L], n_gen = dim[D_NGEN], n_des = dim[D_NDES];
  Rows r;
  r.pload = n_des;
  r.ppot = r.pload + dim[D_NLOAD];
  r.psg = r.ppot + n_gen;
  r.qsg = r.psg + n_gen;
  r.psd = r.qsg + n_gen;
  r.qsd = r.psd + n_des;
  r.devq = d;
  r.soc = 2 * d;
  r.ppot_out = r.soc + n_des;
  r.vre = r.ppot_out + n_gen;
  r.vim = r.vre + n;
  r.ire = r.vim + n;
  r.iim = r.ire + n;
  r.busp = r.iim + n;
  r.busq = r.busp + n;
  r.br = r.busq + n;
  r.eloss = r.br + 9 * L;
  return r;
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

// Exact projection of (px, py) onto one device's polytope by the team (of
// either form: `tm` has the rank t and the team's shuffle xor_).  Thread t
// takes the list entries e = t - 1 (mod T), e = -1 being the point itself
// (distance 0 if feasible, else inf), and keeps the first of least distance
// among its own; the team then keeps the least (distance, entry).
template <int T, class Tm>
__device__ void project(const Tm& tm, const Step& S, const Poly& P, float px, float py, float* x_out,
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

// Stages 1-4 for one lane: dev_p, dev_q [d] (the slack's left at the lane's
// zero), the clipped potentials p_pot [n_gen] and the new SoC; `poly` is the
// scratch for the polytope rows.  Returns the lane's zero, soc * 0 (NaN
// with it).
template <int T, class Tm>
__device__ float set_devices(const Tm& tm, const Step& S, const LaneIO& io, float* dev_p, float* dev_q,
                             float* p_pot, float* poly) {
  const int t = tm.t, d = S.dim[D_D];
  const int n_load = S.dim[D_NLOAD], n_gen = S.dim[D_NGEN], n_des = S.dim[D_NDES], R = S.dim[D_ROWS];
  const int n_ctl = n_gen + n_des;
  const float dt = S.delta_t;
  const Rows rw = rows(S.dim);
  const float* loadc = S.f[F_LOADC];
  const float* genc = S.f[F_GENC];
  const float* desc = S.f[F_DESC];

  const float zero = io.get(0) * 0.0f;
  for (int k = t; k < d; k += T) dev_p[k] = dev_q[k] = zero;
  tm.sync();
  // 1. Loads.
  for (int i = t; i < n_load; i += T) {
    const float lp = clip(io.get(rw.pload + i), __ldg(loadc + 3 * i), __ldg(loadc + 3 * i + 1));
    const int pos = __ldg(S.i[I_LOAD_POS] + i);
    dev_p[pos] = lp;
    dev_q[pos] = lp * __ldg(loadc + 3 * i + 2);
  }
  // 2. Generator potentials.
  for (int i = t; i < n_gen; i += T) {
    p_pot[i] = clip(io.get(rw.ppot + i), __ldg(genc + 2 * i), __ldg(genc + 2 * i + 1));
    io.put(rw.ppot_out + i, p_pot[i]);
  }
  tm.sync();
  // 3. This step's polytope rows: the potential caps the generators, the
  // SoC-rate caps the storage units; every row's tolerance.
  float* poly_h = poly;
  float* poly_tol = poly + n_ctl * R;
  const int cap_row = S.dim[D_CAP_ROW], floor_row = S.dim[D_FLOOR_ROW];
  for (int e = t; e < n_ctl * R; e += T) {
    const int c = e / R, r = e - c * R;
    const bool gen = c < n_gen;
    float h = __ldg(S.f[F_H0] + e);
    if (!gen && (r == cap_row || r == floor_row)) {
      const int j = c - n_gen;
      const float soc = io.get(j), eff = __ldg(desc + 3 * j + 2);
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
    project<T>(tm, S, P, io.get(gen ? rw.psg + j : rw.psd + j), io.get(gen ? rw.qsg + j : rw.qsd + j), &x, &y);
    if (t == c % T) {
      const int pos = __ldg((gen ? S.i[I_GEN_POS] : S.i[I_DES_POS]) + j);
      dev_p[pos] = x;
      dev_q[pos] = y;
      if (!gen) {
        const float soc = io.get(j), eff = __ldg(desc + 3 * j + 2);
        const float s = x <= 0.0f ? soc - (dt * eff) * x : soc - (dt * x) / eff;
        io.put(rw.soc + j, clip(s, __ldg(desc + 3 * j), __ldg(desc + 3 * j + 1)));
      }
    }
  }
  tm.sync();
  return zero;
}

// 5. The injection of non-slack bus `bus`: its devices summed in device
// order (a bus without devices reads `zero`), written to its output rows.
__device__ inline void bus_sum(const Step& S, const LaneIO& io, const Rows& rw, int bus, const float* dev_p,
                               const float* dev_q, float zero, float* ap_out, float* aq_out) {
  const int lo = __ldg(S.i[I_BUS_PTR] + bus), hi = __ldg(S.i[I_BUS_PTR] + bus + 1);
  float ap = zero, aq = zero;
  for (int k = lo; k < hi; ++k) {
    const int dv = __ldg(S.i[I_BUS_DEV] + k);
    ap = k == lo ? dev_p[dv] : ap + dev_p[dv];
    aq = k == lo ? dev_q[dv] : aq + dev_q[dv];
  }
  io.put(rw.busp + bus, ap);
  io.put(rw.busq + bus, aq);
  *ap_out = ap;
  *aq_out = aq;
}

// Stages 7-9 for one lane from the solved bus voltages and currents vr, vi,
// ir, ii [n] (the slack's at 0): slack recovery, the outputs, branch flows
// and the reward terms; br_term is scratch of L floats.
template <int T, class Tm>
__device__ void finish(const Tm& tm, const Step& S, const LaneIO& io, const float* vr, const float* vi,
                       const float* ir, const float* ii, float* dev_p, float* dev_q, const float* p_pot,
                       float* br_term, float diff, int it) {
  const int t = tm.t, n = S.dim[D_N], d = S.dim[D_D], L = S.dim[D_L];
  const Rows rw = rows(S.dim);
  // 7. Slack recovery.
  if (t == 0) {
    const float p0 = isnan(ir[0]) ? INFINITY : ir[0];
    const float q0 = isnan(ii[0]) ? INFINITY : -ii[0];
    const int slack = S.dim[D_SLACK];
    dev_p[slack] = p0;
    dev_q[slack] = q0;
    io.put(rw.busp, p0);
    io.put(rw.busq, q0);
  }
  tm.sync();
  for (int k = t; k < d; k += T) {
    io.put(k, dev_p[k]);
    io.put(rw.devq + k, dev_q[k]);
  }
  for (int i = t; i < n; i += T) {
    io.put(rw.vre + i, vr[i]);
    io.put(rw.vim + i, vi[i]);
    io.put(rw.ire + i, ir[i]);
    io.put(rw.iim + i, ii[i]);
  }
  // 8. Branch currents and flows, one thread a branch; each branch's
  // penalty term goes to the scratch for the sequential sum below.
  for (int l = t; l < L; l += T) {
    const int f = __ldg(S.i[I_BR_FT] + 2 * l), to = __ldg(S.i[I_BR_FT] + 2 * l + 1);
    const float* cf = S.f[F_BRCOEF] + 8 * l;  // aff, aft, atf, att as (re, im)
    float c[8];
    for (int k = 0; k < 8; ++k) c[k] = __ldg(cf + k);
    const float vfr = vr[f], vfi = vi[f], vtr = vr[to], vti = vi[to];
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
    for (int k = 0; k < 9; ++k) io.put(rw.br + k * L + l, vals[k]);
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
    e_loss = e_loss * S.delta_t;
    float v_pen = 0.0f;
    const float* busv = S.f[F_BUSV];
    for (int i = 0; i < n; ++i) {
      const float vm = sqrtf(vr[i] * vr[i] + vi[i] * vi[i]);
      v_pen = v_pen + (nanmax(0.0f, vm - __ldg(busv + 2 * i + 1)) + nanmax(0.0f, __ldg(busv + 2 * i) - vm));
    }
    io.put(rw.eloss, e_loss);
    io.put(rw.eloss + 1, (v_pen + br_pen) * S.dt_lamb);
    io.put(rw.eloss + 2, diff);
    io.put(rw.eloss + 3, (float)it);
  }
}

// The dense form: nrcore::solve on the lane's whole system.
template <class C>
__global__ void __launch_bounds__(C::kThreadsMax, 1)
step_fused_kernel(Step S, const float* __restrict__ in, float* __restrict__ out, int B, float x_tol, int max_iter,
                  int chord_iters, int pivot) {
  constexpr int T = C::T;
  const int n = S.dim[D_N], d = S.dim[D_D];
  const nrcore::Tables nt{S.f[F_YRE], S.f[F_YIM], S.f[F_J0INV], n};
  float* smem = nrcore::dynamic_smem();
  const nrcore::TableView tv = nrcore::stage_tables(nt, smem, chord_iters > 0);
  const int slot = threadIdx.x / T;
  const int b = blockIdx.x * (blockDim.x / T) + slot;
  if (b >= B) return;  // a whole team: no thread of it syncs again
  const auto tm = nrcore::Team<T>::make();
  const nrcore::Layout Lay = step_layout(S.dim, T);
  const nrcore::Lane ln{smem + nrcore::table_floats(n, chord_iters > 0) + slot * Lay.stride, Lay};
  float* dev_p = ln.s + Lay.tail;
  float* dev_q = dev_p + d;
  float* p_pot = dev_q + d;
  const LaneIO io{in, out, B, b, true};
  const Rows rw = rows(S.dim);

  const float zero = set_devices<T>(tm, S, io, dev_p, dev_q, p_pot, ln.s);
  // 5. Bus aggregation of the non-slack buses (the slack bus takes the
  // recovered slack power below).
  for (int s = tm.t; s < n - 1; s += T) bus_sum(S, io, rw, s + 1, dev_p, dev_q, zero, &ln.p(s), &ln.q(s));
  // 6. Power flow (the scratch above is free again).
  int it;
  const float diff = nrcore::solve<C>(tm, tv, ln, x_tol, max_iter, chord_iters, pivot != 0, &it);
  finish<T>(tm, S, io, ln.s + Lay.vr, ln.s + Lay.vi, ln.s + Lay.ir, ln.s + Lay.ii, dev_p, dev_q, p_pot, ln.s, diff,
            it);
  count(S, tm.t, it, diff, x_tol);
}

// The tree form: treecore::newton on the grid's slots.  Every thread of a
// warp runs to the end (the solve's votes are warp-wide); a lane past the
// batch computes lane 0's transition beside its warp and writes nothing.
// Under kScratchInPlanes the polytope rows take the D, L and U planes, which
// the solve first writes after them, and the branch penalties the TH .. FQ
// planes, spent once V and I are in bus order.
template <class C>
__global__ void __launch_bounds__(C::kThreadsMax, kTreeThreadsPerSM / C::kThreadsMax)
step_fused_kernel_tree(Step S, TreeStep tr, const float* __restrict__ in, float* __restrict__ out, int B,
                       float x_tol, int max_iter) {
  constexpr int T = C::T;
  const int n = S.dim[D_N], d = S.dim[D_D], m = n - 1, NS = tr.sched.S;
  float* smem = nrcore::dynamic_smem();
  const treecore::Sched sc = treecore::stage_schedule(tr.sched, smem);
  const int slot = threadIdx.x / T;
  const int b = blockIdx.x * (blockDim.x / T) + slot;
  const bool valid = b < B;
  if (!__any_sync(treecore::kFull, valid)) return;  // a whole warp past the batch
  const treecore::Team<T> tm{(int)(threadIdx.x % T)};
  const treecore::Lane ln{smem + treecore::table_words(NS, sc.maxC, sc.n_levels) +
                              slot * treecore::lane_floats(NS, T, tree_tail_floats<C>(S.dim)),
                          NS};
  float* dev_p = ln.r + treecore::N_PLANES * NS;
  float* dev_q = dev_p + d;
  float* p_pot = dev_q + d;
  float* poly = kScratchInPlanes<C> ? &ln.at(treecore::D00, 0) : p_pot + S.dim[D_NGEN];
  float* br_term = kScratchInPlanes<C> ? &ln.at(treecore::TH, 0) : poly;
  const LaneIO io{in, out, B, valid ? b : 0, valid};
  const Rows rw = rows(S.dim);

  const float zero = set_devices<T>(tm, S, io, dev_p, dev_q, p_pot, poly);
  // 5. Bus aggregation into the schedule's slots (a pad slot injects 0).
  for (int s = tm.t; s < NS; s += T) {
    const int bm1 = (int)__ldg(tr.slot_bus + s);
    float ap = 0.0f, aq = 0.0f;
    if (bm1 < m) bus_sum(S, io, rw, bm1 + 1, dev_p, dev_q, zero, &ap, &aq);
    ln.at(treecore::PP, s) = ap;
    ln.at(treecore::PQ, s) = aq;
  }
  // 6. Power flow (the solve syncs the team before it reads the injections).
  int it;
  const float diff = treecore::newton(tm, sc, ln, valid, nullptr, nullptr, B, 0, x_tol, max_iter, &it);
  // V and I in bus order, over the solve's spent D, L and U planes (4 n <=
  // 12 S floats), the slack's V pinned at 1+0j.
  float* vr = &ln.at(treecore::D00, 0);
  float* vi = vr + n;
  float* ir = vi + n;
  float* ii = ir + n;
  for (int i = tm.t; i < m; i += T) {
    const int s = (int)__ldg(tr.bus_slot + i);
    vr[i + 1] = ln.at(treecore::VR, s);
    vi[i + 1] = ln.at(treecore::VI, s);
    ir[i + 1] = ln.at(treecore::IR, s);
    ii[i + 1] = ln.at(treecore::II, s);
  }
  if (tm.t == 0) {
    vr[0] = 1.0f;
    vi[0] = 0.0f;
  }
  tm.sync();
  // The slack's current at the final V: the sequential sum over row 0 of Y,
  // as the dense form takes it.
  if (tm.t == 0) {
    float ar = 0.0f, ai = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float yr = __ldg(S.f[F_YRE] + k), yi = __ldg(S.f[F_YIM] + k);
      ar = ar + (yr * vr[k] - yi * vi[k]);
      ai = ai + (yr * vi[k] + yi * vr[k]);
    }
    ir[0] = ar;
    ii[0] = ai;
  }
  tm.sync();
  finish<T>(tm, S, io, vr, vi, ir, ii, dev_p, dev_q, p_pot, br_term, diff, it);
  if (valid) count(S, tm.t, it, diff, x_tol);
}

template <class C>
cudaError_t geometry(const int* dims, int chord_iters, bool occupancy, nrcore::Geometry* g) {
  const nrcore::Layout L = step_layout(dims, C::T);
  if (!nrcore::plan<C>(L.stride, nrcore::table_floats(dims[D_N], chord_iters > 0), g))
    return cudaErrorInvalidValue;
  return nrcore::prepare<step_fused_kernel<C>>(g, occupancy);
}

template <class C>
cudaError_t tree_geometry(const int* dims, const int* tdims, bool occupancy, nrcore::Geometry* g) {
  const int NS = tdims[TD_S];
  if (!nrcore::plan<C>(treecore::lane_floats(NS, C::T, tree_tail_floats<C>(dims)),
                       treecore::table_words(NS, tdims[TD_MAXC], tdims[TD_NLEVELS]), g))
    return cudaErrorInvalidValue;
  if (g->threads % 32 != 0) return cudaErrorInvalidValue;  // warps are whole: every vote names all 32 threads
  return nrcore::prepare<step_fused_kernel_tree<C>>(g, occupancy);
}

bool valid_dims(const int* dims) {
  const int n = dims[D_N];
  return n >= 2 && 2 * (n - 1) <= nrcore::kNNMax && dims[D_D] >= 1 && dims[D_ROWS] >= 1;
}

// The tree form holds no dense system, so no cap on the unknowns: a
// schedule holds a slot for every non-slack bus, so S >= n - 1 and the
// bus-order V and I (4 n floats) fit the 12 S floats of the spent D, L and
// U planes.  Past kLargeSlots the polytope rows fit those 12 S floats too
// and the branch penalties the 10 S floats of TH .. FQ.  Whether a block
// holds a lane is the geometry's to say (nrcore::plan).
bool valid_tree(const int* dims, const int* tdims) {
  const int n = dims[D_N], NS = tdims[TD_S];
  const bool ok = n >= 2 && dims[D_D] >= 1 && dims[D_ROWS] >= 1 && tdims[TD_MAXC] >= 1 && tdims[TD_NLEVELS] >= 1 &&
                  NS >= n - 1;
  if (NS <= kLargeSlots) return ok;
  return ok && 2 * (dims[D_NGEN] + dims[D_NDES]) * dims[D_ROWS] <= 12 * NS && dims[D_L] <= 10 * NS;
}

bool small_system(int n) { return 2 * (n - 1) <= nrcore::SmallClass::NN; }

Step make_step(const void* const* ftab, const void* const* itab, const int* dims, float delta_t, float dt_lamb,
               unsigned long long* counts) {
  Step S;
  for (int k = 0; k < N_FTAB; ++k) S.f[k] = static_cast<const float*>(ftab[k]);
  for (int k = 0; k < N_ITAB; ++k) S.i[k] = static_cast<const int*>(itab[k]);
  for (int k = 0; k < N_DIM; ++k) S.dim[k] = dims[k];
  S.delta_t = delta_t;
  S.dt_lamb = dt_lamb;
  S.counts = counts;
  return S;
}

template <class C>
cudaError_t tree_launch(const Step& S, const TreeStep& tr, const int* tdims, const float* in, float* out, int B,
                        float x_tol, int max_iter, cudaStream_t s) {
  nrcore::Geometry g;
  const cudaError_t err = tree_geometry<C>(S.dim, tdims, false, &g);
  if (err != cudaSuccess) return err;
  return nrcore::launch(step_fused_kernel_tree<C>, g, B, s, S, tr, in, out, B, x_tol, max_iter);
}

int write_geometry(const nrcore::Geometry& g, int* out) {
  const int vals[5] = {g.team, g.lanes, g.threads, g.smem, g.blocks_per_sm};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
}

}  // namespace

// The counts of the host arrays: float tables, int tables, sizes, and the
// tree form's schedule tables and sizes.
extern "C" int step_fused_sizes(int* n_ftab, int* n_itab, int* n_dim, int* n_ttab, int* n_tdim) {
  *n_ftab = N_FTAB;
  *n_itab = N_ITAB;
  *n_dim = N_DIM;
  *n_ttab = N_TTAB;
  *n_tdim = N_TDIM;
  return 0;
}

// The dense form's launch geometry for a grid of sizes `dims` (host array
// of N_DIM ints): out = [threads a lane, lanes a block, threads a block,
// dynamic shared bytes a block, resident blocks an SM].
extern "C" int step_fused_geometry(const int* dims, int chord_iters, int* out) {
  if (!valid_dims(dims)) return static_cast<int>(cudaErrorInvalidValue);
  nrcore::Geometry g;
  const cudaError_t err = small_system(dims[D_N]) ? geometry<nrcore::SmallClass>(dims, chord_iters, true, &g)
                                                  : geometry<nrcore::LargeClass>(dims, chord_iters, true, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return write_geometry(g, out);
}

// The tree form's launch geometry for `dims` and a schedule of sizes
// `tdims` (host array of N_TDIM ints), as step_fused_geometry.
extern "C" int step_fused_tree_geometry(const int* dims, const int* tdims, int* out) {
  if (!valid_tree(dims, tdims)) return static_cast<int>(cudaErrorInvalidValue);
  nrcore::Geometry g;
  const int NS = tdims[TD_S];
  const cudaError_t err = NS <= treecore::kSmallSlots ? tree_geometry<treecore::SmallClass>(dims, tdims, true, &g)
                          : NS <= kLargeSlots         ? tree_geometry<treecore::LargeClass>(dims, tdims, true, &g)
                                                      : tree_geometry<WideClass>(dims, tdims, true, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return write_geometry(g, out);
}

// ftab: host array of N_FTAB device pointers (float tables); itab: host array
// of N_ITAB device pointers (int32 tables); dims: host array of N_DIM ints.
// lanes_in: [K_in, B]; lanes_out: [K_out, B]; counts: [2], to which the
// launch adds the lanes' iterations and the lanes that ended unconverged.
// `stream` is a cudaStream_t.
extern "C" int step_fused_f32(const void* const* ftab, const void* const* itab, const int* dims, float delta_t,
                              float dt_lamb, const float* lanes_in, float* lanes_out, int B, float x_tol,
                              int max_iter, int chord_iters, int pivot, unsigned long long* counts, void* stream) {
  if (!valid_dims(dims) || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Step S = make_step(ftab, itab, dims, delta_t, dt_lamb, counts);
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

// The tree form, as step_fused_f32 without a chord prefix or pivoting; ttab:
// host array of N_TTAB device pointers (ycols [S, 8] float32; par [S],
// children [maxC, S], levels [n_levels, 2] int32; slot_bus [S], bus_slot
// [n - 1] int64), tdims: host array of N_TDIM ints (S, maxC, n_levels).
extern "C" int step_fused_tree_f32(const void* const* ftab, const void* const* itab, const int* dims,
                                   const void* const* ttab, const int* tdims, float delta_t, float dt_lamb,
                                   const float* lanes_in, float* lanes_out, int B, float x_tol, int max_iter,
                                   unsigned long long* counts, void* stream) {
  if (!valid_tree(dims, tdims) || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Step S = make_step(ftab, itab, dims, delta_t, dt_lamb, counts);
  const TreeStep tr{treecore::Tables{static_cast<const float*>(ttab[T_YCOLS]), static_cast<const int*>(ttab[T_PAR]),
                                     static_cast<const int*>(ttab[T_CH]), static_cast<const int*>(ttab[T_LEVELS]),
                                     tdims[TD_S], tdims[TD_MAXC], tdims[TD_NLEVELS]},
                    static_cast<const long long*>(ttab[T_SLOT_BUS]), static_cast<const long long*>(ttab[T_BUS_SLOT])};
  const auto s = static_cast<cudaStream_t>(stream);
  const int NS = tdims[TD_S];
  const cudaError_t err =
      NS <= treecore::kSmallSlots ? tree_launch<treecore::SmallClass>(S, tr, tdims, lanes_in, lanes_out, B, x_tol,
                                                                      max_iter, s)
      : NS <= kLargeSlots ? tree_launch<treecore::LargeClass>(S, tr, tdims, lanes_in, lanes_out, B, x_tol, max_iter, s)
                          : tree_launch<WideClass>(S, tr, tdims, lanes_in, lanes_out, B, x_tol, max_iter, s);
  return static_cast<int>(err);
}
