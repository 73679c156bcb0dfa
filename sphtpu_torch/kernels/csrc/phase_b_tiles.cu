// phase_b_tiles: the tile engines' pair forces + near-field gravity
// correction, ten query-side reductions in one pass over the pair tile.
//
// Replaces the TPU kernel sphtpu/kernels/pallas_tile_pairs.py::phase_b_tiles
// (_kernel). Outputs per query slot: ax, ay, az (forward mask d2 <= (2 h_q)^2
// with grad W(h_q) and cs_q in Pi; reverse mask d2 <= (2 h_c)^2 with
// grad W(h_c) and cs_c), div (forward), mu_max (a MAX over the forward
// mask, self column included, init -max), visc (forward + reverse), and
// ggx, ggy, ggz, gphi = m * sum (softened - Newtonian) for r <= 2 h_avg,
// plus (Newtonian - mesh shape) for every pair when P3M. Polytropic
// coefficient symmetric, isothermal asymmetric; self pairs have 1/r -> 0.
//
// Bound on this card: bytes of the candidate rows (their mask plane whole,
// ten planes at the occupied slots) against d2 and a compare on every
// (query, occupied candidate) pair and the ~140-operation body only on the
// few percent inside a mask. Design:
// * One CTA a cell row. Its occupied queries (cap <= 256) are compacted,
//   order kept, into shared memory; the unoccupied slots get zeros and
//   mu_max = -max at once, and a row with none leaves.
// * The row's occupancy is read once (every mask load in flight together)
//   into bits with a prefix of their counts, so the occupied candidates are
//   numbered in slot order without a pass per 256 slots. They are staged
//   `piece` records at a time: position and a cull radius in one 16-byte
//   record (float32), and 8 planes (vx vy vz h rho por2 cs 1/h).
// * Each warp takes whole queries (k = warp, warp + 8, ...) and TESTS each
//   (query, record) pair ONCE, two words of 32 records a step, against a
//   conservative radius that covers all three masks: d2 <= max(c_q, c_c),
//   c = (2 rho)^2 (1 + 2^-8), rho = h where h > 0, else max(|h|, 1)
//   (`cull_r2`; the forward and reverse masks need d2 <= (2h)^2, the
//   gravity mask r <= h_q' + h_c' <= 2 max(rho); the margin also covers the
//   test's d2 contracting to FMAs). The kept records go to the warp's queue
//   in record order; every 32 of them (and the rest at the end of a piece)
//   are EVALUATED ONCE, one pair a lane, and lane f < 10 adds term f of
//   each to the query's sum in queue order, so each sum runs in candidate
//   order. Under P3M (term 2 on every pair) or `keep_all` every occupied
//   pair is kept. No barrier inside the sweep.
// * The exact fwd, rev and gravity masks are decided in the body as before.
// * Division diet: 1/h of each side once a record; in float32 the three
//   per-pair reciprocals (h_avg, rho_avg, d2 + 0.01 h_avg^2) are one
//   approximate reciprocal each, /6 and /30 multiplications; float64 keeps
//   IEEE divisions.
// No atomics, fixed order: two launches on the same inputs give the same
// bits. A pair kept but outside every mask adds exact zeros (and -max to
// the max) in its place of the order, so `keep_all` must give the same
// bits as the cull.
// Outlier masks (the mono-tile engine's outlier lane; OUT = true, exact
// gravity only): the mask plane holds 2 at an outlier's slot (1 at any
// other occupied slot, which is all the occupancy tests ask: > 0). The
// variant stages the mask as a ninth record plane, and the forward mask
// drops a pair whose query is an outlier, the reverse mask one whose
// candidate is (the reference's fwd & (qo <= 0), rev & (cout <= 0)). The
// gravity mask and the cull are unchanged: the masks only shrink. Without
// the lane (OUT = false) the kernel is the one above, its layout and
// arithmetic untouched.
// Joint mode (GM_JOINT; the mono-tile and z-slab engines under P3M, float32,
// ROADMAP D21): a pair of the gravity mask takes term 1 and term 2
// (Newtonian - mesh shape) as ONE term, evaluated in double and rounded
// once, as K5 and K6 do (D12): their 1/r^3 and 1/r parts cancel, so two
// float sums of them lose the digits the difference keeps. The mask is then
// `joint_near` (common.cuh), which the tail kernel's skip mode decides the
// same way, so each pair of the 27-cell stencil takes term 2 in exactly one
// of the two kernels (the self pair: term 1 + sqrt(2/pi)/sigma here). The
// other modes' arithmetic is untouched.
#include "common.cuh"

namespace sph {

constexpr int B_PLANES = 8;  // a record's planes besides its position: vx vy vz h rho por2 cs 1/h
constexpr int B_OUT_PLANE = B_PLANES;  // with the outlier masks, the ninth: the mask
constexpr int B_MAX_CAP = TILE_THREADS;
constexpr int B_MAX_CW = 27 * B_MAX_CAP;  // widest candidate row: a 27-cell stack
constexpr int B_QUEUE = 96;  // a warp's queue: < 32 waiting + 64 of a step
constexpr int B_ROUNDS = 8;  // 256-slot rounds of the mask read together
constexpr int B_TERM_STRIDE = 33;  // a warp's pair terms: 10 rows of 32, padded

// the gravity mode of a launch: term 1 only; term 1 + term 2 on every pair
// (a one-cell tail stencil); term 1 + term 2 as one term inside the mask
constexpr int GM_NEAR = 0;
constexpr int GM_P3M = 1;
constexpr int GM_JOINT = 2;

template <typename T>
struct PhaseBArgs {
  const T* q[11];  // x y z vx vy vz mask h rho por2 cs, each (n_cells, cap)
  const T* c[11];  // same fields, each (n_cells, cw)
  const T* scal;   // m, alpha, beta, sigma on the device
  T* out[10];      // ax ay az div mu_max visc ggx ggy ggz gphi
  int cap;
  int cw;
  int piece;       // candidate records a piece (a multiple of 64)
  int keep_all;    // keep every occupied pair (the check of the cull)
};

// A staged record's position and cull radius^2 (one 16-byte load in
// float32: the test reads a candidate's four at once).
template <typename T>
struct alignas(16) QPos {
  T x, y, z, cull;
};

// Dynamic shared memory of `phase_b_kernel` (the wrapper's
// `k2_shared_bytes` mirrors it): the query and candidate positions and
// their other B_PLANES planes, the ten sums of each query, each warp's 32
// pair terms, then the ints (query slots, each warp's queue of kept
// records, the row's occupancy bits and their prefix).
template <typename T>
size_t phase_b_smem(int cap, int cw, int piece, int planes) {
  const size_t words = size_t(cw + 31) / 32;
  return sizeof(QPos<T>) * size_t(cap + piece) +
         sizeof(T) * (size_t(planes) * (cap + piece) + 10 * size_t(cap) +
                      size_t(TILE_WARPS) * 10 * B_TERM_STRIDE) +
         sizeof(int) * (size_t(cap) + size_t(TILE_WARPS) * B_QUEUE + 2 * words + 1);
}

// Block-wide exclusive scan: every thread calls it with a count v; returns
// the sum of the counts of the threads before it plus `base`, and advances
// `base` (uniform across the block) by the block's total. Two
// __syncthreads inside.
__device__ __forceinline__ int compact_count(int v, int& base, int* wcount) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    incl += lane >= o ? x : 0;
  }
  if (lane == 31) wcount[warp] = incl;
  __syncthreads();
  int off = base, total = 0;
#pragma unroll
  for (int w = 0; w < TILE_WARPS; ++w) {
    const int c = wcount[w];
    if (w < warp) off += c;
    total += c;
  }
  base += total;
  __syncthreads();
  return off + incl - v;
}

// the cull radius^2 of one side (see the header)
template <typename T>
__device__ __forceinline__ T cull_r2(T h) {
  const T a = h > T(0) ? h : (-h > T(1) ? -h : T(1));
  return T(4) * a * a * T(1.00390625);
}

template <typename T>
__device__ __forceinline__ T gap(T q, T lo, T hi) {
  const T d = lo - q > q - hi ? lo - q : q - hi;
  return d > T(0) ? d : T(0);
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

template <typename T>
struct BParams {
  T m, alpha, beta, sigma;
  T cz, ce, self_phi;  // term 2: 1/(sqrt2 sigma), exp(-z^2) = exp(d2 ce), sqrt(2/pi)/sigma
};

// The ten terms of one (query, candidate) pair: positions qp, cp and the
// other planes of query k (planes sq, stride qs) and record j (sc, cs).
template <typename T, bool ISO, int GM, bool OUT>
__device__ __forceinline__ void pair_terms(const QPos<T>& qp, const T* sq, int qs, int k,
                                           const QPos<T>& cp, const T* sc, int cs, int j,
                                           const BParams<T>& p, T* o) {
#define QF(f) sq[(f) * qs + k]
#define CF(f) sc[(f) * cs + j]
  const T dx = qp.x - cp.x;
  const T dy = qp.y - cp.y;
  const T dz = qp.z - cp.z;
  const T d2 = dist2<T>(dx, dy, dz);
  const bool sep = d2 > T(0);
  const T inv_r = sep ? Num<T>::rsqrt(d2) : T(0);  // self pairs: 1/r -> 0
  const T r = d2 * inv_r;

  const T qh = QF(3), ch = CF(3);
  bool fwd = d2 <= Num<T>::mul_rn(T(2) * qh, T(2) * qh);
  bool rev = d2 <= Num<T>::mul_rn(T(2) * ch, T(2) * ch);
  if (OUT) {
    fwd = fwd && QF(B_OUT_PLANE) <= T(1);
    rev = rev && CF(B_OUT_PLANE) <= T(1);
  }
  const T h_q = qh > T(0) ? qh : T(1);
  const T h_c = ch > T(0) ? ch : T(1);
  const T h_avg = T(0.5) * (h_q + h_c);
  const bool gmask = GM == GM_JOINT ? joint_near<T>(d2, h_q, h_c) : r <= T(2) * h_avg;
  const T inv_h = Num<T>::rcp(h_avg);
  const T inv_rho = Num<T>::rcp(T(0.5) * (QF(4) + CF(4)));

  const T v_dot_r = (QF(0) - CF(0)) * dx + (QF(1) - CF(1)) * dy + (QF(2) - CF(2)) * dz;
  T mu = h_avg * v_dot_r * Num<T>::rcp(d2 + T(0.01) * (h_avg * h_avg));
  mu = mu < T(0) ? mu : T(0);
  const T pi_fwd = (-p.alpha * QF(6) * mu + p.beta * mu * mu) * inv_rho;
  const T pi_rev = (-p.alpha * CF(6) * mu + p.beta * mu * mu) * inv_rho;

  // grad_W(q)/r with per-side h
  const T inv_pi = T(0.3183098861837907);
  const T inv_hq = QF(7);
  const T inv_hq2 = inv_hq * inv_hq;
  const T ct_wq = inv_pi * inv_hq2 * inv_hq2;
  const T q_q = r * inv_hq;
  const T two_q = T(2) - q_q;
  const T dwdr_q =
      q_q <= T(1) ? ct_wq * (T(2.25) * r * inv_hq2 - T(3) * inv_hq)
                  : (q_q <= T(2) ? ct_wq * (T(-0.75) * (two_q * two_q)) * inv_r : T(0));
  const T inv_hc = CF(7);
  const T inv_hc2 = inv_hc * inv_hc;
  const T ct_wc = inv_pi * inv_hc2 * inv_hc2;
  const T q_c = r * inv_hc;
  const T two_c = T(2) - q_c;
  const T dwdr_c =
      q_c <= T(1) ? ct_wc * (T(2.25) * r * inv_hc2 - T(3) * inv_hc)
                  : (q_c <= T(2) ? ct_wc * (T(-0.75) * (two_c * two_c)) * inv_r : T(0));

  T ct_fwd, ct_rev;
  if (ISO) {
    ct_fwd = p.m * (QF(5) + pi_fwd * T(0.5));
    ct_rev = p.m * (CF(5) + pi_rev * T(0.5));
  } else {
    const T psum = QF(5) + CF(5);
    ct_fwd = p.m * (psum + pi_fwd) * T(0.5);
    ct_rev = p.m * (psum + pi_rev) * T(0.5);
  }
#undef QF
#undef CF

  const T coeff = -(fwd ? ct_fwd * dwdr_q : T(0)) - (rev ? ct_rev * dwdr_c : T(0));
  o[0] = coeff * dx;
  o[1] = coeff * dy;
  o[2] = coeff * dz;
  const T v_dot_dw_q = v_dot_r * dwdr_q;
  const T v_dot_dw_c = v_dot_r * dwdr_c;
  o[3] = fwd ? v_dot_dw_q : T(0);
  o[4] = fwd ? mu : -Num<T>::big();
  o[5] = (fwd ? p.m * pi_fwd * v_dot_dw_q * T(0.5) : T(0)) +
         (rev ? p.m * pi_rev * v_dot_dw_c * T(0.5) : T(0));

  // near-field gravity correction, term 1: softened - Newtonian
  const T newt_g = inv_r * inv_r * inv_r;
  const T newt_p = -inv_r;
  T cgp = T(0), cpp = T(0);
  if (GM == GM_JOINT && gmask && sep) {
    // both corrections of a close pair, in double, rounded once
    const double d2w = d2;
    const double inv_rw = Num<double>::rsqrt(d2w);
    const double h_avgw = h_avg;
    const double newt_gw = inv_rw * inv_rw * inv_rw;
    double soft_gw, soft_pw, f, erfc_z;
    softened<double>(d2w * inv_rw, inv_rw, h_avgw, 1.0 / h_avgw, soft_gw, soft_pw);
    mesh_tail<double>(d2w, inv_rw, double(p.sigma), f, erfc_z);
    cgp = T((soft_gw - newt_gw) + f * newt_gw);
    cpp = T((soft_pw + inv_rw) - erfc_z * inv_rw);
  } else if (gmask) {
    const T q_g = r * inv_h;
    const T q2 = q_g * q_g;
    const T q3 = q2 * q_g;
    const T inv_h2 = inv_h * inv_h;
    const T inv_q = h_avg * inv_r;  // 1/q, 0 at self pairs
    T soft_g, soft_p;
    if (q_g <= T(1)) {
      soft_g = inv_h2 * inv_h * (T(4.0 / 3.0) - T(1.2) * q2 + T(0.5) * q3);
      soft_p = inv_h * (T(2.0 / 3.0) * q2 - T(0.3) * q2 * q2 + T(0.1) * q2 * q3 - T(1.4));
    } else if (q_g <= T(2)) {
      soft_g = inv_h2 *
               (T(8.0 / 3.0) * q_g - T(3) * q2 + T(1.2) * q3 - q2 * q2 * T(1.0 / 6.0) -
                T(1.0 / 15.0) * inv_q * inv_q) *
               inv_r;
      soft_p = inv_h * (T(4.0 / 3.0) * q2 - q3 + T(0.3) * q2 * q2 - q2 * q3 * T(1.0 / 30.0) -
                        T(1.6) + T(1.0 / 15.0) * inv_q);
    } else {
      soft_g = newt_g;
      soft_p = newt_p;
    }
    cgp = soft_g - newt_g;
    cpp = soft_p - newt_p;
  }
  if (GM == GM_JOINT && gmask && !sep) cpp += p.self_phi;  // the self pair's term 2
  if (GM == GM_P3M) {
    // term 2 (Newtonian - mesh shape): exp(-z^2) * erfcx polynomial
    const T z = r * p.cz;
    const T u = z * Num<T>::rcp(T(1) + z);
    T pp = T(2.3849380332e-01);
    pp = pp * u + T(-9.3397713762e-01);
    pp = pp * u + T(1.2579923862e+00);
    pp = pp * u + T(-8.1740263321e-01);
    pp = pp * u + T(4.6001262975e-01);
    pp = pp * u + T(4.3301822784e-02);
    pp = pp * u + T(-1.1974394197e-01);
    pp = pp * u + T(-1.1287916483e+00);
    pp = pp * u + T(1.0000047021e+00);
    const T e = Num<T>::exp(d2 * p.ce);
    const T erfc_z = e * pp;
    const T f = erfc_z + T(1.1283791670955126) * z * e;  // sqrt(2/pi) t e, t = sqrt2 z
    cgp += sep ? f * newt_g : T(0);
    cpp += sep ? -erfc_z * inv_r : p.self_phi;
  }
  o[6] = cgp * dx;
  o[7] = cgp * dy;
  o[8] = cgp * dz;
  o[9] = cpp;
}

// Stage slot i of the 11 input planes `src` as record p: its position and
// cull radius^2, and planes (stride s) vx vy vz h rho por2 cs 1/h, then,
// with OUT, its mask (2 marks an outlier).
template <typename T, bool OUT>
__device__ __forceinline__ void stage_record(QPos<T>* pos, T* dst, int s, int p,
                                             const T* const* src, long i) {
  const T h = src[7][i];
  pos[p] = QPos<T>{src[0][i], src[1][i], src[2][i], cull_r2(h)};
  dst[0 * s + p] = src[3][i];
  dst[1 * s + p] = src[4][i];
  dst[2 * s + p] = src[5][i];
  dst[3 * s + p] = h;
  dst[4 * s + p] = src[8][i];
  dst[5 * s + p] = src[9][i];
  dst[6 * s + p] = src[10][i];
  dst[7 * s + p] = Num<T>::rcp(h > T(0) ? h : T(1));
  if (OUT) dst[B_OUT_PLANE * s + p] = src[6][i];
}

template <typename T, bool ISO, int GM, bool OUT>
__global__ void __launch_bounds__(TILE_THREADS) phase_b_kernel(PhaseBArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NPL = OUT ? B_PLANES + 1 : B_PLANES;  // staged planes a record
  const int cap = a.cap, piece = a.piece;
  const int n_words = (a.cw + 31) / 32;
  QPos<T>* sqp = reinterpret_cast<QPos<T>*>(smem_raw);   // (cap)
  QPos<T>* scp = sqp + cap;                               // (piece)
  T* sq = reinterpret_cast<T*>(scp + piece);              // (NPL, cap)
  T* sc = sq + NPL * cap;                                 // (NPL, piece)
  T* sacc = sc + NPL * piece;                             // (10, cap) query sums
  T* wterm = sacc + 10 * cap;                             // (warps, 10, 33) pair terms
  int* slot = reinterpret_cast<int*>(wterm + TILE_WARPS * 10 * B_TERM_STRIDE);  // (cap)
  int* wqueue = slot + cap;                               // (warps, B_QUEUE) kept records
  unsigned* rowbits = reinterpret_cast<unsigned*>(wqueue + TILE_WARPS * B_QUEUE);  // (n_words)
  int* wpre = reinterpret_cast<int*>(rowbits + n_words);  // (n_words + 1)
  __shared__ int wcount[TILE_WARPS];

  const long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T big = Num<T>::big();

  // the row's occupied queries, compacted; zeros and -max elsewhere
  const long qi = row * cap + tid;
  const bool qon = tid < cap && a.q[6][qi] > T(0);
  if (tid < cap && !qon) {
#pragma unroll
    for (int f = 0; f < 10; ++f) a.out[f][qi] = f == 4 ? -big : T(0);
  }
  int nq = 0;
  const int kq = compact_slot(qon, nq, wcount);
  if (nq == 0) return;  // uniform over the CTA
  if (qon) {
    stage_record<T, OUT>(sqp, sq, cap, kq, a.q, qi);
    slot[kq] = tid;
  }
  for (int e = tid; e < 10 * cap; e += TILE_THREADS) sacc[e] = e / cap == 4 ? -big : T(0);

  // the row's occupancy as bits (all mask loads in flight together), then
  // the exclusive prefix of their counts: record wpre[w] + rank is slot
  // 32 w + its bit
  const long c_row = row * a.cw;
  for (int j0 = 0; j0 < a.cw; j0 += B_ROUNDS * TILE_THREADS) {
    bool occ[B_ROUNDS];
#pragma unroll
    for (int u = 0; u < B_ROUNDS; ++u) {
      const int j = j0 + u * TILE_THREADS + tid;
      occ[u] = j < a.cw && a.c[6][c_row + j] > T(0);
    }
#pragma unroll
    for (int u = 0; u < B_ROUNDS; ++u) {
      const unsigned bits = __ballot_sync(0xffffffffu, occ[u]);
      const int w = (j0 + u * TILE_THREADS) / 32 + warp;
      if (lane == 0 && w < n_words) rowbits[w] = bits;
    }
  }
  __syncthreads();
  int nc_row = 0;
  for (int w0 = 0; w0 < n_words; w0 += TILE_THREADS) {
    const int w = w0 + tid;
    const int v = w < n_words ? __popc(rowbits[w]) : 0;
    const int pos = compact_count(v, nc_row, wcount);
    if (w < n_words) wpre[w] = pos;
  }
  if (tid == 0) wpre[n_words] = nc_row;
  __syncthreads();

  BParams<T> p;
  p.m = a.scal[0];
  p.alpha = a.scal[1];
  p.beta = a.scal[2];
  p.sigma = a.scal[3];
  p.cz = T(0.7071067811865476) / p.sigma;
  p.ce = T(-0.5) / (p.sigma * p.sigma);
  p.self_phi = T(0.7978845608028654) / p.sigma;
  const bool keep_all = GM == GM_P3M || a.keep_all != 0;
  int* queue = wqueue + warp * B_QUEUE;
  T* term = wterm + warp * 10 * B_TERM_STRIDE;
  const unsigned below = (1u << lane) - 1u;

  for (int p0 = 0; p0 < nc_row; p0 += piece) {
    // a piece: records p0 ... p0 + n_here - 1, in slot order
    const int n_here = min(piece, nc_row - p0);
    // its raw slots are words w_lo ... w_end - 1: a thread a slot, every
    // load of a few slots in flight together
    auto upper = [&](int v) {  // the first word w with wpre[w] > v
      int lo = 0, hi = n_words;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (wpre[mid] > v) hi = mid;
        else lo = mid + 1;
      }
      return lo;
    };
    const int w_lo = upper(p0) - 1, w_end = upper(p0 + n_here - 1);
#pragma unroll 4
    for (int j = 32 * w_lo + tid; j < 32 * w_end; j += TILE_THREADS) {
      const unsigned bits = rowbits[j >> 5];
      const int rec = wpre[j >> 5] + __popc(bits & ((1u << (j & 31)) - 1u)) - p0;
      if (((bits >> (j & 31)) & 1u) && rec >= 0 && rec < n_here)
        stage_record<T, OUT>(scp, sc, piece, rec, a.c, c_row + j);
    }
    const int nw = (n_here + 31) / 32;
    if (tid < 64 * ((nw + 1) / 2) - n_here) scp[n_here + tid] = QPos<T>{big, big, big, T(-1)};
    __syncthreads();

    // each warp its queries: the piece's records tested two words a step,
    // the kept ones queued in record order; 32 queued pairs (or the rest at
    // the end) are evaluated one a lane, and lane f < 10 adds their term f
    // to the query's sum in queue order
    for (int k = warp; k < nq; k += TILE_WARPS) {
      const QPos<T> q = sqp[k];
      T acc = lane < 10 ? sacc[lane * cap + k] : T(0);
      auto flush = [&](int n) {
        __syncwarp();
        if (lane < n) {
          const int j = queue[lane];
          T o[10];
          pair_terms<T, ISO, GM, OUT>(q, sq, cap, k, scp[j], sc, piece, j, p, o);
#pragma unroll
          for (int f = 0; f < 10; ++f) term[f * B_TERM_STRIDE + lane] = o[f];
        }
        __syncwarp();
        if (lane < 10) {
          const T* t = term + lane * B_TERM_STRIDE;  // lanes on distinct banks
          if (n == 32) {
#pragma unroll
            for (int l = 0; l < 32; ++l) acc = lane == 4 ? (t[l] > acc ? t[l] : acc) : acc + t[l];
          } else {
            for (int l = 0; l < n; ++l) acc = lane == 4 ? (t[l] > acc ? t[l] : acc) : acc + t[l];
          }
        }
      };
      int qn = 0;
      for (int w = 0; w < nw; w += 2) {  // two words a step, both in flight
        const int j0 = 32 * w + lane, j1 = j0 + 32;
        bool in0, in1;
        if (keep_all) {
          in0 = j0 < n_here;
          in1 = j1 < n_here;
        } else {
          const QPos<T> c0 = scp[j0], c1 = scp[j1];
          const T x0 = q.x - c0.x, y0 = q.y - c0.y, z0 = q.z - c0.z;
          const T x1 = q.x - c1.x, y1 = q.y - c1.y, z1 = q.z - c1.z;
          in0 = x0 * x0 + y0 * y0 + z0 * z0 <= max(q.cull, c0.cull);
          in1 = x1 * x1 + y1 * y1 + z1 * z1 <= max(q.cull, c1.cull);
        }
        const unsigned b0 = __ballot_sync(0xffffffffu, in0);
        const unsigned b1 = __ballot_sync(0xffffffffu, in1);
        if ((b0 | b1) == 0u) continue;  // most steps keep nothing
        if (in0) queue[qn + __popc(b0 & below)] = j0;
        qn += __popc(b0);
        if (in1) queue[qn + __popc(b1 & below)] = j1;
        qn += __popc(b1);
        while (qn >= 32) {
          flush(32);
          __syncwarp();
          if (lane < qn - 32) queue[lane] = queue[32 + lane];
          if (lane + 32 < qn - 32) queue[lane + 32] = queue[64 + lane];
          qn -= 32;
        }
      }
      if (qn > 0) flush(qn);
      if (lane < 10) sacc[lane * cap + k] = acc;
      __syncwarp();
    }
    __syncthreads();  // the piece's records are overwritten next
  }

  for (int e = tid; e < 10 * nq; e += TILE_THREADS) {
    const int f = e / nq, k = e % nq;
    const bool times_m = f == 3 || f >= 6;
    const T v = sacc[f * cap + k];
    a.out[f][row * cap + slot[k]] = times_m ? p.m * v : v;
  }
}

template <typename T, bool ISO, int GM, bool OUT>
int launch_phase_b(const PhaseBArgs<T>& a, int n_cells, cudaStream_t stream) {
  const size_t smem = phase_b_smem<T>(a.cap, a.cw, a.piece, OUT ? B_PLANES + 1 : B_PLANES);
  const int err = fits_one_cta(phase_b_kernel<T, ISO, GM, OUT>, TILE_THREADS, smem);
  if (err) return err;
  SPH_LAUNCH((phase_b_kernel<T, ISO, GM, OUT>), n_cells, TILE_THREADS, smem, stream, a);
  return int(cudaGetLastError());
}

template <typename T, bool ISO, bool OUT>
int launch_phase_b_gm(const PhaseBArgs<T>& a, int gm, int n_cells, cudaStream_t stream) {
  if (gm == GM_JOINT) return launch_phase_b<T, ISO, GM_JOINT, OUT>(a, n_cells, stream);
  if constexpr (!OUT) {
    if (gm == GM_P3M) return launch_phase_b<T, ISO, GM_P3M, OUT>(a, n_cells, stream);
  }
  return launch_phase_b<T, ISO, GM_NEAR, OUT>(a, n_cells, stream);
}

template <typename T>
int phase_b_from_ptrs(void* const* qp, void* const* cp, const void* scal, void* const* op,
                      int n_cells, int cap, int cw, int iso, int gm, int outlier, int piece,
                      int keep_all, cudaStream_t stream) {
  if (n_cells <= 0) return 0;
  if (cap > B_MAX_CAP || cw > B_MAX_CW || piece < 64 || piece % 64 != 0 || piece > 1 << 16)
    return ERR_BUDGET;
  // gm: GM_NEAR, GM_P3M or GM_JOINT; the outlier masks take GM_NEAR or GM_JOINT
  if (gm < GM_NEAR || gm > GM_JOINT || (outlier && gm == GM_P3M)) return ERR_BUDGET;
  PhaseBArgs<T> a;
  for (int k = 0; k < 11; ++k) {
    a.q[k] = static_cast<const T*>(qp[k]);
    a.c[k] = static_cast<const T*>(cp[k]);
  }
  for (int k = 0; k < 10; ++k) a.out[k] = static_cast<T*>(op[k]);
  a.scal = static_cast<const T*>(scal);
  a.cap = cap;
  a.cw = cw;
  a.piece = piece;
  a.keep_all = keep_all;
  if (outlier) {
    return iso ? launch_phase_b_gm<T, true, true>(a, gm, n_cells, stream)
               : launch_phase_b_gm<T, false, true>(a, gm, n_cells, stream);
  }
  return iso ? launch_phase_b_gm<T, true, false>(a, gm, n_cells, stream)
             : launch_phase_b_gm<T, false, false>(a, gm, n_cells, stream);
}

}  // namespace sph

// q, c: 11 device pointers each (x y z vx vy vz mask h rho por2 cs); scal:
// device pointer to (m, alpha, beta, sigma); out: 10 device pointers; gm:
// the gravity mode, 0 term 1 only, 1 term 1 + term 2 on every pair, 2 the
// joint term inside the mask; outlier: 1 applies the outlier masks (a mask
// of 2 marks an outlier's slot); piece: candidate records a piece (a
// multiple of 64); keep_all: 1 keeps every occupied pair (no cull). Returns
// ERR_BUDGET for cap > 256, cw > 27 * 256, the outlier masks with gm 1, or
// where the shared memory does not fit one CTA.
extern "C" int sph_phase_b_tiles(void* const* q, void* const* c, const void* scal,
                                 void* const* out, int n_cells, int cap, int cw, int iso,
                                 int gm, int outlier, int piece, int keep_all, int is_double,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::phase_b_from_ptrs<double>(q, c, scal, out, n_cells, cap, cw, iso, gm,
                                                    outlier, piece, keep_all, s)
                   : sph::phase_b_from_ptrs<float>(q, c, scal, out, n_cells, cap, cw, iso, gm,
                                                   outlier, piece, keep_all, s);
}
