// phase_b_grouped / phase_b_blocks: the block engine's phase B, pair forces
// + gravity corrections in the ball owner's sweep.
//
// Replaces two TPU kernels that compute the same pair terms on different
// layouts: sphtpu/kernels/pallas_grouped_pairs.py::phase_b_grouped
// (_kernel; every capacity bucket in one launch: a flat list of (BQ, CW)
// chunks, chunk i querying packed-query block qblk[i], a block's chunks
// consecutive) and sphtpu/kernels/pallas_block_pairs.py::phase_b_blocks
// (_kernel; one bucket, (nb, BQ) queries against (nb, C_b) candidates).
// Two kernels, one for each (`unit_kernel` and `block_unit_kernel`), share
// the pair algebra (one device function, `pair_terms`) and the work-unit
// machinery below (`unit_pieces`, templated on the candidate layout).
//
// Pair semantics (exactly the Pallas kernels'): forward mask d2 <= (2 h_q)^2;
// the owner's kernel gradient and the owner's sound speed in Pi; the
// division-diet algebra on inv_r = rsqrt(d2) (self pairs: 1/r -> 0);
// polytropic coefficient symmetric, isothermal asymmetric; gravity
// corrections (softened - Newtonian for r <= 2 h_avg, plus Newtonian - mesh
// shape under P3M; a pair that takes both has their sum taken in double)
// carry two-sided ownership weights w = 1/2 when both rows see the pair
// (r <= max(2h, r_c) on each side), 1 when only the query does.
// Outputs: ten query-side reductions per query row (ax ay az = -sum coeff d,
// div, mu_max — a MAX, init -max — visc, gx gy gz gphi) and eight
// candidate-side sums per candidate slot (sax say saz = +sum coeff d, svisc,
// sgx sgy sgz = -m sum w cgp d, sgp = m sum w cpp), which the caller adds
// into particle rows with one scatter-add.
//
// Bound on this card: the bytes of the candidate stack on the collapse
// path (d2 and one compare against the query's visibility radius on every
// (query, occupied candidate) pair; the body only on the pairs inside it:
// ~kh of them a query under exact gravity, ~1 % of the pairs).
//
// K5's design (`unit_kernel`): the grid is a list of WORK UNITS of equal
// size, not one CTA a query block: a unit is one query block of GQ = 128
// rows against a run of at most U slots of that block's chunks (the
// wrapper's table, numbered in the block's chunk order), so a bucket of
// 64-chunk blocks spreads over the card like a bucket of 1-chunk ones. A
// unit stages its slots GSUB = 256 at a time; each thread owns one slot.
// The piece is TESTED ONCE: warp w takes the 32 slots of bit-word w,
// first culls whole queries whose visibility ball misses the bounding box
// of the warp's occupied slots (a conservative test with a 2^-8 margin on
// the radius), then computes d2 and the test for the remaining (query,
// slot) pairs and keeps the warp's ballot as word w of the query's row in
// a (GQ x 8)-word bitmask. The kept pairs, numbered in query-major order
// (a scan of the rows' bit counts), are then EVALUATED ONCE each, GPAIRS
// at a time, one pair a thread, their 10 terms kept in shared memory; the
// query-side sums take each query's pairs in slot order (thread k), the
// candidate-side sums each slot's pairs in query order (thread j), both in
// fixed order. Candidate-side sums go straight to their slots: every slot
// belongs to one unit. Query-side sums are per-unit partials (GQ x 10 a
// unit) that `combine_kernel` adds in unit order (mu_max by max). No
// output uses an atomic, so two launches on the same inputs give the same
// bits.
// K6 (`block_unit_kernel` + `block_combine_kernel`, one bucket a launch)
// runs the same units on its own layout: ten (nb, cw) planes read where
// they lie (`RowPlanes`; K5's stack is `ChunkStack`). A unit is one staged
// piece: a launch holds one bucket, often of a handful of blocks, and K5's
// U = 2048 left most of the card idle. Every block of a bucket has the same
// cw, so the split is static and needs no table: block b's unit j takes
// the slots [j GSUB, min((j + 1) GSUB, cw)), and the grid is nb n_u CTAs,
// n_u = max(1, ceil(cw / GSUB)) (`sph_phase_b_blocks_units`). Any cw >= 1
// (the last piece may be partial). `block_combine_kernel`, one CTA a
// (block, output), adds the partials in unit order, as K5's does.
#include "common.cuh"

namespace sph {

constexpr int GQ = 128;                                  // query rows a block (the planner's BQ)
constexpr int GCW = 512;                                 // slots a chunk of the grouped layout
constexpr int GSUB = TILE_THREADS;                       // candidate slots staged at a time
constexpr int GWORDS = GSUB / 32;                        // bit-words of a query's row a piece
constexpr int GGROUPS = GQ / 32;                         // 32-query groups of a block

template <typename T>
struct PairParams {
  T m, alpha, beta, sigma, r_c;
};

// fields of an occupied query row
template <typename T>
struct QRow {
  T x, y, z, vx, vy, vz, h, rho, por2, cs;
};

// fields of an occupied candidate slot
template <typename T>
struct CRow {
  T x, y, z, vx, vy, vz, h, rho, por2;
};

template <typename T>
struct PairOut {
  T cdx, cdy, cdz;  // coeff * d: the query adds -, the candidate +
  T div;            // forward v . grad W (times m at the end)
  T mu;             // forward mu, else -max
  T visc;           // m Pi v . grad W / 2 on the forward mask (both sides)
  T gwx, gwy, gwz;  // w cgp d
  T cpw;            // w cpp
};

// The pair terms of one occupied (query, candidate) pair. Returns false when
// the pair adds nothing to any output: outside the query's forward ball and
// its visibility radius max(2 h_q, r_c) (the prefilter is conservative; the
// exact masks follow).
template <typename T, bool ISO, bool P3M>
__device__ __forceinline__ bool pair_terms(const QRow<T>& q, const CRow<T>& c,
                                           const PairParams<T>& p, PairOut<T>& o) {
  const T dx = q.x - c.x;
  const T dy = q.y - c.y;
  const T dz = q.z - c.z;
  const T d2 = dist2<T>(dx, dy, dz);
  const T two_hq = T(2) * q.h;
  const T qrk2 = Num<T>::mul_rn(two_hq, two_hq);
  const T vq_r = two_hq > p.r_c ? two_hq : p.r_c;
  if (d2 > qrk2 && d2 > vq_r * vq_r * T(1.0009765625)) return false;

  const bool sep = d2 > T(0);
  const T inv_r = sep ? Num<T>::rsqrt(d2) : T(0);  // self pairs: 1/r -> 0
  const T r = d2 * inv_r;
  const bool fwd = d2 <= qrk2;

  const T h_q = q.h > T(0) ? q.h : T(1);
  const T h_c = c.h > T(0) ? c.h : T(1);
  const T h_avg = T(0.5) * (h_q + h_c);
  const T inv_h = T(1) / h_avg;
  const T rho_avg = T(0.5) * (q.rho + c.rho);

  const T v_dot_r = (q.vx - c.vx) * dx + (q.vy - c.vy) * dy + (q.vz - c.vz) * dz;
  T mu = h_avg * v_dot_r * (T(1) / (d2 + T(0.01) * h_avg * h_avg));
  mu = mu < T(0) ? mu : T(0);
  const T pi_own = (-p.alpha * q.cs * mu + p.beta * mu * mu) * (T(1) / rho_avg);

  const T inv_hq = T(1) / h_q;
  const T inv_hq2 = inv_hq * inv_hq;
  const T ct_w = (T(1) / T(3.14159265358979323846)) * inv_hq2 * inv_hq2;
  const T q_w = r * inv_hq;
  const T two_q = T(2) - q_w;
  const T dwdr_q = q_w <= T(1) ? ct_w * (T(2.25) * r * inv_hq2 - T(3) * inv_hq)
                               : (q_w <= T(2) ? ct_w * (T(-0.75) * (two_q * two_q)) * inv_r : T(0));
  const T ct_own = ISO ? p.m * (q.por2 + pi_own / T(2)) : p.m * (q.por2 + c.por2 + pi_own) / T(2);

  const T coeff = fwd ? ct_own * dwdr_q : T(0);
  o.cdx = coeff * dx;
  o.cdy = coeff * dy;
  o.cdz = coeff * dz;
  const T v_dot_dw_q = v_dot_r * dwdr_q;
  o.div = fwd ? v_dot_dw_q : T(0);
  o.mu = fwd ? mu : -Num<T>::big();
  o.visc = fwd ? p.m * pi_own * v_dot_dw_q / T(2) : T(0);

  // gravity corrections: softened - Newtonian for r <= 2 h_avg, plus
  // Newtonian - mesh shape under P3M
  const T newt_g = inv_r * inv_r * inv_r;
  const T newt_p = -inv_r;
  T cgp = T(0), cpp = T(0);
  const bool near = r <= T(2) * h_avg;
  if (P3M && near && sep) {
    // the pair takes both corrections, whose 1/r^3 (and 1/r) parts cancel:
    // for a pair far inside sigma their float sum has no correct digit, so
    // the reference's terms, in its order, are summed in double and rounded
    // once (the plain version likewise)
    const double d2w = d2;
    const double inv_rw = Num<double>::rsqrt(d2w);
    const double h_avgw = h_avg;
    const double newt_gw = inv_rw * inv_rw * inv_rw;
    double soft_g, soft_p, f, erfc_z;
    softened<double>(d2w * inv_rw, inv_rw, h_avgw, 1.0 / h_avgw, soft_g, soft_p);
    mesh_tail<double>(d2w, inv_rw, double(p.sigma), f, erfc_z);
    cgp = T((soft_g - newt_gw) + f * newt_gw);
    cpp = T((soft_p + inv_rw) - erfc_z * inv_rw);
  } else {
    if (near) {
      T soft_g, soft_p;
      softened<T>(r, inv_r, h_avg, inv_h, soft_g, soft_p);
      cgp = soft_g - newt_g;
      cpp = soft_p - newt_p;
    }
    if (P3M) {
      T f, erfc_z;
      mesh_tail<T>(d2, inv_r, p.sigma, f, erfc_z);
      cgp += sep ? f * newt_g : T(0);
      cpp += sep ? -erfc_z * inv_r : T(0.7978845608028654) / p.sigma;
    }
  }
  const T two_hc = T(2) * c.h;
  const T vc_r = two_hc > p.r_c ? two_hc : p.r_c;
  const T w = r <= vq_r ? (r <= vc_r ? T(0.5) : T(1)) : T(0);
  const T cgw = w * cgp;
  o.gwx = cgw * dx;
  o.gwy = cgw * dy;
  o.gwz = cgw * dz;
  o.cpw = w * cpp;
  return true;
}

// ---------------------------------------------------------------------------
// The piece machinery of K5 and K6: work units, one test a pair, fixed-order
// sums (`unit_pieces`), on either candidate layout

// A query's position and the square of the radius its pairs are tested
// against: max((2 h)^2, (max(2 h, r_c))^2 (1 + 2^-10)), exactly the
// comparisons of pair_terms' prefilter; -1 for a masked-off row.
template <typename T>
struct alignas(4 * sizeof(T)) QPos {
  T x, y, z, thr;
};

// The query side of a launch.
template <typename T>
struct QueryBlocks {
  const T* q[11];  // (NB, GQ) each: x y z vx vy vz mask h rho por2 cs
  T* qout[10];     // (NB, GQ) each: ax ay az div mu_max visc gx gy gz gphi
  const T* scal;   // m alpha beta sigma r_c on the device
  T* qpart;        // (n_units, 10, GQ) query-side partials
};

// Candidate layouts: where slot s of a launch keeps its 10 fields (x y z vx
// vy vz h rho por2 mask) and its 8 sums. PARTIAL: a unit's last staged
// piece may end before GSUB slots.
// K5's: the chunk-major stack (n_chunks, 10, GCW) and sums (n_chunks, 8,
// GCW); a unit is whole chunks.
template <typename T>
struct ChunkStack {
  static constexpr bool PARTIAL = false;
  const T* cstack;
  T* cout;
  __device__ __forceinline__ void load(long s, T* f) const {
    const T* src = cstack + (s / GCW) * 10 * GCW + s % GCW;
#pragma unroll
    for (int k = 0; k < 10; ++k) f[k] = src[k * GCW];
  }
  __device__ __forceinline__ void store(long s, const T* out) const {
    T* dst = cout + (s / GCW) * 8 * GCW + s % GCW;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k * GCW] = out[k];
  }
};

// K6's: ten row-major (nb, cw) planes and eight such sums; block b's slot j
// is s = b cw + j.
template <typename T>
struct RowPlanes {
  static constexpr bool PARTIAL = true;
  const T* c[10];
  T* cout[8];
  __device__ __forceinline__ void load(long s, T* f) const {
#pragma unroll
    for (int k = 0; k < 10; ++k) f[k] = c[k][s];
  }
  __device__ __forceinline__ void store(long s, const T* out) const {
#pragma unroll
    for (int k = 0; k < 8; ++k) cout[k][s] = out[k];
  }
};

template <typename T>
__device__ __forceinline__ PairParams<T> load_params(const T* scal) {
  PairParams<T> p;
  p.m = scal[0];
  p.alpha = scal[1];
  p.beta = scal[2];
  p.sigma = scal[3];
  p.r_c = scal[4];
  return p;
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

// Distance from q to the interval [lo, hi] along one axis (0 inside).
template <typename T>
__device__ __forceinline__ T gap(T q, T lo, T hi) {
  const T d = lo - q > q - hi ? lo - q : q - hi;
  return d > T(0) ? d : T(0);
}

// Surviving pairs a unit evaluates at a time (its dynamic shared memory:
// their 10 pair terms and their (query, slot) ids).
constexpr int GPAIRS = 512;

template <typename T>
size_t unit_smem() {
  return size_t(GPAIRS) * (10 * sizeof(T) + sizeof(int));
}

// One work unit: query block b of `qb` against the slots [s_begin, s_end)
// of the layout `cand`, GSUB at a time, as the design note above says.
// Writes each of those slots' 8 sums through `cand`; returns in `sums` the
// query-side sums of query threadIdx.x (threads < GQ) over the unit.
template <typename T, bool ISO, bool P3M, typename L>
__device__ __forceinline__ void unit_pieces(const QueryBlocks<T>& qb, const L& cand, long b,
                                            long s_begin, long s_end, T (&sums)[10]) {
  __shared__ QPos<T> sqp[GQ];                 // the block's query positions and test radii
  __shared__ T sqf[7][GQ];                    // vx vy vz h rho por2 cs
  __shared__ T sc[10][GSUB];                  // a staged piece: x y z vx vy vz h rho por2 mask
  __shared__ unsigned qbits[GWORDS][GQ];      // bit l of [w][k]: query k keeps slot 32 w + l
  __shared__ unsigned short pre[GWORDS][GQ];  // query k's kept pairs in words before w
  __shared__ int rowstart[GQ + 1];            // query k's first pair in query-major order
  __shared__ int wtotal[GQ / 32];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* po = reinterpret_cast<T*>(smem_raw);     // (10, GPAIRS) pair terms of a batch
  int* plist = reinterpret_cast<int*>(po + 10 * GPAIRS);  // (GPAIRS) query << 8 | slot

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T big = Num<T>::big();
  const PairParams<T> p = load_params(qb.scal);

  bool on = false;
  if (tid < GQ) {
    const long qi = b * GQ + tid;
    const T h = qb.q[7][qi];
    const T two_h = T(2) * h;
    const T qrk2 = Num<T>::mul_rn(two_h, two_h);
    const T vq_r = two_h > p.r_c ? two_h : p.r_c;
    const T vis2 = vq_r * vq_r * T(1.0009765625);
    on = qb.q[6][qi] > T(0);
    sqp[tid] = QPos<T>{qb.q[0][qi], qb.q[1][qi], qb.q[2][qi],
                       on ? (qrk2 > vis2 ? qrk2 : vis2) : T(-1)};
    sqf[0][tid] = qb.q[3][qi];
    sqf[1][tid] = qb.q[4][qi];
    sqf[2][tid] = qb.q[5][qi];
    sqf[3][tid] = h;
    sqf[4][tid] = qb.q[8][qi];
    sqf[5][tid] = qb.q[9][qi];
    sqf[6][tid] = qb.q[10][qi];
  }
  const bool any_query = __syncthreads_or(on);

  // the thread's slot of the next piece, loaded one piece ahead (past the
  // unit's end: zeros, an empty slot)
  auto fetch = [&](long s, T* f) {
    if (!L::PARTIAL || s < s_end) {
      cand.load(s, f);
    } else {
#pragma unroll
      for (int k = 0; k < 10; ++k) f[k] = T(0);
    }
  };
  T f[10];
  if (any_query) fetch(s_begin + tid, f);

  // query-side sums of query tid (threads < GQ), over the unit's pieces
  T ax = T(0), ay = T(0), az = T(0), dv = T(0), visc = T(0);
  T gx = T(0), gy = T(0), gz = T(0), gp = T(0), mumax = -big;

  for (long s0 = s_begin; s0 < s_end; s0 += GSUB) {
    const long s = s0 + tid;  // this thread's slot
    T sax = T(0), say = T(0), saz = T(0), svisc = T(0);
    T sgx = T(0), sgy = T(0), sgz = T(0), sgp = T(0);
    if (any_query) {
      const T cx = f[0], cy = f[1], cz = f[2];
      const bool cvalid = f[9] > T(0);
#pragma unroll
      for (int k = 0; k < 10; ++k) sc[k][tid] = f[k];
      if (s0 + GSUB < s_end) fetch(s + GSUB, f);

      // the test: the bounding box of the warp's occupied slots (empty:
      // [big, -big], which no ball reaches), the queries whose ball may
      // reach it, d2 for those, two at a time
      const T lox = warp_min(cvalid ? cx : big), hix = warp_max(cvalid ? cx : -big);
      const T loy = warp_min(cvalid ? cy : big), hiy = warp_max(cvalid ? cy : -big);
      const T loz = warp_min(cvalid ? cz : big), hiz = warp_max(cvalid ? cz : -big);
      unsigned hit[GGROUPS];
#pragma unroll
      for (int g = 0; g < GGROUPS; ++g) {
        qbits[warp][32 * g + lane] = 0u;
        const QPos<T> q = sqp[32 * g + lane];
        const T ex = gap(q.x, lox, hix), ey = gap(q.y, loy, hiy), ez = gap(q.z, loz, hiz);
        const T bd2 = ex * ex + ey * ey + ez * ez;
        unsigned maybe = __ballot_sync(0xffffffffu, q.thr >= T(0) && bd2 <= q.thr * T(1.00390625));
        hit[g] = 0u;
        __syncwarp();
        while (maybe) {
          const int l0 = __ffs(maybe) - 1;
          maybe &= maybe - 1u;
          const bool two = maybe != 0u;
          const int l1 = two ? __ffs(maybe) - 1 : l0;
          maybe &= two ? maybe - 1u : ~0u;
          const QPos<T> q0 = sqp[32 * g + l0], q1 = sqp[32 * g + l1];
          const T d0 = dist2<T>(q0.x - cx, q0.y - cy, q0.z - cz);
          const T d1 = dist2<T>(q1.x - cx, q1.y - cy, q1.z - cz);
          const unsigned b0 = __ballot_sync(0xffffffffu, cvalid && d0 <= q0.thr);
          const unsigned b1 = __ballot_sync(0xffffffffu, two && cvalid && d1 <= q1.thr);
          if (lane == 0) {
            qbits[warp][32 * g + l0] = b0;
            if (two) qbits[warp][32 * g + l1] = b1;
          }
          hit[g] |= (b0 ? (1u << l0) : 0u) | (b1 ? (1u << l1) : 0u);
        }
      }
      __syncthreads();

      // the kept pairs in query-major order: query k's pairs start at
      // rowstart[k], its word w's at rowstart[k] + pre[w][k]
      int n_row = 0, start = 0;
      if (tid < GQ) {
#pragma unroll
        for (int w = 0; w < GWORDS; ++w) {
          pre[w][tid] = static_cast<unsigned short>(n_row);
          n_row += __popc(qbits[w][tid]);
        }
        int incl = n_row;  // inclusive scan over the warp's 32 queries
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          incl += lane >= o ? v : 0;
        }
        if (lane == 31) wtotal[warp] = incl;
        start = incl - n_row;
      }
      __syncthreads();
      if (tid < GQ) {
        for (int w = 0; w < warp; ++w) start += wtotal[w];
        rowstart[tid] = start;
        if (tid == GQ - 1) rowstart[GQ] = start + n_row;
      }
      __syncthreads();
      const int n_pairs = rowstart[GQ];

      // batches of GPAIRS pairs: list them, evaluate each pair ONCE, then
      // sum query-major (thread k: its pairs in slot order) and
      // candidate-major (thread j: its pairs in query order)
      for (int i0 = 0; i0 < n_pairs; i0 += GPAIRS) {
        const int i1 = min(i0 + GPAIRS, n_pairs);
#pragma unroll
        for (int c = tid; c < GQ * GWORDS; c += TILE_THREADS) {
          const int k = c / GWORDS, w = c % GWORDS;
          unsigned bits = qbits[w][k];
          int pos = rowstart[k] + pre[w][k];
          if (bits == 0u || pos >= i1 || pos + __popc(bits) <= i0) continue;
          while (bits) {
            const int l = __ffs(bits) - 1;
            bits &= bits - 1u;
            if (pos >= i0 && pos < i1) plist[pos - i0] = (k << 8) | (32 * w + l);
            ++pos;
          }
        }
        __syncthreads();
        for (int i = tid; i < i1 - i0; i += TILE_THREADS) {
          const int k = plist[i] >> 8, j = plist[i] & 255;
          const QPos<T> qp = sqp[k];
          const QRow<T> q = {qp.x, qp.y, qp.z, sqf[0][k], sqf[1][k], sqf[2][k],
                             sqf[3][k], sqf[4][k], sqf[5][k], sqf[6][k]};
          const CRow<T> cj = {sc[0][j], sc[1][j], sc[2][j], sc[3][j], sc[4][j],
                              sc[5][j], sc[6][j], sc[7][j], sc[8][j]};
          PairOut<T> o;
          if (!pair_terms<T, ISO, P3M>(q, cj, p, o)) {  // cannot happen: the bit was set
            o = PairOut<T>{T(0), T(0), T(0), T(0), -big, T(0), T(0), T(0), T(0), T(0)};
          }
          po[0 * GPAIRS + i] = o.cdx;
          po[1 * GPAIRS + i] = o.cdy;
          po[2 * GPAIRS + i] = o.cdz;
          po[3 * GPAIRS + i] = o.div;
          po[4 * GPAIRS + i] = o.mu;
          po[5 * GPAIRS + i] = o.visc;
          po[6 * GPAIRS + i] = o.gwx;
          po[7 * GPAIRS + i] = o.gwy;
          po[8 * GPAIRS + i] = o.gwz;
          po[9 * GPAIRS + i] = o.cpw;
        }
        __syncthreads();
        if (tid < GQ) {
          const int lo = max(rowstart[tid], i0) - i0, hi = min(rowstart[tid + 1], i1) - i0;
          for (int i = lo; i < hi; ++i) {
            ax -= po[0 * GPAIRS + i];
            ay -= po[1 * GPAIRS + i];
            az -= po[2 * GPAIRS + i];
            dv += po[3 * GPAIRS + i];
            mumax = po[4 * GPAIRS + i] > mumax ? po[4 * GPAIRS + i] : mumax;
            visc += po[5 * GPAIRS + i];
            gx += po[6 * GPAIRS + i];
            gy += po[7 * GPAIRS + i];
            gz += po[8 * GPAIRS + i];
            gp += po[9 * GPAIRS + i];
          }
        }
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int g = 0; g < GGROUPS; ++g) {
          unsigned hm = hit[g];  // the same in the whole warp
          while (hm) {
            const int k = 32 * g + __ffs(hm) - 1;
            hm &= hm - 1u;
            const unsigned bits = qbits[warp][k];
            const int i = rowstart[k] + pre[warp][k] + __popc(bits & below) - i0;
            if (!((bits >> lane) & 1u) || i < 0 || i >= i1 - i0) continue;
            sax += po[0 * GPAIRS + i];
            say += po[1 * GPAIRS + i];
            saz += po[2 * GPAIRS + i];
            svisc += po[5 * GPAIRS + i];
            sgx += po[6 * GPAIRS + i];
            sgy += po[7 * GPAIRS + i];
            sgz += po[8 * GPAIRS + i];
            sgp += po[9 * GPAIRS + i];
          }
        }
        __syncthreads();  // the batch's list and terms are overwritten next
      }
    }
    if (!L::PARTIAL || s < s_end) {
      const T out[8] = {sax, say, saz, svisc, -p.m * sgx, -p.m * sgy, -p.m * sgz, p.m * sgp};
      cand.store(s, out);
    }
  }
  sums[0] = ax;
  sums[1] = ay;
  sums[2] = az;
  sums[3] = dv;
  sums[4] = mumax;
  sums[5] = visc;
  sums[6] = gx;
  sums[7] = gy;
  sums[8] = gz;
  sums[9] = gp;
}

// Query-side output f of block b: the partials of its units [u0, u1) added
// in unit order (mu_max by max), then m applied where the sum carries it.
// Thread k: query k.
template <typename T>
__device__ __forceinline__ void combine_field(const QueryBlocks<T>& qb, long b, int f, int u0,
                                              int u1) {
  const int k = threadIdx.x;
  T v = f == 4 ? -Num<T>::big() : T(0);
#pragma unroll 4
  for (int u = u0; u < u1; ++u) {
    const T x = qb.qpart[(long(u) * 10 + f) * GQ + k];
    v = f == 4 ? (x > v ? x : v) : v + x;
  }
  const bool times_m = f == 3 || f >= 6;
  qb.qout[f][b * GQ + k] = times_m ? qb.scal[0] * v : v;
}

// ---------------------------------------------------------------------------
// K5: every bucket in one launch, the wrapper's table of work units

template <typename T>
struct UnitArgs {
  QueryBlocks<T> qb;
  ChunkStack<T> cand;
  const int* units;   // (n_units, 3): query block, first chunk, chunks
  const int* ustart;  // (NB + 1): block b owns units [ustart[b], ustart[b + 1])
};

template <typename T, bool ISO, bool P3M>
__global__ void __launch_bounds__(TILE_THREADS) unit_kernel(UnitArgs<T> a) {
  const long u = blockIdx.x;
  const long s_begin = long(a.units[3 * u + 1]) * GCW;
  T sums[10];
  unit_pieces<T, ISO, P3M>(a.qb, a.cand, a.units[3 * u], s_begin,
                           s_begin + long(a.units[3 * u + 2]) * GCW, sums);
  if (threadIdx.x < GQ) {
    T* part = a.qb.qpart + u * 10 * GQ + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 10; ++k) part[k * GQ] = sums[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(GQ) combine_kernel(UnitArgs<T> a) {
  const long b = blockIdx.x;
#pragma unroll
  for (int f = 0; f < 10; ++f) combine_field(a.qb, b, f, a.ustart[b], a.ustart[b + 1]);
}

template <typename T, bool ISO, bool P3M>
int launch_units(const UnitArgs<T>& a, int nb, int n_units, cudaStream_t stream) {
  int err = fits_one_cta(unit_kernel<T, ISO, P3M>, TILE_THREADS, unit_smem<T>());
  if (err) return err;
  err = fits_one_cta(combine_kernel<T>, GQ, 0);
  if (err) return err;
  if (n_units > 0)
    SPH_LAUNCH((unit_kernel<T, ISO, P3M>), n_units, TILE_THREADS, unit_smem<T>(), stream, a);
  SPH_LAUNCH((combine_kernel<T>), nb, GQ, 0, stream, a);
  return int(cudaGetLastError());
}

template <typename T>
void query_ptrs(QueryBlocks<T>& qb, void* const* q, const void* scal, void* const* qout,
                void* qpart) {
  for (int k = 0; k < 11; ++k) qb.q[k] = static_cast<const T*>(q[k]);
  for (int k = 0; k < 10; ++k) qb.qout[k] = static_cast<T*>(qout[k]);
  qb.scal = static_cast<const T*>(scal);
  qb.qpart = static_cast<T*>(qpart);
}

template <typename T>
int grouped_from_ptrs(void* const* q, const void* cstack, const void* units, const void* ustart,
                      const void* scal, void* const* qout, void* cout, void* qpart, int nb,
                      int n_units, int iso, int p3m, cudaStream_t stream) {
  if (nb <= 0) return 0;
  UnitArgs<T> a = {};
  query_ptrs(a.qb, q, scal, qout, qpart);
  a.cand.cstack = static_cast<const T*>(cstack);
  a.cand.cout = static_cast<T*>(cout);
  a.units = static_cast<const int*>(units);
  a.ustart = static_cast<const int*>(ustart);
  if (iso) {
    return p3m ? launch_units<T, true, true>(a, nb, n_units, stream)
               : launch_units<T, true, false>(a, nb, n_units, stream);
  }
  return p3m ? launch_units<T, false, true>(a, nb, n_units, stream)
             : launch_units<T, false, false>(a, nb, n_units, stream);
}

// ---------------------------------------------------------------------------
// K6: one bucket a launch, its work units computed in the kernel

template <typename T>
struct BlockUnitArgs {
  QueryBlocks<T> qb;
  RowPlanes<T> cand;
  int cw;   // slots a block
  int n_u;  // units a block (block_units)
};

// Work units a block of cw slots: one staged piece each, at least one.
__host__ __device__ inline int block_units(int cw) { return cw > GSUB ? (cw + GSUB - 1) / GSUB : 1; }

// Unit u: block u / n_u, and that block's (u % n_u)-th piece. In float32
// under exact gravity the registers are capped for three CTAs an SM (K5's
// occupancy; the cap spills a few bytes), which the dense buckets need; the
// other bodies would spill hundreds of bytes under that cap and keep theirs.
template <typename T, bool ISO, bool P3M>
__global__ void __launch_bounds__(TILE_THREADS, (sizeof(T) == 4 && !P3M) ? 3 : 1)
    block_unit_kernel(BlockUnitArgs<T> a) {
  const long u = blockIdx.x;
  const long b = u / a.n_u;
  const int s0 = int(u % a.n_u) * GSUB;
  const long row = b * a.cw;
  T sums[10];
  unit_pieces<T, ISO, P3M>(a.qb, a.cand, b, row + s0, row + min(s0 + GSUB, a.cw), sums);
  if (threadIdx.x < GQ) {
    T* part = a.qb.qpart + u * 10 * GQ + threadIdx.x;
#pragma unroll
    for (int f = 0; f < 10; ++f) part[f * GQ] = sums[f];
  }
}

// One CTA a (block, output): a block's n_u partials of one output.
template <typename T>
__global__ void __launch_bounds__(GQ) block_combine_kernel(BlockUnitArgs<T> a) {
  const int b = blockIdx.x;
  combine_field(a.qb, b, blockIdx.y, b * a.n_u, (b + 1) * a.n_u);
}

template <typename T, bool ISO, bool P3M>
int launch_block_units(const BlockUnitArgs<T>& a, int nb, cudaStream_t stream) {
  int err = fits_one_cta(block_unit_kernel<T, ISO, P3M>, TILE_THREADS, unit_smem<T>());
  if (err) return err;
  err = fits_one_cta(block_combine_kernel<T>, GQ, 0);
  if (err) return err;
  SPH_LAUNCH((block_unit_kernel<T, ISO, P3M>), nb * a.n_u, TILE_THREADS, unit_smem<T>(), stream,
             a);
  SPH_LAUNCH((block_combine_kernel<T>), dim3(nb, 10), GQ, 0, stream, a);
  return int(cudaGetLastError());
}

template <typename T>
int blocks_from_ptrs(void* const* q, void* const* c, const void* scal, void* const* qout,
                     void* const* cout, void* qpart, int nb, int cw, int iso, int p3m,
                     cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (cw < 0 || qpart == nullptr) return int(cudaErrorInvalidValue);
  BlockUnitArgs<T> a = {};
  query_ptrs(a.qb, q, scal, qout, qpart);
  for (int k = 0; k < 10; ++k) a.cand.c[k] = static_cast<const T*>(c[k]);
  for (int k = 0; k < 8; ++k) a.cand.cout[k] = static_cast<T*>(cout[k]);
  a.cw = cw;
  a.n_u = block_units(cw);
  if (iso) {
    return p3m ? launch_block_units<T, true, true>(a, nb, stream)
               : launch_block_units<T, true, false>(a, nb, stream);
  }
  return p3m ? launch_block_units<T, false, true>(a, nb, stream)
             : launch_block_units<T, false, false>(a, nb, stream);
}

}  // namespace sph

// q: 11 device pointers (NB, 128) x y z vx vy vz mask h rho por2 cs; cstack:
// (n_chunks, 10, 512) x y z vx vy vz h rho por2 mask; units: (n_units, 3)
// int32 (query block, first chunk, chunks), a block's units consecutive
// and in chunk order; ustart: (NB + 1) int32; scal: (m, alpha, beta,
// sigma, r_c); qout: 10 device pointers (NB, 128); cout: (n_chunks, 8,
// 512); qpart: (n_units, 10, 128) scratch.
extern "C" int sph_phase_b_grouped(void* const* q, const void* cstack, const void* units,
                                   const void* ustart, const void* scal, void* const* qout,
                                   void* cout, void* qpart, int nb, int n_units, int iso, int p3m,
                                   int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::grouped_from_ptrs<double>(q, cstack, units, ustart, scal, qout, cout,
                                                    qpart, nb, n_units, iso, p3m, s)
                   : sph::grouped_from_ptrs<float>(q, cstack, units, ustart, scal, qout, cout,
                                                   qpart, nb, n_units, iso, p3m, s);
}

// q, scal and qout as above; c: 10 device pointers (nb, cw) in the grouped
// field order x y z vx vy vz h rho por2 mask; cout: 8 device pointers (nb,
// cw); qpart: (nb sph_phase_b_blocks_units(cw), 10, 128) scratch.
extern "C" int sph_phase_b_blocks(void* const* q, void* const* c, const void* scal,
                                  void* const* qout, void* const* cout, void* qpart, int nb,
                                  int cw, int iso, int p3m, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::blocks_from_ptrs<double>(q, c, scal, qout, cout, qpart, nb, cw, iso, p3m,
                                                   s)
                   : sph::blocks_from_ptrs<float>(q, c, scal, qout, cout, qpart, nb, cw, iso, p3m,
                                                  s);
}

// Work units a block of cw slots takes in sph_phase_b_blocks.
extern "C" int sph_phase_b_blocks_units(int cw) { return sph::block_units(cw); }
