// phase_b_grouped / phase_b_blocks: the block engine's phase B, pair forces
// + gravity corrections in the ball owner's sweep.
//
// Replaces two TPU kernels that compute the same pair terms on different
// layouts: sphtpu/kernels/pallas_grouped_pairs.py::phase_b_grouped
// (_kernel; every capacity bucket in one launch: a flat list of (BQ, CW)
// chunks, chunk i querying packed-query block qblk[i], a block's chunks
// consecutive) and sphtpu/kernels/pallas_block_pairs.py::phase_b_blocks
// (_kernel; one bucket, (nb, BQ) queries against (nb, C_b) candidates).
// One kernel template serves both (GROUPED selects the candidate layout);
// the pair algebra is one device function, `pair_terms`.
//
// Pair semantics (exactly the Pallas kernels'): forward mask d2 <= (2 h_q)^2;
// the owner's kernel gradient and the owner's sound speed in Pi; the
// division-diet algebra on inv_r = rsqrt(d2) (self pairs: 1/r -> 0);
// polytropic coefficient symmetric, isothermal asymmetric; gravity
// corrections (softened - Newtonian for r <= 2 h_avg, plus Newtonian - mesh
// shape under P3M) carry two-sided ownership weights w = 1/2 when both rows
// see the pair (r <= max(2h, r_c) on each side), 1 when only the query does.
// Outputs: ten query-side reductions per query row (ax ay az = -sum coeff d,
// div, mu_max — a MAX, init -max — visc, gx gy gz gphi) and eight
// candidate-side sums per candidate slot (sax say saz = +sum coeff d, svisc,
// sgx sgy sgz = -m sum w cgp d, sgp = m sum w cpp), which the caller adds
// into particle rows with one scatter-add.
//
// Bound on this card: operations (d2 and the mask test on every (query,
// occupied candidate) pair; the body only on the pairs inside the query's
// visibility radius: kh of them under exact gravity).
// Design: one CTA of 256 threads per query block of GQ = 128 rows, which
// walks the block's candidate slots in order, GSUB = 256 at a time staged in
// shared memory. Each staged piece is swept twice: query-major (8 lanes per
// query, 32 queries at a time; the lane sums combine by warp shuffle into
// shared accumulators) and candidate-major (one thread per candidate slot
// walking the 128 staged queries). A pair inside a mask is thus evaluated
// twice, and no sum uses an atomic: every output is a fixed-order sum, so
// the results are the same from run to run. A block with no occupied query
// row (the sentinel padding of a bucket) writes zeros and leaves.
// Load balance: a block has between 1 and 64 chunks of 512 slots (C_b from
// 512 to 32768), so CTAs differ up to 64x in work.
#include "common.cuh"

namespace sph {

constexpr int GQ = 128;                                  // query rows a block (the planner's BQ)
constexpr int GCW = 512;                                 // slots a chunk of the grouped layout
constexpr int GSUB = TILE_THREADS;                       // candidate slots staged at a time
constexpr int GROUNDS = GQ / QUERIES_PER_BLOCK;          // query-major rounds a piece

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

  // gravity corrections, term 1: softened - Newtonian for r <= 2 h_avg
  const T newt_g = inv_r * inv_r * inv_r;
  const T newt_p = -inv_r;
  T cgp = T(0), cpp = T(0);
  if (r <= T(2) * h_avg) {
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
               (T(8.0 / 3.0) * q_g - T(3) * q2 + T(1.2) * q3 - q2 * q2 / T(6) -
                T(1.0 / 15.0) * inv_q * inv_q) *
               inv_r;
      soft_p = inv_h * (T(4.0 / 3.0) * q2 - q3 + T(0.3) * q2 * q2 - q2 * q3 / T(30) - T(1.6) +
                        T(1.0 / 15.0) * inv_q);
    } else {
      soft_g = newt_g;
      soft_p = newt_p;
    }
    cgp = soft_g - newt_g;
    cpp = soft_p - newt_p;
  }
  if (P3M) {
    // term 2 (Newtonian - mesh shape): exp(-z^2) * erfcx polynomial
    const T t = d2 * inv_r / p.sigma;
    const T z = t * T(0.7071067811865476);
    const T u = z / (T(1) + z);
    T pp = T(2.3849380332e-01);
    pp = pp * u + T(-9.3397713762e-01);
    pp = pp * u + T(1.2579923862e+00);
    pp = pp * u + T(-8.1740263321e-01);
    pp = pp * u + T(4.6001262975e-01);
    pp = pp * u + T(4.3301822784e-02);
    pp = pp * u + T(-1.1974394197e-01);
    pp = pp * u + T(-1.1287916483e+00);
    pp = pp * u + T(1.0000047021e+00);
    const T e = Num<T>::exp(-z * z);
    const T erfc_z = e * pp;
    const T f = erfc_z + T(0.7978845608028654) * t * e;
    cgp += sep ? f * newt_g : T(0);
    cpp += sep ? -erfc_z * inv_r : T(0.7978845608028654) / p.sigma;
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

template <typename T>
struct PairsArgs {
  const T* q[11];  // (NB, GQ) each: x y z vx vy vz mask h rho por2 cs
  T* qout[10];     // (NB, GQ) each: ax ay az div mu_max visc gx gy gz gphi
  const T* scal;   // m alpha beta sigma r_c on the device
  // GROUPED: cstack (n_chunks, 10, GCW) x y z vx vy vz h rho por2 mask;
  // chunk_start (NB + 1): block b owns chunks [chunk_start[b], chunk_start[b + 1]);
  // cout (n_chunks, 8, GCW)
  const T* cstack;
  const int* chunk_start;
  T* cout;
  // per bucket: c[10] (NB, cw) in the grouped field order; cout_b[8] (NB, cw)
  const T* c[10];
  T* cout_b[8];
  int cw;
};

template <typename T, bool GROUPED, bool ISO, bool P3M>
__global__ void __launch_bounds__(TILE_THREADS) pairs_kernel(PairsArgs<T> a) {
  __shared__ T sq[11][GQ];    // the block's query fields (index 6: mask)
  __shared__ T sacc[10][GQ];  // query-side sums (index 4: mu_max)
  __shared__ T sc[10][GSUB];  // a staged piece: x y z vx vy vz h rho por2 mask

  const long b = blockIdx.x;
  const int tid = threadIdx.x;
  const T big = Num<T>::big();
  for (int i = tid; i < 11 * GQ; i += TILE_THREADS) sq[i / GQ][i % GQ] = a.q[i / GQ][b * GQ + i % GQ];
  for (int i = tid; i < 10 * GQ; i += TILE_THREADS) sacc[i / GQ][i % GQ] = (i / GQ == 4) ? -big : T(0);
  __syncthreads();
  const bool any_query = __syncthreads_or(tid < GQ && sq[6][tid] > T(0));

  long slot0;  // GROUPED: index of the block's first slot in the flat chunk list
  int n_slots;
  if (GROUPED) {
    slot0 = long(a.chunk_start[b]) * GCW;
    n_slots = (a.chunk_start[b + 1] - a.chunk_start[b]) * GCW;
  } else {
    slot0 = b * a.cw;
    n_slots = a.cw;
  }
  PairParams<T> p;
  p.m = a.scal[0];
  p.alpha = a.scal[1];
  p.beta = a.scal[2];
  p.sigma = a.scal[3];
  p.r_c = a.scal[4];

  for (int s0 = 0; s0 < n_slots; s0 += GSUB) {
    const int s = s0 + tid;  // this thread's candidate slot of the piece
    const bool live = s < n_slots;
    T f[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) f[k] = T(0);
    if (live && any_query) {
      if (GROUPED) {
        const long flat = slot0 + s;
        const T* src = a.cstack + (flat / GCW) * 10 * GCW + flat % GCW;
#pragma unroll
        for (int k = 0; k < 10; ++k) f[k] = src[k * GCW];
      } else {
#pragma unroll
        for (int k = 0; k < 10; ++k) f[k] = a.c[k][slot0 + s];
      }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) sc[k][tid] = f[k];
    __syncthreads();

    if (any_query) {
      // query-major sweep: 8 lanes per query, 32 queries a round
      const int sub = tid % LANES_PER_QUERY;
      for (int rd = 0; rd < GROUNDS; ++rd) {
        const int qk = rd * QUERIES_PER_BLOCK + tid / LANES_PER_QUERY;
        if (!(sq[6][qk] > T(0))) continue;  // uniform over the query's lanes
        const QRow<T> q = {sq[0][qk], sq[1][qk], sq[2][qk], sq[3][qk], sq[4][qk],
                           sq[5][qk], sq[7][qk], sq[8][qk], sq[9][qk], sq[10][qk]};
        T ax = T(0), ay = T(0), az = T(0), dv = T(0), visc = T(0);
        T gx = T(0), gy = T(0), gz = T(0), gp = T(0), mumax = -big;
        for (int j = sub; j < GSUB; j += LANES_PER_QUERY) {
          if (!(sc[9][j] > T(0))) continue;
          const CRow<T> c = {sc[0][j], sc[1][j], sc[2][j], sc[3][j], sc[4][j],
                             sc[5][j], sc[6][j], sc[7][j], sc[8][j]};
          PairOut<T> o;
          if (!pair_terms<T, ISO, P3M>(q, c, p, o)) continue;
          ax -= o.cdx;
          ay -= o.cdy;
          az -= o.cdz;
          dv += o.div;
          mumax = o.mu > mumax ? o.mu : mumax;
          visc += o.visc;
          gx += o.gwx;
          gy += o.gwy;
          gz += o.gwz;
          gp += o.cpw;
        }
        ax = group_sum<T>(ax);
        ay = group_sum<T>(ay);
        az = group_sum<T>(az);
        dv = group_sum<T>(dv);
        mumax = group_max<T>(mumax);
        visc = group_sum<T>(visc);
        gx = group_sum<T>(gx);
        gy = group_sum<T>(gy);
        gz = group_sum<T>(gz);
        gp = group_sum<T>(gp);
        if (sub == 0) {
          sacc[0][qk] += ax;
          sacc[1][qk] += ay;
          sacc[2][qk] += az;
          sacc[3][qk] += dv;
          sacc[4][qk] = mumax > sacc[4][qk] ? mumax : sacc[4][qk];
          sacc[5][qk] += visc;
          sacc[6][qk] += gx;
          sacc[7][qk] += gy;
          sacc[8][qk] += gz;
          sacc[9][qk] += gp;
        }
      }
    }

    // candidate-major sweep: this thread's slot against every query row
    T sax = T(0), say = T(0), saz = T(0), svisc = T(0);
    T sgx = T(0), sgy = T(0), sgz = T(0), sgp = T(0);
    if (any_query && live && f[9] > T(0)) {
      const CRow<T> c = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
      for (int k = 0; k < GQ; ++k) {
        if (!(sq[6][k] > T(0))) continue;  // uniform over the CTA
        const QRow<T> q = {sq[0][k], sq[1][k], sq[2][k], sq[3][k], sq[4][k],
                           sq[5][k], sq[7][k], sq[8][k], sq[9][k], sq[10][k]};
        PairOut<T> o;
        if (!pair_terms<T, ISO, P3M>(q, c, p, o)) continue;
        sax += o.cdx;
        say += o.cdy;
        saz += o.cdz;
        svisc += o.visc;
        sgx += o.gwx;
        sgy += o.gwy;
        sgz += o.gwz;
        sgp += o.cpw;
      }
    }
    if (live) {
      const T out[8] = {sax, say, saz, svisc, -p.m * sgx, -p.m * sgy, -p.m * sgz, p.m * sgp};
      if (GROUPED) {
        const long flat = slot0 + s;
        T* dst = a.cout + (flat / GCW) * 8 * GCW + flat % GCW;
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k * GCW] = out[k];
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) a.cout_b[k][slot0 + s] = out[k];
      }
    }
    __syncthreads();  // the piece is overwritten next
  }

  for (int k = tid; k < GQ; k += TILE_THREADS) {
    const long o = b * GQ + k;
    a.qout[0][o] = sacc[0][k];
    a.qout[1][o] = sacc[1][k];
    a.qout[2][o] = sacc[2][k];
    a.qout[3][o] = p.m * sacc[3][k];
    a.qout[4][o] = sacc[4][k];
    a.qout[5][o] = sacc[5][k];
    a.qout[6][o] = p.m * sacc[6][k];
    a.qout[7][o] = p.m * sacc[7][k];
    a.qout[8][o] = p.m * sacc[8][k];
    a.qout[9][o] = p.m * sacc[9][k];
  }
}

// F2: the kernel's budget for GQ = 128 query rows a block — its static
// shared memory and the registers of 256 threads — must fit one CTA of this
// card; otherwise nothing is launched and the caller gets ERR_BUDGET.
template <typename K>
int check_budget(K kernel) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return int(e);
  int dev = 0, smem_max = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return int(e);
  if (attr.maxThreadsPerBlock < TILE_THREADS || int(attr.sharedSizeBytes) > smem_max) return ERR_BUDGET;
  return 0;
}

template <typename T, bool GROUPED, bool ISO, bool P3M>
int launch_pairs(const PairsArgs<T>& a, int nb, cudaStream_t stream) {
  const int err = check_budget(pairs_kernel<T, GROUPED, ISO, P3M>);
  if (err) return err;
  SPH_LAUNCH((pairs_kernel<T, GROUPED, ISO, P3M>), nb, TILE_THREADS, 0, stream, a);
  return int(cudaGetLastError());
}

template <typename T, bool GROUPED>
int pairs_dispatch(const PairsArgs<T>& a, int nb, int iso, int p3m, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (iso) {
    return p3m ? launch_pairs<T, GROUPED, true, true>(a, nb, stream)
               : launch_pairs<T, GROUPED, true, false>(a, nb, stream);
  }
  return p3m ? launch_pairs<T, GROUPED, false, true>(a, nb, stream)
             : launch_pairs<T, GROUPED, false, false>(a, nb, stream);
}

template <typename T>
PairsArgs<T> common_args(void* const* q, const void* scal, void* const* qout) {
  PairsArgs<T> a = {};
  for (int k = 0; k < 11; ++k) a.q[k] = static_cast<const T*>(q[k]);
  for (int k = 0; k < 10; ++k) a.qout[k] = static_cast<T*>(qout[k]);
  a.scal = static_cast<const T*>(scal);
  return a;
}

template <typename T>
int grouped_from_ptrs(void* const* q, const void* cstack, const void* chunk_start,
                      const void* scal, void* const* qout, void* cout, int nb, int iso, int p3m,
                      cudaStream_t stream) {
  PairsArgs<T> a = common_args<T>(q, scal, qout);
  a.cstack = static_cast<const T*>(cstack);
  a.chunk_start = static_cast<const int*>(chunk_start);
  a.cout = static_cast<T*>(cout);
  return pairs_dispatch<T, true>(a, nb, iso, p3m, stream);
}

template <typename T>
int blocks_from_ptrs(void* const* q, void* const* c, const void* scal, void* const* qout,
                     void* const* cout, int nb, int cw, int iso, int p3m, cudaStream_t stream) {
  PairsArgs<T> a = common_args<T>(q, scal, qout);
  for (int k = 0; k < 10; ++k) a.c[k] = static_cast<const T*>(c[k]);
  for (int k = 0; k < 8; ++k) a.cout_b[k] = static_cast<T*>(cout[k]);
  a.cw = cw;
  return pairs_dispatch<T, false>(a, nb, iso, p3m, stream);
}

}  // namespace sph

// q: 11 device pointers (NB, 128) x y z vx vy vz mask h rho por2 cs; cstack:
// (n_chunks, 10, 512) x y z vx vy vz h rho por2 mask; chunk_start: (NB + 1)
// int32; scal: (m, alpha, beta, sigma, r_c); qout: 10 device pointers
// (NB, 128); cout: (n_chunks, 8, 512).
extern "C" int sph_phase_b_grouped(void* const* q, const void* cstack, const void* chunk_start,
                                   const void* scal, void* const* qout, void* cout, int nb,
                                   int iso, int p3m, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::grouped_from_ptrs<double>(q, cstack, chunk_start, scal, qout, cout, nb,
                                                    iso, p3m, s)
                   : sph::grouped_from_ptrs<float>(q, cstack, chunk_start, scal, qout, cout, nb,
                                                   iso, p3m, s);
}

// q as above; c: 10 device pointers (nb, cw) in the grouped field order
// x y z vx vy vz h rho por2 mask; cout: 8 device pointers (nb, cw).
extern "C" int sph_phase_b_blocks(void* const* q, void* const* c, const void* scal,
                                  void* const* qout, void* const* cout, int nb, int cw, int iso,
                                  int p3m, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::blocks_from_ptrs<double>(q, c, scal, qout, cout, nb, cw, iso, p3m, s)
                   : sph::blocks_from_ptrs<float>(q, c, scal, qout, cout, nb, cw, iso, p3m, s);
}
