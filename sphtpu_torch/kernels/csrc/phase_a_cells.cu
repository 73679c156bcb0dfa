// phase_a_cells / phase_a_tile: exact k-th neighbour distance by count
// bisection + density.
//
// Replaces two TPU kernels that compute the same thing on different
// layouts: sphtpu/kernels/pallas_strip_knn.py::phase_a_cells (_kernel; the
// class-compacted engine: explicit query planes and a per-query reach2)
// and sphtpu/kernels/pallas_knn.py::phase_a_pallas (_phase_a_kernel; the
// mono-tile engine: the queries are the centre cell of the 27-cell
// candidate row, slots 13*cap .. 14*cap, the occupancy plane is the query
// mask, and the threshold is one uniform s2 = (cell edge)^2). One kernel
// template serves both (MONO selects the layout). Per query slot of a cell
// row: squared distances to the row's
// candidates, n_bisect count bisections on [0, 1.001 * reach2] for the
// exact k-th distance, rk2 = max{d2 <= hi}, nfound = #{d2 <= rk2},
// h = sqrt(rk2) / 2, rho = m * sum W over d2 <= rk2 (self pair included),
// ok = masked-off | (nfound >= kh & rk2 <= reach2).
//
// Bound on this card: operations (d2 once per (query, occupied candidate)
// pair, then a compare and a count per pass) while the row's candidates are
// read from device memory once. This kernel does more than that bound
// counts: it keeps no d2 per pair and re-evaluates it on every one of the
// n_bisect + 3 passes.
// Design: a block owns 32 queries of one cell row, 8 lanes per query. The
// row's OCCUPIED candidates (mask > 0; most stencil slots are padding) are
// compacted, order kept, into shared memory once; every pass recomputes d2
// from shared memory and reduces an INTEGER count by warp shuffle, so the
// bisection fixed point does not depend on reduction order — only rho
// reassociates. The three candidate planes of a row (3 * cw elements) must
// fit the shared memory a block may opt into; the wrapper refuses wider rows.
// A block whose 32 query slots are all masked off (the padding of a cell
// with fewer particles than the capacity) writes its outputs and leaves
// before it stages anything.
#include "common.cuh"

namespace sph {

template <typename T>
struct PhaseAArgs {
  const T* qx;  // MONO: unused (queries are the centre slice of cx..cm)
  const T* qy;
  const T* qz;
  const T* qm;
  const T* reach2;  // (n_cells, cap); MONO: one element, s2
  const T* cx;
  const T* cy;
  const T* cz;
  const T* cm;
  const T* m;  // one element, on the device
  T* h;
  T* rho;
  T* ok;
  int cap;
  int cw;
  int kh;
  int n_bisect;
  int chunk;  // raw candidate slots staged at a time (>= cw: the row stays resident)
};

template <typename T, bool MONO>
__global__ void __launch_bounds__(TILE_THREADS) phase_a_kernel(PhaseAArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int wcount[TILE_WARPS];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + a.chunk;
  T* sz = sy + a.chunk;

  const long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int sub = tid % LANES_PER_QUERY;
  const int q = blockIdx.y * QUERIES_PER_BLOCK + tid / LANES_PER_QUERY;
  const T* cx = a.cx + row * a.cw;
  const T* cy = a.cy + row * a.cw;
  const T* cz = a.cz + row * a.cw;
  const T* cm = a.cm + row * a.cw;
  const long qi = row * a.cap + q;
  const int centre = 13 * a.cap;  // MONO: cell (1,1,1) of the 27-stack
  const bool qvalid = q < a.cap && (MONO ? cm[centre + q] : a.qm[qi]) > T(0);

  if (!__syncthreads_or(qvalid)) {
    // no query of this block is occupied: h = rho = 0, ok = 1
    if (q < a.cap && sub == 0) {
      a.h[qi] = T(0);
      a.rho[qi] = T(0);
      a.ok[qi] = T(1);
    }
    return;
  }

  // stage raw slots [c0, c0 + chunk) of the row, occupied ones compacted in
  // order; returns how many were kept. Every thread of the block calls it.
  auto stage = [&](int c0) {
    const int c1 = (c0 + a.chunk < a.cw) ? c0 + a.chunk : a.cw;
    int kept = 0;
    for (int t0 = c0; t0 < c1; t0 += TILE_THREADS) {
      const int j = t0 + tid;
      const bool keep = j < c1 && cm[j] > T(0);
      const int p = compact_slot(keep, kept, wcount);
      if (keep) {
        sx[p] = cx[j];
        sy[p] = cy[j];
        sz[p] = cz[j];
      }
    }
    __syncthreads();
    return kept;
  };
  const bool resident = a.chunk >= a.cw;
  const int n_resident = resident ? stage(0) : 0;

  // Every thread stays to the end (streaming stages the row again on each
  // pass); only the lanes of an occupied query slot compute.
  const T qx = qvalid ? (MONO ? cx[centre + q] : a.qx[qi]) : T(0);
  const T qy = qvalid ? (MONO ? cy[centre + q] : a.qy[qi]) : T(0);
  const T qz = qvalid ? (MONO ? cz[centre + q] : a.qz[qi]) : T(0);
  const T r2 = qvalid ? (MONO ? a.reach2[0] : a.reach2[qi]) : T(0);

  // One pass over the row's occupied candidates. Lane `sub` of a query takes
  // the candidates whose index in the compacted row is sub mod 8, in order,
  // whether the row is resident or streamed in pieces: every lane sums the
  // same terms in the same order either way, so the results do not depend on
  // the mode.
#define SPH_FOR_EACH_CAND(...)                                                   \
  for (int c0 = 0, base = 0; c0 < a.cw; c0 += a.chunk) {                        \
    const int kept = resident ? n_resident : stage(c0);                         \
    if (qvalid) {                                                               \
      for (int j = (sub - base % LANES_PER_QUERY + LANES_PER_QUERY) % LANES_PER_QUERY; \
           j < kept; j += LANES_PER_QUERY) {                                    \
        const T d2 = dist2<T>(qx - sx[j], qy - sy[j], qz - sz[j]);              \
        __VA_ARGS__                                                             \
      }                                                                         \
    }                                                                           \
    base += kept;                                                               \
    if (!resident) __syncthreads();                                            \
  }

  T lo = T(0);
  T hi = T(1.001) * r2;
  for (int it = 0; it < a.n_bisect; ++it) {
    const T mid = T(0.5) * (lo + hi);
    int cnt = 0;
    SPH_FOR_EACH_CAND(cnt += (d2 <= mid) ? 1 : 0;)
    if (qvalid) {
      cnt = group_sum<int>(cnt);
      const bool ge = cnt >= a.kh;  // k-th distance <= mid: shrink to [lo, mid]
      lo = ge ? lo : mid;
      hi = ge ? mid : hi;
    }
  }

  T rk2 = T(0);
  SPH_FOR_EACH_CAND(if (d2 <= hi && d2 > rk2) rk2 = d2;)
  if (qvalid) rk2 = group_max<T>(rk2);

  const T h_t = Num<T>::sqrt(rk2) / T(2);
  const T h_safe = h_t > T(0) ? h_t : T(1);
  const T ct = T(1) / (T(3.14159265358979323846) * (h_safe * h_safe * h_safe));
  int nfound = 0;
  T wsum = T(0);
  SPH_FOR_EACH_CAND(
      if (d2 <= rk2) {
        nfound += 1;
        const T qq = Num<T>::sqrt(d2) / h_safe;
        const T two_m = T(2) - qq;
        const T w = qq <= T(1)
                        ? T(1) - T(1.5) * (qq * qq) + T(0.75) * (qq * qq * qq)
                        : (qq <= T(2) ? T(0.25) * (two_m * two_m * two_m) : T(0));
        wsum += ct * w;
      })
#undef SPH_FOR_EACH_CAND
  if (q >= a.cap) return;
  if (!qvalid) {
    // off-mask rows: h = rho = 0, ok = 1 (all lanes of the group agree)
    if (sub == 0) {
      a.h[qi] = T(0);
      a.rho[qi] = T(0);
      a.ok[qi] = T(1);
    }
    return;
  }
  nfound = group_sum<int>(nfound);
  wsum = group_sum<T>(wsum);

  if (sub == 0) {
    a.h[qi] = h_t;
    a.rho[qi] = a.m[0] * wsum;
    a.ok[qi] = (nfound >= a.kh && rk2 <= r2) ? T(1) : T(0);
  }
}

// Raw candidate slots a block stages at a time: the whole row when its
// three planes fit the shared memory a block may opt into, else the most
// that fit, a multiple of the block's threads (or `max_chunk`, when it is
// positive and smaller: a test forces streaming with it).
template <typename T>
int stage_chunk(int cw, int max_chunk, int* chunk) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return int(e);
  const int fit = (optin - 1024) / int(3 * sizeof(T)) / TILE_THREADS * TILE_THREADS;
  int c = cw < fit ? cw : fit;
  if (max_chunk > 0 && max_chunk < c) c = max_chunk;
  *chunk = c > 0 ? c : 1;
  return 0;
}

template <typename T, bool MONO>
int launch_phase_a(PhaseAArgs<T> a, int n_cells, int max_chunk, cudaStream_t stream) {
  if (n_cells <= 0) return 0;
  int err = stage_chunk<T>(a.cw, max_chunk, &a.chunk);
  if (err) return err;
  const dim3 grid(n_cells, (a.cap + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK);
  const size_t smem = size_t(3) * a.chunk * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(phase_a_kernel<T, MONO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  SPH_LAUNCH((phase_a_kernel<T, MONO>), grid, TILE_THREADS, smem, stream, a);
  return int(cudaGetLastError());
}

}  // namespace sph

namespace sph {

template <typename T>
int phase_a_from_ptrs(void* const* p, int n_cells, int cap, int cw, int kh, int n_bisect,
                      int max_chunk, cudaStream_t stream) {
  PhaseAArgs<T> a;
  a.qx = static_cast<const T*>(p[0]);
  a.qy = static_cast<const T*>(p[1]);
  a.qz = static_cast<const T*>(p[2]);
  a.qm = static_cast<const T*>(p[3]);
  a.reach2 = static_cast<const T*>(p[4]);
  a.cx = static_cast<const T*>(p[5]);
  a.cy = static_cast<const T*>(p[6]);
  a.cz = static_cast<const T*>(p[7]);
  a.cm = static_cast<const T*>(p[8]);
  a.m = static_cast<const T*>(p[9]);
  a.h = static_cast<T*>(p[10]);
  a.rho = static_cast<T*>(p[11]);
  a.ok = static_cast<T*>(p[12]);
  a.cap = cap;
  a.cw = cw;
  a.kh = kh;
  a.n_bisect = n_bisect;
  return launch_phase_a<T, false>(a, n_cells, max_chunk, stream);
}

template <typename T>
int phase_a_tile_from_ptrs(void* const* p, int n_cells, int cap, int kh, int n_bisect,
                           cudaStream_t stream) {
  PhaseAArgs<T> a = {};
  a.reach2 = static_cast<const T*>(p[0]);
  a.cx = static_cast<const T*>(p[1]);
  a.cy = static_cast<const T*>(p[2]);
  a.cz = static_cast<const T*>(p[3]);
  a.cm = static_cast<const T*>(p[4]);
  a.m = static_cast<const T*>(p[5]);
  a.h = static_cast<T*>(p[6]);
  a.rho = static_cast<T*>(p[7]);
  a.ok = static_cast<T*>(p[8]);
  a.cap = cap;
  a.cw = 27 * cap;
  a.kh = kh;
  a.n_bisect = n_bisect;
  return launch_phase_a<T, true>(a, n_cells, 0, stream);
}

}  // namespace sph

// ptrs: qx qy qz qm reach2 cx cy cz cm m h rho ok (13 device pointers, m one
// element). Rows wider than a block's shared memory holds are streamed;
// max_chunk > 0 caps the slots staged at a time (0: as many as fit).
extern "C" int sph_phase_a_cells(void* const* ptrs, int n_cells, int cap, int cw, int kh,
                                 int n_bisect, int max_chunk, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? sph::phase_a_from_ptrs<double>(ptrs, n_cells, cap, cw, kh, n_bisect, max_chunk, s)
             : sph::phase_a_from_ptrs<float>(ptrs, n_cells, cap, cw, kh, n_bisect, max_chunk, s);
}

// ptrs: s2 cx cy cz cm m h rho ok (9 device pointers; s2 and m one element
// each; cx..cm (n_cells, 27 * cap), the outputs (n_cells, cap)). The
// queries are slots 13 * cap .. 14 * cap of each candidate row.
extern "C" int sph_phase_a_tile(void* const* ptrs, int n_cells, int cap, int kh, int n_bisect,
                                int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::phase_a_tile_from_ptrs<double>(ptrs, n_cells, cap, kh, n_bisect, s)
                   : sph::phase_a_tile_from_ptrs<float>(ptrs, n_cells, cap, kh, n_bisect, s);
}
