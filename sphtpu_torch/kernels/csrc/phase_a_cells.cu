// phase_a_cells / phase_a_tile: exact k-th neighbour distance by count
// bisection + density.
//
// Replaces two TPU kernels that compute the same thing on different
// layouts: sphtpu/kernels/pallas_strip_knn.py::phase_a_cells (_kernel; the
// class-compacted and block engines: explicit query planes and a per-query
// reach2) and sphtpu/kernels/pallas_knn.py::phase_a_pallas
// (_phase_a_kernel; the mono-tile engine: the queries are the centre cell
// of the 27-cell candidate row, slots 13*cap .. 14*cap, the occupancy plane
// is the query mask, and the threshold is one uniform s2 = (cell edge)^2).
// One kernel template serves both (MONO selects the layout). Per query slot
// of a cell row: squared distances to the row's candidates, n_bisect count
// bisections on [0, 1.001 * reach2] for the exact k-th distance,
// rk2 = max{d2 <= hi}, nfound = #{d2 <= rk2}, h = sqrt(rk2) / 2,
// rho = m * sum W over d2 <= rk2 (self pair included),
// ok = masked-off | (nfound >= kh & rk2 <= reach2).
//
// Bound on this card: operations — d2 and one compare against
// hi0 = 1.001 * reach2 once per (query, occupied candidate) pair, then a
// compare and a count per pass only on the pairs with d2 <= hi0: every
// bisection midpoint, rk2 and the density's radius lie at or below hi0,
// so no other candidate can change a count, the max or the sum.
//
// Design, shared by both entries: a block owns 32 queries of one cell row,
// 8 lanes per query. The row's OCCUPIED candidates (mask > 0; most stencil
// slots are padding) are compacted, order kept, into shared memory — the
// whole row when it fits (`chunk` >= cw), else in pieces of `chunk` raw
// slots. Counts are INTEGERS reduced by warp shuffle, so the bisection
// fixed point does not depend on reduction order — only rho reassociates.
// A block whose 32 query slots are all masked off (the padding of a cell
// with fewer particles than the capacity) writes its outputs and leaves
// before it stages anything.
//
// Both entries read the row ONCE: each query's lanes take rounds of 8
// consecutive candidates, and a ballot gives every d2 <= hi0 its slot in
// the query's list in shared memory, in candidate order. The n_bisect
// passes, rk2, nfound and rho then run over that list only (lane sub takes
// entries sub mod 8). The counts are integers, so h and ok equal the
// full-row sweep's bit for bit. A query with more than `list_len` such
// candidates overflows: it takes the full-row sweep below (the row staged
// again on every pass where it is streamed), and the kernel counts it in
// *n_over. Staging issues its loads a few steps ahead, and the collect
// loop computes 4 rounds before their votes, so neither waits out one
// load latency at a time. K4's row (27 cap slots, 4 320 at cap 160) is
// wider than the staging width, so it streams in pieces for the one
// collect pass; only an overflowed query's block stages it again.
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
  int list_len;  // in-radius candidates a query's list holds (L)
  int* n_over;   // queries whose in-radius candidates overflowed L
};

// Rounds of 8 candidates K1's collect loop computes before it votes.
constexpr int COLLECT_ROUNDS = 4;

// Entries a query's list occupies in shared memory: L rounded up to 32,
// plus 8, so the 4 lists a warp reads at a time start on distinct banks.
__host__ __device__ inline int list_stride(int list_len) { return (list_len + 31) / 32 * 32 + 8; }

// The cubic spline W(q) without its 1 / (pi h^3) factor.
template <typename T>
__device__ __forceinline__ T spline_w(T qq) {
  const T two_m = T(2) - qq;
  return qq <= T(1) ? T(1) - T(1.5) * (qq * qq) + T(0.75) * (qq * qq * qq)
                    : (qq <= T(2) ? T(0.25) * (two_m * two_m * two_m) : T(0));
}

// The list path for the calling thread's query slot. Every thread of the
// block calls it (the row is staged inside). Returns true where the query
// overflowed its list; a listed query has written its h, rho and ok, a
// masked-off slot its defaults.
template <typename T, typename Stage>
__device__ __forceinline__ bool collect_and_bisect(const PhaseAArgs<T>& a, const T* sx,
                                                   const T* sy, T* sz, Stage& stage,
                                                   bool resident, int n_resident, bool qvalid,
                                                   int q, long qi, int sub, T qx, T qy, T qz,
                                                   T r2) {
  const int tid = threadIdx.x;
  T* lst = sz + a.chunk + (tid / LANES_PER_QUERY) * list_stride(a.list_len);
  const unsigned gmask = group_mask();
  const int gshift = (tid & 31) & ~(LANES_PER_QUERY - 1);
  const unsigned below = (1u << sub) - 1u;
  const T hi0 = T(1.001) * r2;

  // collect: one pass over the row, the in-radius d2 in candidate order.
  // Every lane of the warp walks the piece (a masked-off slot votes false),
  // so the ballot is warp-wide; a lane past the piece's end reads its last
  // candidate and votes false. COLLECT_ROUNDS rounds of 8 candidates load
  // and compute before their votes and list stores, so their shared loads
  // do not wait behind the stores.
  int n_in = 0;  // the query's in-radius candidates so far (the same in its 8 lanes)
  for (int c0 = 0; c0 < a.cw; c0 += a.chunk) {
    const int kept = resident ? n_resident : stage(c0);
    for (int j0 = 0; j0 < kept; j0 += COLLECT_ROUNDS * LANES_PER_QUERY) {
      T d2[COLLECT_ROUNDS];
      bool in[COLLECT_ROUNDS];
#pragma unroll
      for (int u = 0; u < COLLECT_ROUNDS; ++u) {
        const int jr = j0 + u * LANES_PER_QUERY + sub;
        const int j = min(jr, kept - 1);
        d2[u] = dist2<T>(qx - sx[j], qy - sy[j], qz - sz[j]);
        in[u] = qvalid && jr < kept && d2[u] <= hi0;
      }
#pragma unroll
      for (int u = 0; u < COLLECT_ROUNDS; ++u) {
        const unsigned b = (__ballot_sync(0xffffffffu, in[u]) >> gshift) & 0xffu;
        const int slot = n_in + __popc(b & below);
        if (in[u] && slot < a.list_len) lst[slot] = d2[u];
        n_in += __popc(b);
      }
    }
    if (!resident) __syncthreads();
  }
  if (!qvalid) {
    if (q < a.cap && sub == 0) {
      a.h[qi] = T(0);
      a.rho[qi] = T(0);
      a.ok[qi] = T(1);
    }
    return false;
  }
  if (n_in > a.list_len) return true;
  __syncwarp(gmask);

  // bisect, rk2, nfound and rho over the list
  T lo = T(0);
  T hi = hi0;
  for (int it = 0; it < a.n_bisect; ++it) {
    const T mid = T(0.5) * (lo + hi);
    int cnt = 0;
    for (int i = sub; i < n_in; i += LANES_PER_QUERY) cnt += (lst[i] <= mid) ? 1 : 0;
    cnt = group_sum<int>(cnt);
    const bool ge = cnt >= a.kh;  // k-th distance <= mid: shrink to [lo, mid]
    lo = ge ? lo : mid;
    hi = ge ? mid : hi;
  }
  T rk2 = T(0);
  for (int i = sub; i < n_in; i += LANES_PER_QUERY) {
    const T d2 = lst[i];
    if (d2 <= hi && d2 > rk2) rk2 = d2;
  }
  rk2 = group_max<T>(rk2);
  const T h_t = Num<T>::sqrt(rk2) / T(2);
  const T h_safe = h_t > T(0) ? h_t : T(1);
  const T ct = T(1) / (T(3.14159265358979323846) * (h_safe * h_safe * h_safe));
  int nfound = 0;
  T wsum = T(0);
  for (int i = sub; i < n_in; i += LANES_PER_QUERY) {
    const T d2 = lst[i];
    if (d2 <= rk2) {
      nfound += 1;
      wsum += ct * spline_w<T>(Num<T>::sqrt(d2) / h_safe);
    }
  }
  nfound = group_sum<int>(nfound);
  wsum = group_sum<T>(wsum);
  if (sub == 0) {
    a.h[qi] = h_t;
    a.rho[qi] = a.m[0] * wsum;
    a.ok[qi] = (nfound >= a.kh && rk2 <= r2) ? T(1) : T(0);
  }
  return false;
}

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
  // The collect pass's staging: the same compaction, with the loads of
  // AHEAD steps of 256 slots issued before their compaction steps, so one
  // memory latency serves them all (AHEAD * 256 covers the staging width,
  // 2048 slots in float32 and 1024 in float64)
  auto stage_ahead = [&](int c0) {
    constexpr int AHEAD = sizeof(T) == 4 ? 8 : 4;
    const int c1 = (c0 + a.chunk < a.cw) ? c0 + a.chunk : a.cw;
    int kept = 0;
    for (int s0 = c0; s0 < c1; s0 += AHEAD * TILE_THREADS) {
      bool keep[AHEAD];
      T x[AHEAD], y[AHEAD], z[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int j = s0 + u * TILE_THREADS + tid;
        keep[u] = j < c1 && cm[j] > T(0);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int j = s0 + u * TILE_THREADS + tid;
        x[u] = keep[u] ? cx[j] : T(0);
        y[u] = keep[u] ? cy[j] : T(0);
        z[u] = keep[u] ? cz[j] : T(0);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (s0 + u * TILE_THREADS >= c1) break;  // the same for the whole block
        const int p = compact_slot(keep[u], kept, wcount);
        if (keep[u]) {
          sx[p] = x[u];
          sy[p] = y[u];
          sz[p] = z[u];
        }
      }
    }
    __syncthreads();
    return kept;
  };
  const bool resident = a.chunk >= a.cw;
  const int n_resident = resident ? stage_ahead(0) : 0;

  // Every thread stays to the end (streaming stages the row again on each
  // pass); only the lanes of a query slot that a pass is for compute.
  const T qx = qvalid ? (MONO ? cx[centre + q] : a.qx[qi]) : T(0);
  const T qy = qvalid ? (MONO ? cy[centre + q] : a.qy[qi]) : T(0);
  const T qz = qvalid ? (MONO ? cz[centre + q] : a.qz[qi]) : T(0);
  const T r2 = qvalid ? (MONO ? a.reach2[0] : a.reach2[qi]) : T(0);

  // the collect pass and the list's passes; the full-row sweep below
  // computes only for the queries that overflowed their list
  const bool sweep = collect_and_bisect(a, sx, sy, sz, stage_ahead, resident, n_resident, qvalid,
                                        q, qi, sub, qx, qy, qz, r2);
  if (sweep && sub == 0) atomicAdd(a.n_over, 1);
  if (!__syncthreads_or(sweep)) return;

  // One pass over the row's occupied candidates. Lane `sub` of a query takes
  // the candidates whose index in the compacted row is sub mod 8, in order,
  // whether the row is resident or streamed in pieces: every lane sums the
  // same terms in the same order either way, so the results do not depend on
  // the mode.
#define SPH_FOR_EACH_CAND(...)                                                   \
  for (int c0 = 0, base = 0; c0 < a.cw; c0 += a.chunk) {                        \
    const int kept = resident ? n_resident : stage(c0);                         \
    if (sweep) {                                                                \
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
    if (sweep) {
      cnt = group_sum<int>(cnt);
      const bool ge = cnt >= a.kh;  // k-th distance <= mid: shrink to [lo, mid]
      lo = ge ? lo : mid;
      hi = ge ? mid : hi;
    }
  }

  T rk2 = T(0);
  SPH_FOR_EACH_CAND(if (d2 <= hi && d2 > rk2) rk2 = d2;)
  if (sweep) rk2 = group_max<T>(rk2);

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
  if (q >= a.cap || !sweep) return;  // listed and masked-off queries have written theirs
  nfound = group_sum<int>(nfound);
  wsum = group_sum<T>(wsum);

  if (sub == 0) {
    a.h[qi] = h_t;
    a.rho[qi] = a.m[0] * wsum;
    a.ok[qi] = (nfound >= a.kh && rk2 <= r2) ? T(1) : T(0);
  }
}

// Dynamic shared memory of a launch: the staged planes and the lists of
// the block's query slots (min(cap, 32) of them).
template <typename T>
size_t phase_a_smem(const PhaseAArgs<T>& a) {
  const int slots = a.cap < QUERIES_PER_BLOCK ? a.cap : QUERIES_PER_BLOCK;
  return (size_t(3) * a.chunk + size_t(slots) * list_stride(a.list_len)) * sizeof(T);
}

template <typename T, bool MONO>
int launch_phase_a(PhaseAArgs<T> a, int n_cells, cudaStream_t stream) {
  if (n_cells <= 0) return 0;
  if (a.chunk <= 0 || a.list_len <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid(n_cells, (a.cap + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK);
  const size_t smem = phase_a_smem<T>(a);
  const int err = fits_one_cta(phase_a_kernel<T, MONO>, TILE_THREADS, smem);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(a.n_over, 0, sizeof(int), stream);
  if (e != cudaSuccess) return int(e);
  SPH_LAUNCH((phase_a_kernel<T, MONO>), grid, TILE_THREADS, smem, stream, a);
  return int(cudaGetLastError());
}

}  // namespace sph

namespace sph {

template <typename T>
int phase_a_from_ptrs(void* const* p, int n_cells, int cap, int cw, int kh, int n_bisect,
                      int stage, int list_len, cudaStream_t stream) {
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
  a.n_over = static_cast<int*>(p[13]);
  a.cap = cap;
  a.cw = cw;
  a.kh = kh;
  a.n_bisect = n_bisect;
  a.chunk = stage < cw ? stage : cw;
  a.list_len = list_len;
  return launch_phase_a<T, false>(a, n_cells, stream);
}

template <typename T>
int phase_a_tile_from_ptrs(void* const* p, int n_cells, int cap, int kh, int n_bisect, int stage,
                           int list_len, cudaStream_t stream) {
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
  a.n_over = static_cast<int*>(p[9]);
  a.cap = cap;
  a.cw = 27 * cap;
  a.kh = kh;
  a.n_bisect = n_bisect;
  a.chunk = stage < a.cw ? stage : a.cw;
  a.list_len = list_len;
  return launch_phase_a<T, true>(a, n_cells, stream);
}

}  // namespace sph

// ptrs: qx qy qz qm reach2 cx cy cz cm m h rho ok n_over (14 device
// pointers; m one element, n_over one int that the entry zeroes and the
// kernel adds its overflowed queries to). `stage` raw candidate slots are
// staged at a time (>= cw: the row stays resident), `list_len` is L, the
// in-radius candidates a query's list holds; the wrapper sizes both.
extern "C" int sph_phase_a_cells(void* const* ptrs, int n_cells, int cap, int cw, int kh,
                                 int n_bisect, int stage, int list_len, int is_double,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::phase_a_from_ptrs<double>(ptrs, n_cells, cap, cw, kh, n_bisect, stage,
                                                    list_len, s)
                   : sph::phase_a_from_ptrs<float>(ptrs, n_cells, cap, cw, kh, n_bisect, stage,
                                                   list_len, s);
}

// ptrs: s2 cx cy cz cm m h rho ok n_over (10 device pointers; s2 and m one
// element each; cx..cm (n_cells, 27 * cap), the outputs (n_cells, cap);
// n_over as above). The queries are slots 13 * cap .. 14 * cap of each
// candidate row; `stage` and `list_len` as above.
extern "C" int sph_phase_a_tile(void* const* ptrs, int n_cells, int cap, int kh, int n_bisect,
                                int stage, int list_len, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? sph::phase_a_tile_from_ptrs<double>(ptrs, n_cells, cap, kh, n_bisect, stage,
                                                   list_len, s)
             : sph::phase_a_tile_from_ptrs<float>(ptrs, n_cells, cap, kh, n_bisect, stage,
                                                  list_len, s);
}
