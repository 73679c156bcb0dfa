// p3m_tail: the mono-tile engine's P3M tail correction, (Newtonian - mesh
// shape) summed over the (2W+1)^3-cell stencil of every query slot.
//
// No TPU kernel of the reference computes this: sphtpu runs it as XLA
// (sphtpu/physics/tiles.py, phase C of tile_sph_forces). Per query slot:
// gx, gy, gz = m * sum cgp * (dx, dy, dz) and gphi = m * sum cpp over the
// occupied candidates of the stencil, with (cgp, cpp) =
// newton_minus_mesh(d2) — erfc(z) and the Gaussian term evaluated as
// exp(-z^2) times a degree-8 erfcx polynomial, z = r / (sqrt2 sigma). A
// candidate at d2 = 0 (the query itself) adds no force and phi +=
// sqrt(2/pi) / sigma: it cancels the mesh's smoothed self-interaction.
// Every (occupied query, occupied candidate) pair of the stencil counts:
// there is no radius cut.
//
// Bound on this card: operations (~48 per pair against four planes read
// once). Design:
// * `tail_pack_kernel`, one warp a cell of the padded grid, compacts the
//   cell's occupied slots in slot order into (x, y, z, slot) records and
//   counts them, so the mask stays general and an empty cell costs the
//   main kernel one count.
// * `tail_kernel`: one CTA a cell row. It
//   reads its stencil's (2W+1)^3 counts into an exclusive prefix in shared
//   memory, stages the stencil's occupied candidates once for all of the
//   cell's queries, `chunk` records at a time, and sweeps them with every
//   thread on its own queries: nq queries take QT = ceil(nq / R) threads
//   (R = 1, 2 or 4 queries a thread, in registers) times S = 256 / QT slices
//   of the staged candidates, so a 56-query cell keeps 252 of 256 threads
//   busy and a cell filled to cap (<= 256) still fits. Lanes of a warp
//   read the same candidate (a shared-memory broadcast).
// * Arithmetic: no division by sigma in the body (1/(sqrt2 sigma), the
//   exponent's scale and sqrt(2/pi)/sigma are computed once a thread);
//   float32 takes rsqrt, u = z / (1 + z) and exp(-z^2) = exp2(d2 ce) by one
//   MUFU operation each (flush-to-zero forms); float64 keeps the IEEE
//   division, rsqrt and exp.
// * Fixed order, no atomics: a thread sums its candidates in staging order,
//   the S slice partials of a query are added in slice order through shared
//   memory. Two launches on the same inputs give the same bits.
// Skip mode (SKIP; with K2's joint mode, float32 under P3M, ROADMAP D21):
// a fifth plane holds each slot's h; the packing pass writes each occupied
// slot's effective h (h > 0 ? h : 1) beside its record, and the sweep leaves
// out every pair of the inner 27 cells (|d| <= 1 in each axis) for which
// `joint_near` holds (common.cuh; d2 from dist2): K2 takes those pairs'
// term 2 jointly with term 1, the self slot's sqrt(2/pi)/sigma included.
// The staged candidates carry their effective h, or -1 outside the inner
// 27 cells. Without SKIP the kernel is the one above, bit for bit.
#include "common.cuh"

namespace sph {

constexpr int TAIL_THREADS = 256;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;

// an occupied slot: position and its slot number within the cell
template <typename T>
struct alignas(16) Slot4 {
  T x, y, z, slot;
};

template <typename T>
struct TailArgs {
  const T* p[5];      // x y z mask (and h, skip mode) planes, each (gpc, gpc, gpc * cap)
  const T* scal;      // m, sigma on the device
  T* out[4];          // gx gy gz gphi, each (grid^3, cap)
  Slot4<T>* packed;   // (gpc^3, cap) scratch: each cell's occupied slots
  T* packed_h;        // (gpc^3, cap) scratch, skip mode: their effective h
  int* count;         // (gpc^3) scratch: occupied slots a cell
  int grid;
  int cap;
  int w;              // stencil half-width in cells
  int chunk;          // candidate records staged at a time
};

// Dynamic shared memory of `tail_kernel`: the staged records (reused for
// the slice partials, at most 4 x 4 x TAIL_THREADS values, which chunk >=
// 1024 leaves room for), in skip mode their h, and the stencil's count
// prefix.
template <typename T>
size_t tail_smem(int w, int chunk, bool skip) {
  const int span = 2 * w + 1;
  return size_t(chunk) * (sizeof(Slot4<T>) + (skip ? sizeof(T) : 0)) +
         size_t(span * span * span + 1) * sizeof(int);
}

template <typename T, bool SKIP>
__global__ void __launch_bounds__(TAIL_THREADS) tail_pack_kernel(TailArgs<T> a, long n_pad) {
  const long cell = long(blockIdx.x) * TAIL_WARPS + (threadIdx.x >> 5);
  if (cell >= n_pad) return;
  const int lane = threadIdx.x & 31;
  const long base = cell * a.cap;  // a padded cell's slots are contiguous
  int n = 0;
  for (int s0 = 0; s0 < a.cap; s0 += 32) {
    const int s = s0 + lane;
    const bool keep = s < a.cap && a.p[3][base + s] > T(0);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int k = n + __popc(ballot & ((1u << lane) - 1u));
      a.packed[base + k] = Slot4<T>{a.p[0][base + s], a.p[1][base + s], a.p[2][base + s], T(s)};
      if (SKIP) {
        const T h = a.p[4][base + s];
        a.packed_h[base + k] = h > T(0) ? h : T(1);
      }
    }
    n += __popc(ballot);
  }
  if (lane == 0) a.count[cell] = n;
}

template <typename T>
struct TailConst {
  T cz;        // 1 / (sqrt2 sigma): z = r cz
  T ce;        // exp(-z^2) = exp2(d2 ce) in float32, exp(d2 ce) in float64
  T self_phi;  // sqrt(2/pi) / sigma
};

// float32's MUFU forms without the subnormal handling: rsqrt of a normal
// d2, and exp2 of d2 ce <= 0 (a result below FLT_MIN flushes to 0).
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One pair's (Newtonian - mesh) terms added to (gx, gy, gz, gp). In
// float32 a d2 below FLT_MIN (a pair closer than 1.1e-19) counts as the
// self slot, as d2 = 0 does.
//
// SKIP: the pair is left out where the candidate's staged h (-1 outside the
// inner 27 cells) is positive and joint_near(d2, qh, ch) holds.
template <typename T, bool SKIP>
__device__ __forceinline__ void tail_pair(T dx, T dy, T dz, T qh, T ch, const TailConst<T>& k,
                                          T& gx, T& gy, T& gz, T& gp) {
  T d2;
  if constexpr (SKIP) {
    d2 = dist2<T>(dx, dy, dz);
    if (ch > T(0) && joint_near<T>(d2, qh, ch)) return;  // K2's joint term holds it
  } else {
    d2 = dx * dx + dy * dy + dz * dz;
  }
  const bool sep = sizeof(T) == 4 ? d2 >= T(FLT_MIN) : d2 > T(0);
  T inv_r, u, e;
  if constexpr (sizeof(T) == 4) {
    inv_r = sep ? rsqrt_ftz(d2) : T(0);  // the self slot: no force
  } else {
    inv_r = sep ? Num<T>::rsqrt(d2) : T(0);
  }
  const T z = d2 * inv_r * k.cz;
  if constexpr (sizeof(T) == 4) {
    u = z * Num<T>::rcp(T(1) + z);  // 1 + z >= 1: never subnormal
    e = ex2_ftz(d2 * k.ce);
  } else {
    u = z / (T(1) + z);
    e = ::exp(d2 * k.ce);
  }
  T p = T(2.3849380332e-01);
  p = p * u + T(-9.3397713762e-01);
  p = p * u + T(1.2579923862e+00);
  p = p * u + T(-8.1740263321e-01);
  p = p * u + T(4.6001262975e-01);
  p = p * u + T(4.3301822784e-02);
  p = p * u + T(-1.1974394197e-01);
  p = p * u + T(-1.1287916483e+00);
  p = p * u + T(1.0000047021e+00);
  const T erfc_z = e * p;
  // sqrt(2/pi) t e with t = sqrt2 z
  const T f = erfc_z + T(1.1283791670955126) * z * e;
  const T cgp = f * (inv_r * inv_r * inv_r);
  gx += cgp * dx;
  gy += cgp * dy;
  gz += cgp * dz;
  gp += sep ? -erfc_z * inv_r : k.self_phi;
}

// Exclusive prefix of the stencil's per-cell counts into spre[0..ns], in
// (dz, dy, dx) order; spre[ns] = the stencil's occupied slots.
template <typename T>
__device__ void stencil_prefix(const TailArgs<T>& a, long corner, int* spre, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = 2 * a.w + 1;
  const int gpc = a.grid + 2 * a.w;
  const int ns = span * span * span;
  int carry = 0;
  for (int s0 = 0; s0 < ns; s0 += TAIL_THREADS) {
    const int s = s0 + tid;
    int v = 0;
    if (s < ns) {
      const int dz = s / (span * span), dy = (s / span) % span, dx = s % span;
      v = a.count[corner + (long(dz) * gpc + dy) * gpc + dx];
    }
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      incl += lane >= o ? x : 0;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int before = carry, total = carry;
#pragma unroll
    for (int k = 0; k < TAIL_WARPS; ++k) {
      before += k < warp ? wsum[k] : 0;
      total += wsum[k];
    }
    if (s < ns) spre[s] = before + incl - v;
    carry = total;
    __syncthreads();  // wsum is rewritten next
  }
  if (tid == 0) spre[ns] = carry;
  __syncthreads();
}

// The sweep of one cell row with R queries a thread; see the header.
template <typename T, int R, bool SKIP>
__device__ void tail_sweep(const TailArgs<T>& a, const TailConst<T>& kc, Slot4<T>* sc, T* sh,
                           const int* spre, long row, long own, long corner, int nq) {
  const int tid = threadIdx.x;
  const int span = 2 * a.w + 1;
  const int gpc = a.grid + 2 * a.w;
  const int ns = span * span * span;
  const int qt = (nq + R - 1) / R;
  const int n_slices = TAIL_THREADS / qt;
  const bool worker = tid < qt * n_slices;
  const int qa = tid % qt;
  const int slice = tid / qt;

  T qx[R], qy[R], qz[R], qh[R], acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = qa + r * qt;
    qx[r] = qy[r] = qz[r] = T(0);
    qh[r] = T(1);
    if (worker && k < nq) {
      const Slot4<T> q = a.packed[own * a.cap + k];
      qx[r] = q.x;
      qy[r] = q.y;
      qz[r] = q.z;
      if (SKIP) qh[r] = a.packed_h[own * a.cap + k];
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[r][f] = T(0);
  }

  const int nc = spre[ns];
  for (int c0 = 0; c0 < nc; c0 += a.chunk) {
    const int n_here = min(a.chunk, nc - c0);
    for (int i = tid; i < n_here; i += TAIL_THREADS) {
      const int gi = c0 + i;
      int lo = 0, hi = ns;  // spre[lo] <= gi < spre[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (spre[mid] <= gi) lo = mid;
        else hi = mid;
      }
      const int dz = lo / (span * span), dy = (lo / span) % span, dx = lo % span;
      const long cell = corner + (long(dz) * gpc + dy) * gpc + dx;
      sc[i] = a.packed[cell * a.cap + (gi - spre[lo])];
      if (SKIP) {
        const int w = a.w;
        const bool inner = abs(dz - w) <= 1 && abs(dy - w) <= 1 && abs(dx - w) <= 1;
        sh[i] = inner ? a.packed_h[cell * a.cap + (gi - spre[lo])] : T(-1);
      }
    }
    __syncthreads();
    if (worker) {
      for (int j = slice; j < n_here; j += n_slices) {
        const Slot4<T> c = sc[j];
        const T ch = SKIP ? sh[j] : T(-1);
#pragma unroll
        for (int r = 0; r < R; ++r)
          tail_pair<T, SKIP>(qx[r] - c.x, qy[r] - c.y, qz[r] - c.z, qh[r], ch, kc, acc[r][0],
                             acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();  // the records are overwritten next
  }

  // slice partials through shared memory, added in slice order
  T* part = reinterpret_cast<T*>(sc);
  const int stride = qt * R;
  if (worker) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = qa + r * qt;
      if (k < nq) {
#pragma unroll
        for (int f = 0; f < 4; ++f) part[(f * n_slices + slice) * stride + k] = acc[r][f];
      }
    }
  }
  __syncthreads();
  if (tid < nq) {
    const T m = a.scal[0];
    const long o = row * a.cap + int(a.packed[own * a.cap + tid].slot);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      T v = T(0);
      for (int s = 0; s < n_slices; ++s) v += part[(f * n_slices + s) * stride + tid];
      a.out[f][o] = m * v;
    }
  }
}

template <typename T, bool SKIP>
__global__ void __launch_bounds__(TAIL_THREADS) tail_kernel(TailArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Slot4<T>* sc = reinterpret_cast<Slot4<T>*>(smem_raw);
  T* sh = reinterpret_cast<T*>(sc + a.chunk);  // (chunk) in skip mode
  int* spre = reinterpret_cast<int*>(sh + (SKIP ? a.chunk : 0));
  __shared__ int wsum[TAIL_WARPS];

  const int g = a.grid;
  const long row = blockIdx.x;
  const int ix = int(row % g);
  const int iy = int((row / g) % g);
  const int iz = int(row / (long(g) * g));
  const int gpc = g + 2 * a.w;
  const long corner = (long(iz) * gpc + iy) * gpc + ix;
  const long own = (long(iz + a.w) * gpc + (iy + a.w)) * gpc + (ix + a.w);
  const int tid = threadIdx.x;

  // unoccupied query slots: zeros
  if (tid < a.cap && !(a.p[3][own * a.cap + tid] > T(0))) {
#pragma unroll
    for (int f = 0; f < 4; ++f) a.out[f][row * a.cap + tid] = T(0);
  }
  const int nq = a.count[own];
  if (nq == 0) return;  // uniform over the CTA

  const T sigma = a.scal[1];
  TailConst<T> kc;
  kc.cz = T(0.7071067811865476) / sigma;
  kc.ce = (sizeof(T) == 4 ? T(-0.7213475204444817) : T(-0.5)) / (sigma * sigma);  // log2(e)/2
  kc.self_phi = T(0.7978845608028654) / sigma;

  stencil_prefix<T>(a, corner, spre, wsum);
  // R in 1, 2, 4: the fewest candidate sweeps a thread, R / S (the
  // smaller R on a tie)
  const int s1 = TAIL_THREADS / nq;
  const int s2 = TAIL_THREADS / ((nq + 1) / 2);
  const int s4 = TAIL_THREADS / ((nq + 3) / 4);
  if (s4 > 2 * s2 && s4 > 4 * s1) {
    tail_sweep<T, 4, SKIP>(a, kc, sc, sh, spre, row, own, corner, nq);
  } else if (s2 > 2 * s1) {
    tail_sweep<T, 2, SKIP>(a, kc, sc, sh, spre, row, own, corner, nq);
  } else {
    tail_sweep<T, 1, SKIP>(a, kc, sc, sh, spre, row, own, corner, nq);
  }
}

template <typename T, bool SKIP>
int launch_tail(const TailArgs<T>& a, int nz, cudaStream_t stream) {
  const size_t smem = tail_smem<T>(a.w, a.chunk, SKIP);
  int err = fits_one_cta(tail_pack_kernel<T, SKIP>, TAIL_THREADS, 0);
  if (err) return err;
  err = fits_one_cta(tail_kernel<T, SKIP>, TAIL_THREADS, smem);
  if (err) return err;
  const long gpc = a.grid + 2 * a.w;
  const long n_pad = (nz + 2L * a.w) * gpc * gpc;
  SPH_LAUNCH((tail_pack_kernel<T, SKIP>), unsigned((n_pad + TAIL_WARPS - 1) / TAIL_WARPS),
             TAIL_THREADS, 0, stream, a, n_pad);
  SPH_LAUNCH((tail_kernel<T, SKIP>), unsigned(nz) * a.grid * a.grid, TAIL_THREADS, smem, stream,
             a);
  return int(cudaGetLastError());
}

template <typename T>
int p3m_tail_from_ptrs(void* const* planes, const void* scal, void* const* out, void* packed,
                       void* packed_h, void* count, int grid, int nz, int cap, int w, int chunk,
                       int skip, cudaStream_t stream) {
  if (grid <= 0 || nz <= 0) return 0;
  if (cap > TAIL_THREADS || w < 1 || chunk < 4 * TAIL_THREADS) return ERR_BUDGET;
  TailArgs<T> a;
  for (int k = 0; k < 4; ++k) {
    a.p[k] = static_cast<const T*>(planes[k]);
    a.out[k] = static_cast<T*>(out[k]);
  }
  a.p[4] = skip ? static_cast<const T*>(planes[4]) : nullptr;
  a.scal = static_cast<const T*>(scal);
  a.packed = static_cast<Slot4<T>*>(packed);
  a.packed_h = static_cast<T*>(packed_h);
  a.count = static_cast<int*>(count);
  a.grid = grid;
  a.cap = cap;
  a.w = w;
  a.chunk = chunk;
  return skip ? launch_tail<T, true>(a, nz, stream) : launch_tail<T, false>(a, nz, stream);
}

}  // namespace sph

// planes: 4 device pointers (x y z mask, each (nz + 2w) * (grid + 2w) *
// (grid + 2w) * cap, the particles at their slots with a w-cell halo of
// zeros), 5 with skip (then h); the query cells are nz layers of grid x
// grid (nz = grid on the mono-tile engine's cube, the slab's query layers
// on the z-slab engine); scal: device pointer to (m, sigma); out: 4 device
// pointers (gx gy gz gphi, each (nz * grid^2, cap)); packed: (nz + 2w)
// (grid + 2w)^2 * cap records of 4 values, packed_h (skip only, else
// unused): as many values, count: (nz + 2w) (grid + 2w)^2 int32, all
// scratch; chunk: records staged at a time (>= 1024); skip: 1 leaves out
// the pairs K2's joint mode takes. Returns ERR_BUDGET for cap > 256 or
// where the shared memory of (w, chunk) does not fit one CTA.
extern "C" int sph_p3m_tail(void* const* planes, const void* scal, void* const* out, void* packed,
                            void* packed_h, void* count, int grid, int nz, int cap, int w,
                            int chunk, int skip, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::p3m_tail_from_ptrs<double>(planes, scal, out, packed, packed_h, count,
                                                     grid, nz, cap, w, chunk, skip, s)
                   : sph::p3m_tail_from_ptrs<float>(planes, scal, out, packed, packed_h, count,
                                                    grid, nz, cap, w, chunk, skip, s);
}
