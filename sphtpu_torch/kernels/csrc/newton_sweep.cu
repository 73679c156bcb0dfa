// newton_sweep: pure-Newtonian all-pairs gravity,
//   g_i = m sum_j (x_i - x_j) / r^3,  phi_i = -m sum_j 1 / r,
// pairs with r^2 = 0 (the self pair, coincident points) excluded.
//
// Replaces the TPU kernel sphtpu/kernels/pallas_gravity.py::
// newton_sweep_pallas (_newton_kernel), the kernel form of
// physics/gravity.py::gravity_newton_allpairs.
//
// Bound on this card: operations — N^2 pairs of about 20 flops (one
// reciprocal square root among them) against 16 N bytes in and 16 N out.
// The issue slots limit it: 12 FP32 instructions, the compare and select
// of the pair rule and one MUFU rsqrt a pair. In float32 the rsqrt is the
// MUFU instruction itself (`rsqrt_mufu`): rsqrtf adds a denormal rescaling
// (a compare, two multiplies, predicate moves) that took about 6 more
// issue slots a pair; the two agree bit for bit on every normal r^2.
// Design: the shared-memory-tiled N-body sweep, shaped to fill the card.
// - Each thread accumulates R rows (rows t, t + threads, ... of its CTA's
//   threads * R rows) in registers, so one staged column serves R pairs.
// - A column is staged as one 16-byte vector (x, y, z, 0), read by every
//   thread of the CTA at once: one broadcast load a column (two 16-byte
//   loads in float64).
// - The columns are split into S slices of `slice_cols` each, the grid is
//   (ceil(N / (threads * R)), S), so several waves of CTAs cover 132 SMs
//   at N = 1e5. Each slice writes its partial sums to a scratch (S, N, 4);
//   a second kernel adds them in the fixed order s = 0 .. S - 1 and
//   applies m. No atomics: the outputs repeat from run to run. With S = 1
//   the sweep writes g and phi itself.
// No padding columns exist: the last tile of a slice is cut at its end.
#include "common.cuh"

namespace sph {

constexpr int NB_MAX_THREADS = 256;

template <typename T>
struct __align__(16) Col4 {
  T x, y, z, w;
};

// 1 / sqrt(r2) for the pair rule: MUFU.RSQ in float32 (rsqrtf's value on
// every normal r2; a denormal r2, |x_i - x_j| < 1.1e-19, gives +inf where
// rsqrtf gives ~1e19, and inv^3 overflows to inf under both), ::rsqrt in
// float64.
__device__ __forceinline__ float rsqrt_mufu(float r2) {
  float inv;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(r2));
  return inv;
}
__device__ __forceinline__ double rsqrt_mufu(double r2) { return ::rsqrt(r2); }

template <typename T, int R, bool SPLIT>
__global__ void __launch_bounds__(NB_MAX_THREADS)
    newton_sweep_kernel(const T* __restrict__ pos, const T* __restrict__ m_ptr,
                        T* __restrict__ g, T* __restrict__ phi, Col4<T>* __restrict__ part,
                        int n, int slice_cols) {
  __shared__ Col4<T> sc[NB_MAX_THREADS];
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * nt * R + threadIdx.x;

  T xi[R], yi[R], zi[R], ax[R], ay[R], az[R], ap[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * nt;
    const long i3 = 3L * (i < n ? i : 0);
    xi[r] = pos[i3];
    yi[r] = pos[i3 + 1];
    zi[r] = pos[i3 + 2];
    ax[r] = ay[r] = az[r] = ap[r] = T(0);
  }

  const int c_begin = blockIdx.y * slice_cols;
  const int c_end = (c_begin + slice_cols < n) ? c_begin + slice_cols : n;
  for (int j0 = c_begin; j0 < c_end; j0 += nt) {
    const int j = j0 + threadIdx.x;
    if (j < c_end) sc[threadIdx.x] = Col4<T>{pos[3L * j], pos[3L * j + 1], pos[3L * j + 2], T(0)};
    __syncthreads();
    const int len = (c_end - j0 < nt) ? c_end - j0 : nt;
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      const Col4<T> c = sc[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T dx = xi[r] - c.x;
        const T dy = yi[r] - c.y;
        const T dz = zi[r] - c.z;
        const T r2 = dx * dx + dy * dy + dz * dz;
        const T inv_all = rsqrt_mufu(r2);
        const T inv = r2 > T(0) ? inv_all : T(0);
        const T inv3 = inv * inv * inv;
        ax[r] += inv3 * dx;
        ay[r] += inv3 * dy;
        az[r] += inv3 * dz;
        ap[r] -= inv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * nt;
    if (i >= n) continue;
    if (SPLIT) {
      part[long(blockIdx.y) * n + i] = Col4<T>{ax[r], ay[r], az[r], ap[r]};
    } else {
      const T m = m_ptr[0];
      g[3L * i] = m * ax[r];
      g[3L * i + 1] = m * ay[r];
      g[3L * i + 2] = m * az[r];
      phi[i] = m * ap[r];
    }
  }
}

// g = m * (sum over s of the partial sums), phi likewise, s in order.
template <typename T>
__global__ void newton_reduce_kernel(const Col4<T>* __restrict__ part,
                                     const T* __restrict__ m_ptr, T* __restrict__ g,
                                     T* __restrict__ phi, int n, int n_slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Col4<T> acc = part[i];
  for (int s = 1; s < n_slices; ++s) {
    const Col4<T> p = part[long(s) * n + i];
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  const T m = m_ptr[0];
  g[3L * i] = m * acc.x;
  g[3L * i + 1] = m * acc.y;
  g[3L * i + 2] = m * acc.z;
  phi[i] = m * acc.w;
}

template <typename T, int R>
int launch_sweep(const T* pos, const T* m, T* g, T* phi, Col4<T>* part, int n, int threads,
                 int n_slices, int slice_cols, cudaStream_t stream) {
  const dim3 grid((n + threads * R - 1) / (threads * R), n_slices);
  if (n_slices == 1) {
    const int err = fits_one_cta(newton_sweep_kernel<T, R, false>, threads, 0);
    if (err) return err;
    SPH_LAUNCH((newton_sweep_kernel<T, R, false>), grid, threads, 0, stream, pos, m, g, phi,
               part, n, slice_cols);
    return int(cudaGetLastError());
  }
  const int err = fits_one_cta(newton_sweep_kernel<T, R, true>, threads, 0);
  if (err) return err;
  SPH_LAUNCH((newton_sweep_kernel<T, R, true>), grid, threads, 0, stream, pos, m, g, phi, part,
             n, slice_cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  SPH_LAUNCH((newton_reduce_kernel<T>), (n + 255) / 256, 256, 0, stream, part, m, g, phi, n,
             n_slices);
  return int(cudaGetLastError());
}

template <typename T>
int launch_newton(const void* pos, const void* m, void* g, void* phi, void* part, int n, int rows,
                  int threads, int n_slices, int slice_cols, cudaStream_t stream) {
  if (n <= 0) return 0;
  // the plan must cover every column once, with a scratch where S > 1
  if (threads <= 0 || threads > NB_MAX_THREADS || threads % 32 != 0 || n_slices < 1 ||
      slice_cols < 1 || long(n_slices) * slice_cols < n ||
      long(n_slices - 1) * slice_cols >= n || (n_slices > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(pos);
  const T* mm = static_cast<const T*>(m);
  T* gg = static_cast<T*>(g);
  T* ph = static_cast<T*>(phi);
  Col4<T>* pt = static_cast<Col4<T>*>(part);
  switch (rows) {
    case 1: return launch_sweep<T, 1>(p, mm, gg, ph, pt, n, threads, n_slices, slice_cols, stream);
    case 2: return launch_sweep<T, 2>(p, mm, gg, ph, pt, n, threads, n_slices, slice_cols, stream);
    case 4: return launch_sweep<T, 4>(p, mm, gg, ph, pt, n, threads, n_slices, slice_cols, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Rows x columns: the same sweep with the rows and the columns apart,
//   g_i = m sum_j w_j (x_i - x_j) / r^3,  phi_i = -m sum_j w_j / r,
// w_j = 1 where col_weight[j] > 0 (all columns where col_weight is null),
// pairs with r^2 = 0 excluded. It serves the sharded engines' far field:
// a shard's rows against a block of columns that rotates over the ring
// (exact gravity of the z-slab engine), and 1/P of the rows against all N
// (the work-sharded engines). Only the first n_rows rows and n_cols
// columns are swept: a shard's padding rows and columns (the slab layout
// keeps each shard's real rows first) cost nothing.
// Bound: operations, n_rows x n_cols pairs of ~20 flops. Design: K3's, R
// rows a thread and S column slices whose partial sums the reduce kernel
// adds in slice order; a staged column carries its weight in its 4th lane.
template <typename T, int R, bool SPLIT>
__global__ void __launch_bounds__(NB_MAX_THREADS)
    newton_rows_cols_kernel(const T* __restrict__ rows, const T* __restrict__ cols,
                            const T* __restrict__ wcol, const T* __restrict__ m_ptr,
                            T* __restrict__ g, T* __restrict__ phi,
                            Col4<T>* __restrict__ part, int n_rows, int n_cols,
                            int slice_cols) {
  __shared__ Col4<T> sc[NB_MAX_THREADS];
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * nt * R + threadIdx.x;

  T xi[R], yi[R], zi[R], ax[R], ay[R], az[R], ap[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * nt;
    const long i3 = 3L * (i < n_rows ? i : 0);
    xi[r] = rows[i3];
    yi[r] = rows[i3 + 1];
    zi[r] = rows[i3 + 2];
    ax[r] = ay[r] = az[r] = ap[r] = T(0);
  }

  const int c_begin = blockIdx.y * slice_cols;
  const int c_end = (c_begin + slice_cols < n_cols) ? c_begin + slice_cols : n_cols;
  for (int j0 = c_begin; j0 < c_end; j0 += nt) {
    const int j = j0 + threadIdx.x;
    if (j < c_end) {
      const T w = (wcol == nullptr || wcol[j] > T(0)) ? T(1) : T(0);
      sc[threadIdx.x] = Col4<T>{cols[3L * j], cols[3L * j + 1], cols[3L * j + 2], w};
    }
    __syncthreads();
    const int len = (c_end - j0 < nt) ? c_end - j0 : nt;
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      const Col4<T> c = sc[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T dx = xi[r] - c.x;
        const T dy = yi[r] - c.y;
        const T dz = zi[r] - c.z;
        const T r2 = dx * dx + dy * dy + dz * dz;
        const T inv_all = rsqrt_mufu(r2);
        const T inv = (r2 > T(0) && c.w != T(0)) ? inv_all : T(0);
        const T inv3 = inv * inv * inv;
        ax[r] += inv3 * dx;
        ay[r] += inv3 * dy;
        az[r] += inv3 * dz;
        ap[r] -= inv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * nt;
    if (i >= n_rows) continue;
    if (SPLIT) {
      part[long(blockIdx.y) * n_rows + i] = Col4<T>{ax[r], ay[r], az[r], ap[r]};
    } else {
      const T m = m_ptr[0];
      g[3L * i] = m * ax[r];
      g[3L * i + 1] = m * ay[r];
      g[3L * i + 2] = m * az[r];
      phi[i] = m * ap[r];
    }
  }
}

template <typename T, int R>
int launch_rows_cols(const T* rows, const T* cols, const T* w, const T* m, T* g, T* phi,
                     Col4<T>* part, int n_rows, int n_cols, int threads, int n_slices,
                     int slice_cols, cudaStream_t stream) {
  const dim3 grid((n_rows + threads * R - 1) / (threads * R), n_slices);
  if (n_slices == 1) {
    const int err = fits_one_cta(newton_rows_cols_kernel<T, R, false>, threads, 0);
    if (err) return err;
    SPH_LAUNCH((newton_rows_cols_kernel<T, R, false>), grid, threads, 0, stream, rows, cols, w,
               m, g, phi, part, n_rows, n_cols, slice_cols);
    return int(cudaGetLastError());
  }
  const int err = fits_one_cta(newton_rows_cols_kernel<T, R, true>, threads, 0);
  if (err) return err;
  SPH_LAUNCH((newton_rows_cols_kernel<T, R, true>), grid, threads, 0, stream, rows, cols, w, m,
             g, phi, part, n_rows, n_cols, slice_cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  SPH_LAUNCH((newton_reduce_kernel<T>), (n_rows + 255) / 256, 256, 0, stream, part, m, g, phi,
             n_rows, n_slices);
  return int(cudaGetLastError());
}

template <typename T>
int launch_newton_rc(const void* rows, const void* cols, const void* w, const void* m, void* g,
                     void* phi, void* part, int n_rows, int n_cols, int r_rows, int threads,
                     int n_slices, int slice_cols, cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  if (threads <= 0 || threads > NB_MAX_THREADS || threads % 32 != 0 || n_slices < 1 ||
      slice_cols < 1 || n_cols < 0 || long(n_slices) * slice_cols < n_cols ||
      (n_cols > 0 && long(n_slices - 1) * slice_cols >= n_cols) ||
      (n_slices > 1 && part == nullptr))
    return int(cudaErrorInvalidValue);
  const T* pr = static_cast<const T*>(rows);
  const T* pc = static_cast<const T*>(cols);
  const T* pw = static_cast<const T*>(w);
  const T* mm = static_cast<const T*>(m);
  T* gg = static_cast<T*>(g);
  T* ph = static_cast<T*>(phi);
  Col4<T>* pt = static_cast<Col4<T>*>(part);
  switch (r_rows) {
    case 1:
      return launch_rows_cols<T, 1>(pr, pc, pw, mm, gg, ph, pt, n_rows, n_cols, threads,
                                    n_slices, slice_cols, stream);
    case 2:
      return launch_rows_cols<T, 2>(pr, pc, pw, mm, gg, ph, pt, n_rows, n_cols, threads,
                                    n_slices, slice_cols, stream);
    case 4:
      return launch_rows_cols<T, 4>(pr, pc, pw, mm, gg, ph, pt, n_rows, n_cols, threads,
                                    n_slices, slice_cols, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace sph

// pos (n, 3) row-major, m one element, g (n, 3), phi (n), part (n_slices,
// n, 4) scratch (unused, may be null, when n_slices == 1): device pointers.
// The plan (rows a thread, threads a CTA, column slices and their width)
// comes from the wrapper's split_plan.
extern "C" int sph_newton_sweep(const void* pos, const void* m, void* g, void* phi, void* part,
                                int n, int rows, int threads, int n_slices, int slice_cols,
                                int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::launch_newton<double>(pos, m, g, phi, part, n, rows, threads, n_slices,
                                                slice_cols, s)
                   : sph::launch_newton<float>(pos, m, g, phi, part, n, rows, threads, n_slices,
                                               slice_cols, s);
}

// rows (>= n_rows, 3) and cols (>= n_cols, 3) row-major, col_weight
// (>= n_cols) or null, m one element, g (n_rows, 3), phi (n_rows), part
// (n_slices, n_rows, 4) scratch (may be null when n_slices == 1): device
// pointers. Rows past n_rows are not written.
extern "C" int sph_newton_rows_cols(const void* rows, const void* cols, const void* col_weight,
                                    const void* m, void* g, void* phi, void* part, int n_rows,
                                    int n_cols, int r_rows, int threads, int n_slices,
                                    int slice_cols, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? sph::launch_newton_rc<double>(rows, cols, col_weight, m, g, phi, part, n_rows,
                                             n_cols, r_rows, threads, n_slices, slice_cols, s)
             : sph::launch_newton_rc<float>(rows, cols, col_weight, m, g, phi, part, n_rows,
                                            n_cols, r_rows, threads, n_slices, slice_cols, s);
}
