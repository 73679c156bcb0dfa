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
// Design: the classic shared-memory-tiled N-body kernel. One thread per
// row particle keeps its position and four accumulators in registers; the
// block walks the columns in tiles of NB_THREADS positions staged in
// shared memory, every thread reading the same column at a time (a
// broadcast, no bank conflicts). No padding columns exist: the last tile
// is cut at n.
#include "common.cuh"

namespace sph {

constexpr int NB_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(NB_THREADS)
    newton_sweep_kernel(const T* __restrict__ pos, const T* __restrict__ m_ptr,
                        T* __restrict__ g, T* __restrict__ phi, int n) {
  __shared__ T sx[NB_THREADS];
  __shared__ T sy[NB_THREADS];
  __shared__ T sz[NB_THREADS];

  const int i = blockIdx.x * NB_THREADS + threadIdx.x;
  const bool live = i < n;
  const long i3 = 3L * (live ? i : 0);
  const T xi = pos[i3], yi = pos[i3 + 1], zi = pos[i3 + 2];
  T ax = T(0), ay = T(0), az = T(0), ap = T(0);

  for (int j0 = 0; j0 < n; j0 += NB_THREADS) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      sx[threadIdx.x] = pos[3L * j];
      sy[threadIdx.x] = pos[3L * j + 1];
      sz[threadIdx.x] = pos[3L * j + 2];
    }
    __syncthreads();
    const int nt = (n - j0 < NB_THREADS) ? n - j0 : NB_THREADS;
#pragma unroll 8
    for (int k = 0; k < nt; ++k) {
      const T dx = xi - sx[k];
      const T dy = yi - sy[k];
      const T dz = zi - sz[k];
      const T r2 = dx * dx + dy * dy + dz * dz;
      const T inv = r2 > T(0) ? Num<T>::rsqrt(r2) : T(0);
      const T inv3 = inv * inv * inv;
      ax += inv3 * dx;
      ay += inv3 * dy;
      az += inv3 * dz;
      ap -= inv;
    }
    __syncthreads();
  }

  if (live) {
    const T m = m_ptr[0];
    g[i3] = m * ax;
    g[i3 + 1] = m * ay;
    g[i3 + 2] = m * az;
    phi[i] = m * ap;
  }
}

template <typename T>
int launch_newton(const void* pos, const void* m, void* g, void* phi, int n,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + NB_THREADS - 1) / NB_THREADS;
  SPH_LAUNCH((newton_sweep_kernel<T>), grid, NB_THREADS, 0, stream,
             static_cast<const T*>(pos), static_cast<const T*>(m), static_cast<T*>(g),
             static_cast<T*>(phi), n);
  return int(cudaGetLastError());
}

}  // namespace sph

// pos (n, 3) row-major, m one element, g (n, 3), phi (n): device pointers.
extern "C" int sph_newton_sweep(const void* pos, const void* m, void* g, void* phi, int n,
                                int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::launch_newton<double>(pos, m, g, phi, n, s)
                   : sph::launch_newton<float>(pos, m, g, phi, n, s);
}
