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
//
// Bound on this card: operations (~50 per (query, occupied candidate)
// pair, one exp and two divisions among them) against four position/mask
// planes read once. Design, as phase_b_tiles: a block owns 32 queries of
// one cell, 8 lanes per query, accumulators in registers. The kernel reads
// the padded position planes (gpc, gpc, gpc * cap), gpc = grid + 2W,
// directly: a cell's stencil is (2W+1)^2 contiguous runs of (2W+1) * cap
// slots, so no candidate prestack (20 000 slots a row at W = 2, cap = 160)
// is ever built. The stencil is walked in chunks of CHUNK slots whose
// OCCUPIED entries are compacted, order kept, into shared memory; a block
// with no occupied query slot leaves before it stages anything. No
// atomics: the lanes of a query combine by warp shuffle at the end.
#include "common.cuh"

namespace sph {

constexpr int TAIL_CHUNK = 1024;  // stencil slots staged per pass (3 planes)

template <typename T>
struct TailArgs {
  const T* p[4];   // x y z mask planes, each (gpc, gpc, gpc * cap)
  const T* scal;   // m, sigma on the device
  T* out[4];       // gx gy gz gphi, each (grid^3, cap)
  int grid;
  int cap;
  int w;           // stencil half-width in cells
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS) p3m_tail_kernel(TailArgs<T> a) {
  __shared__ T s[3][TAIL_CHUNK];
  __shared__ int wcount[TILE_WARPS];

  const int g = a.grid;
  const long row = blockIdx.x;
  const int ix = int(row % g);
  const int iy = int((row / g) % g);
  const int iz = int(row / (long(g) * g));
  const int gpc = g + 2 * a.w;
  const long xs = long(gpc) * a.cap;  // slots of one (z, y) line
  const int span = 2 * a.w + 1;
  const int runlen = span * a.cap;
  const int cwc = span * span * runlen;

  const int tid = threadIdx.x;
  const int sub = tid % LANES_PER_QUERY;
  const int q = blockIdx.y * QUERIES_PER_BLOCK + tid / LANES_PER_QUERY;
  const long qo = row * a.cap + q;  // output slot
  const long qp = (long(iz + a.w) * gpc + (iy + a.w)) * xs + long(ix + a.w) * a.cap + q;
  const bool active = q < a.cap && a.p[3][qp] > T(0);

  if (!__syncthreads_or(active)) {
    if (q < a.cap && sub == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a.out[k][qo] = T(0);
    }
    return;
  }

  const T m = a.scal[0];
  const T sigma = a.scal[1];
  T qx = T(0), qy = T(0), qz = T(0);
  if (active) {
    qx = a.p[0][qp];
    qy = a.p[1][qp];
    qz = a.p[2][qp];
  }
  const long corner = (long(iz) * gpc + iy) * xs + long(ix) * a.cap;

  T gx = T(0), gy = T(0), gz = T(0), gp = T(0);
  for (int c0 = 0; c0 < cwc; c0 += TAIL_CHUNK) {
    int ncand = 0;
    const int c1 = (c0 + TAIL_CHUNK < cwc) ? c0 + TAIL_CHUNK : cwc;
    for (int t0 = c0; t0 < c1; t0 += TILE_THREADS) {
      const int j = t0 + tid;
      long cj = 0;
      bool keep = false;
      if (j < c1) {
        const int run = j / runlen;
        const int off = j - run * runlen;
        cj = corner + (long(run / span) * gpc + (run % span)) * xs + off;
        keep = a.p[3][cj] > T(0);
      }
      const int p = compact_slot(keep, ncand, wcount);
      if (keep) {
        s[0][p] = a.p[0][cj];
        s[1][p] = a.p[1][cj];
        s[2][p] = a.p[2][cj];
      }
    }
    __syncthreads();

    if (active) {
      for (int j = sub; j < ncand; j += LANES_PER_QUERY) {
        const T dx = qx - s[0][j];
        const T dy = qy - s[1][j];
        const T dz = qz - s[2][j];
        const T d2 = dist2<T>(dx, dy, dz);
        if (d2 > T(0)) {
          const T inv_r = Num<T>::rsqrt(d2);
          const T t = d2 * inv_r / sigma;
          const T z = t * T(0.7071067811865476);
          const T u = z / (T(1) + z);
          T p = T(2.3849380332e-01);
          p = p * u + T(-9.3397713762e-01);
          p = p * u + T(1.2579923862e+00);
          p = p * u + T(-8.1740263321e-01);
          p = p * u + T(4.6001262975e-01);
          p = p * u + T(4.3301822784e-02);
          p = p * u + T(-1.1974394197e-01);
          p = p * u + T(-1.1287916483e+00);
          p = p * u + T(1.0000047021e+00);
          const T e = Num<T>::exp(-z * z);
          const T erfc_z = e * p;
          const T f = erfc_z + T(0.7978845608028654) * t * e;
          const T cgp = f * (inv_r * inv_r * inv_r);
          gx += cgp * dx;
          gy += cgp * dy;
          gz += cgp * dz;
          gp += -erfc_z * inv_r;
        } else {
          gp += T(0.7978845608028654) / sigma;
        }
      }
    }
    __syncthreads();  // the planes are overwritten by the next chunk
  }

  if (q >= a.cap) return;
  if (!active) {
    if (sub == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a.out[k][qo] = T(0);
    }
    return;
  }
  gx = group_sum<T>(gx);
  gy = group_sum<T>(gy);
  gz = group_sum<T>(gz);
  gp = group_sum<T>(gp);
  if (sub == 0) {
    a.out[0][qo] = m * gx;
    a.out[1][qo] = m * gy;
    a.out[2][qo] = m * gz;
    a.out[3][qo] = m * gp;
  }
}

template <typename T>
int p3m_tail_from_ptrs(void* const* planes, const void* scal, void* const* out, int grid,
                       int cap, int w, cudaStream_t stream) {
  if (grid <= 0) return 0;
  TailArgs<T> a;
  for (int k = 0; k < 4; ++k) {
    a.p[k] = static_cast<const T*>(planes[k]);
    a.out[k] = static_cast<T*>(out[k]);
  }
  a.scal = static_cast<const T*>(scal);
  a.grid = grid;
  a.cap = cap;
  a.w = w;
  const dim3 blocks(unsigned(grid) * grid * grid, (cap + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK);
  SPH_LAUNCH((p3m_tail_kernel<T>), blocks, TILE_THREADS, 0, stream, a);
  return int(cudaGetLastError());
}

}  // namespace sph

// planes: 4 device pointers (x y z mask, each (grid + 2w)^2 * (grid + 2w) * cap,
// the particles at their slots with a w-cell halo of zeros); scal: device
// pointer to (m, sigma); out: 4 device pointers (gx gy gz gphi, each
// (grid^3, cap)).
extern "C" int sph_p3m_tail(void* const* planes, const void* scal, void* const* out, int grid,
                            int cap, int w, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? sph::p3m_tail_from_ptrs<double>(planes, scal, out, grid, cap, w, s)
                   : sph::p3m_tail_from_ptrs<float>(planes, scal, out, grid, cap, w, s);
}
