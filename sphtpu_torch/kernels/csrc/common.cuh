// Shared helpers for the hand-written Hopper kernels of sphtpu_torch.
//
// Every kernel source exports a plain C interface (loaded with ctypes):
// device pointers and the CUDA stream arrive as void*, the entry point
// launches on that stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() as an int (0 = launched).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <mutex>

#ifndef SPH_LAUNCH
#define SPH_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace sph {

// Per-type arithmetic. mul_rn/add_rn are the round-to-nearest intrinsics
// that the compiler never contracts into an FMA: the squared distance
// feeds <= comparisons (bisection counts, forward/reverse neighbour masks,
// the r_k <= reach certificate) that must agree bit for bit between the
// two tile kernels and with the plain PyTorch versions.
template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float rsqrt(float a) { return rsqrtf(a); }
  static __device__ __forceinline__ float sqrt(float a) { return sqrtf(a); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  // one approximate reciprocal (MUFU, ~1 ulp; a subnormal a flushes to 0):
  // only for arguments that are normal numbers by construction
  static __device__ __forceinline__ float rcp(float a) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(a));
    return y;
  }
  static __device__ __forceinline__ float big() { return FLT_MAX; }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double rsqrt(double a) { return ::rsqrt(a); }
  static __device__ __forceinline__ double sqrt(double a) { return ::sqrt(a); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double rcp(double a) { return 1.0 / a; }  // IEEE
  static __device__ __forceinline__ double big() { return DBL_MAX; }
};

// d2 = (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its
// own, the evaluation order of the plain versions.
template <typename T>
__device__ __forceinline__ T dist2(T dx, T dy, T dz) {
  return Num<T>::add_rn(
      Num<T>::add_rn(Num<T>::mul_rn(dx, dx), Num<T>::mul_rn(dy, dy)),
      Num<T>::mul_rn(dz, dz));
}

// Softened gravity of a pair at r <= 2 h_avg: (force over r, potential) of
// the cubic-spline kernel, Newtonian past q = 2.
template <typename W>
__device__ __forceinline__ void softened(W r, W inv_r, W h_avg, W inv_h, W& soft_g, W& soft_p) {
  const W q_g = r * inv_h;
  const W q2 = q_g * q_g;
  const W q3 = q2 * q_g;
  const W inv_h2 = inv_h * inv_h;
  const W inv_q = h_avg * inv_r;  // 1/q, 0 at self pairs
  if (q_g <= W(1)) {
    soft_g = inv_h2 * inv_h * (W(4.0 / 3.0) - W(1.2) * q2 + W(0.5) * q3);
    soft_p = inv_h * (W(2.0 / 3.0) * q2 - W(0.3) * q2 * q2 + W(0.1) * q2 * q3 - W(1.4));
  } else if (q_g <= W(2)) {
    soft_g = inv_h2 *
             (W(8.0 / 3.0) * q_g - W(3) * q2 + W(1.2) * q3 - q2 * q2 / W(6) -
              W(1.0 / 15.0) * inv_q * inv_q) *
             inv_r;
    soft_p = inv_h * (W(4.0 / 3.0) * q2 - q3 + W(0.3) * q2 * q2 - q2 * q3 / W(30) - W(1.6) +
                      W(1.0 / 15.0) * inv_q);
  } else {
    soft_g = inv_r * inv_r * inv_r;
    soft_p = -inv_r;
  }
}

// Newtonian - mesh shape (physics/mesh_gravity.newton_minus_mesh):
// f = erfc(z) + sqrt(2/pi) t exp(-z^2) and erfc(z), z = t / sqrt2, t = r /
// sigma, as exp(-z^2) times the erfcx polynomial.
template <typename W>
__device__ __forceinline__ void mesh_tail(W d2, W inv_r, W sigma, W& f, W& erfc_z) {
  const W t = d2 * inv_r / sigma;
  const W z = t * W(0.7071067811865476);
  const W u = z / (W(1) + z);
  W pp = W(2.3849380332e-01);
  pp = pp * u + W(-9.3397713762e-01);
  pp = pp * u + W(1.2579923862e+00);
  pp = pp * u + W(-8.1740263321e-01);
  pp = pp * u + W(4.6001262975e-01);
  pp = pp * u + W(4.3301822784e-02);
  pp = pp * u + W(-1.1974394197e-01);
  pp = pp * u + W(-1.1287916483e+00);
  pp = pp * u + W(1.0000047021e+00);
  const W e = Num<W>::exp(-z * z);
  erfc_z = e * pp;
  f = erfc_z + W(0.7978845608028654) * t * e;
}

// A close pair's two gravity corrections are taken as one term (ROADMAP
// D21) where d2 <= (h_q + h_c)^2 (the gravity mask r <= 2 h_avg, squared),
// d2 the explicitly rounded dist2 and every operation rounded on its own,
// so that K2's joint mode, the tail's skip mode and their plain versions
// (PyTorch's elementwise float operations round the same way) decide it
// alike on the same positions and effective h (h > 0 ? h : 1): a pair of
// the 27-cell stencil lies in exactly one of the two kernels.
template <typename T>
__device__ __forceinline__ bool joint_near(T d2, T h_q, T h_c) {
  const T hs = Num<T>::add_rn(h_q, h_c);
  return d2 <= Num<T>::mul_rn(hs, hs);
}

// The tile kernels give each query LANES_PER_QUERY consecutive lanes of a
// warp; a block of TILE_THREADS threads owns QUERIES_PER_BLOCK queries of
// one cell row.
constexpr int LANES_PER_QUERY = 8;
constexpr int TILE_THREADS = 256;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int QUERIES_PER_BLOCK = TILE_THREADS / LANES_PER_QUERY;

// Mask naming the LANES_PER_QUERY lanes of the calling thread's group: the
// lanes of one query always run together, other groups of the warp may
// have exited (masked-off queries).
__device__ __forceinline__ unsigned group_mask() {
  const int lane = threadIdx.x & 31;
  return ((1u << LANES_PER_QUERY) - 1u) << (lane & ~(LANES_PER_QUERY - 1));
}

template <typename T>
__device__ __forceinline__ T group_sum(T v) {
  const unsigned mask = group_mask();
#pragma unroll
  for (int o = LANES_PER_QUERY / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T group_max(T v) {
  const unsigned mask = group_mask();
#pragma unroll
  for (int o = LANES_PER_QUERY / 2; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(mask, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Block-wide, order-preserving compaction step: every thread of the block
// calls it with the flag of ONE input slot; returns the slot's position in
// the compacted list (valid only where keep is true) and advances `base`
// (uniform across the block) by the number kept. wcount is TILE_WARPS ints
// of shared memory. Two __syncthreads inside.
__device__ __forceinline__ int compact_slot(bool keep, int& base, int* wcount) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) wcount[warp] = __popc(ballot);
  __syncthreads();
  int off = base;
  int total = 0;
#pragma unroll
  for (int w = 0; w < TILE_WARPS; ++w) {
    const int c = wcount[w];
    if (w < warp) off += c;
    total += c;
  }
  const int pos = off + __popc(ballot & ((1u << lane) - 1u));
  base += total;
  __syncthreads();
  return pos;
}

// Code an entry point returns, instead of launching, when a kernel's
// registers or shared memory do not fit one CTA of this card (F2's guard).
constexpr int ERR_BUDGET = 900;

// F2: 0 when `threads` threads of `kernel` with `dyn_smem` bytes of dynamic
// shared memory (besides its static share) fit one CTA of the current
// device, ERR_BUDGET when they do not, or the CUDA error of a query. Where
// they fit, the kernel may then take `dyn_smem` bytes of dynamic shared
// memory. The kernel's attributes, the device's opt-in limit and the
// dynamic share granted are read or set once per (kernel, device) and kept.
template <typename K>
int fits_one_cta(K kernel, int threads, size_t dyn_smem) {
  struct Entry {
    const void* fn;
    int dev, max_threads, optin;
    size_t static_smem, granted;
  };
  static Entry cache[64];
  static int n_cached = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> guard(lock);
  Entry* hit = nullptr;
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev) hit = &cache[i];
  Entry fresh = {fn, dev, 0, 0, 0, 0};
  if (hit == nullptr) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return int(e);
    e = cudaDeviceGetAttribute(&fresh.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return int(e);
    fresh.max_threads = attr.maxThreadsPerBlock;
    fresh.static_smem = attr.sharedSizeBytes;
    hit = n_cached < 64 ? &(cache[n_cached++] = fresh) : &fresh;
  }
  if (hit->max_threads < threads || hit->static_smem + dyn_smem > size_t(hit->optin))
    return ERR_BUDGET;
  if (dyn_smem > hit->granted) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(dyn_smem));
    if (e != cudaSuccess) return int(e);
    hit->granted = dyn_smem;
  }
  return 0;
}

}  // namespace sph

// Text of a code returned by an entry point of this library.
extern "C" const char* sph_error_string(int code) {
  if (code == sph::ERR_BUDGET) return "the kernel does not fit one CTA of this card";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The current device's streaming multiprocessors and the shared memory a
// block may opt into: out[0], out[1]. The wrappers size their launches
// from them.
extern "C" int sph_device_limits(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return int(e);
}
