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
// Bound on this card: operations (d2 and the mask tests on every (query,
// occupied candidate) pair, the ~140-flop body only on the pairs inside a
// mask — a few percent of a 27-cell stencil — against 22 planes read
// once). Design: a block owns 32
// queries of one cell row, 8 lanes per query; each lane keeps the ten
// accumulators in registers. The candidate axis is walked in chunks of
// CHUNK slots whose OCCUPIED entries (mask > 0) are compacted, order kept,
// into ten shared-memory planes, so shared memory never depends on the
// candidate width. A block with no occupied query slot leaves before it
// stages anything (the mono-tile engine sweeps every cell at the full
// capacity, most of whose slots are padding). No candidate-side outputs,
// hence no atomics: the lanes of a query combine by warp shuffle at the end.
#include "common.cuh"

namespace sph {

constexpr int CHUNK = 512;  // candidate slots staged per pass (10 planes)

template <typename T>
struct PhaseBArgs {
  const T* q[11];  // x y z vx vy vz mask h rho por2 cs, each (n_cells, cap)
  const T* c[11];  // same fields, each (n_cells, cw)
  const T* scal;   // m, alpha, beta, sigma on the device
  T* out[10];      // ax ay az div mu_max visc ggx ggy ggz gphi
  int cap;
  int cw;
};

template <typename T, bool ISO, bool P3M>
__global__ void __launch_bounds__(TILE_THREADS) phase_b_kernel(PhaseBArgs<T> a) {
  // candidate planes: x y z vx vy vz h rho por2 cs
  __shared__ T s[10][CHUNK];
  __shared__ int wcount[TILE_WARPS];

  const long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int sub = tid % LANES_PER_QUERY;
  const int q = blockIdx.y * QUERIES_PER_BLOCK + tid / LANES_PER_QUERY;
  const long qi = row * a.cap + (q < a.cap ? q : 0);
  const bool active = q < a.cap && a.q[6][qi] > T(0);

  if (!__syncthreads_or(active)) {
    // no query of this block is occupied (the padding of a cell with fewer
    // particles than the capacity): zeros, mu_max = -max, nothing staged
    if (q < a.cap && sub == 0) {
#pragma unroll
      for (int k = 0; k < 10; ++k) a.out[k][qi] = T(0);
      a.out[4][qi] = -Num<T>::big();
    }
    return;
  }

  const T m = a.scal[0];
  const T alpha = a.scal[1];
  const T beta = a.scal[2];
  const T sigma = a.scal[3];

  const T qx = a.q[0][qi], qy = a.q[1][qi], qz = a.q[2][qi];
  const T qvx = a.q[3][qi], qvy = a.q[4][qi], qvz = a.q[5][qi];
  const T qh = a.q[7][qi], qrho = a.q[8][qi], qpor2 = a.q[9][qi], qcs = a.q[10][qi];

  // r_k = 2h recomputed here; (2h)^2 rounds as in phase A's consumers
  const T fwd_thr = Num<T>::mul_rn(T(2) * qh, T(2) * qh);
  const T h_q = qh > T(0) ? qh : T(1);
  const T inv_hq = T(1) / h_q;
  const T inv_hq2 = inv_hq * inv_hq;
  const T inv_pi = T(1) / T(3.14159265358979323846);
  const T ct_wq = inv_pi * inv_hq2 * inv_hq2;

  T ax = T(0), ay = T(0), az = T(0), dv = T(0), visc = T(0);
  T gx = T(0), gy = T(0), gz = T(0), gp = T(0);
  T mumax = -Num<T>::big();

  for (int c0 = 0; c0 < a.cw; c0 += CHUNK) {
    // stage this chunk's occupied candidates
    int ncand = 0;
    const int c1 = (c0 + CHUNK < a.cw) ? c0 + CHUNK : a.cw;
    for (int t0 = c0; t0 < c1; t0 += TILE_THREADS) {
      const int j = t0 + tid;
      const long cj = row * a.cw + j;
      const bool keep = j < c1 && a.c[6][cj] > T(0);
      const int p = compact_slot(keep, ncand, wcount);
      if (keep) {
        s[0][p] = a.c[0][cj];
        s[1][p] = a.c[1][cj];
        s[2][p] = a.c[2][cj];
        s[3][p] = a.c[3][cj];
        s[4][p] = a.c[4][cj];
        s[5][p] = a.c[5][cj];
        s[6][p] = a.c[7][cj];
        s[7][p] = a.c[8][cj];
        s[8][p] = a.c[9][cj];
        s[9][p] = a.c[10][cj];
      }
    }
    __syncthreads();

    if (active) {
      for (int j = sub; j < ncand; j += LANES_PER_QUERY) {
        const T dx = qx - s[0][j];
        const T dy = qy - s[1][j];
        const T dz = qz - s[2][j];
        const T d2 = dist2<T>(dx, dy, dz);
        const bool sep = d2 > T(0);
        const T inv_r = sep ? Num<T>::rsqrt(d2) : T(0);  // self pairs: 1/r -> 0
        const T r = d2 * inv_r;

        const T ch = s[6][j];
        const bool fwd = d2 <= fwd_thr;
        const bool rev = d2 <= Num<T>::mul_rn(T(2) * ch, T(2) * ch);
        const T h_c = ch > T(0) ? ch : T(1);
        const T h_avg = T(0.5) * (h_q + h_c);
        const bool gmask = r <= T(2) * h_avg;
        if (!P3M && !fwd && !rev && !gmask) continue;

        const T inv_h = T(1) / h_avg;
        const T inv_rho = T(1) / (T(0.5) * (qrho + s[7][j]));

        const T v_dot_r = (qvx - s[3][j]) * dx + (qvy - s[4][j]) * dy + (qvz - s[5][j]) * dz;
        T mu = h_avg * v_dot_r * (T(1) / (d2 + T(0.01) * (h_avg * h_avg)));
        mu = mu < T(0) ? mu : T(0);
        const T pi_fwd = (-alpha * qcs * mu + beta * mu * mu) * inv_rho;
        const T pi_rev = (-alpha * s[9][j] * mu + beta * mu * mu) * inv_rho;

        // grad_W(q)/r with per-side h
        const T q_q = r * inv_hq;
        const T two_q = T(2) - q_q;
        const T dwdr_q =
            q_q <= T(1) ? ct_wq * (T(2.25) * r * inv_hq2 - T(3) * inv_hq)
                        : (q_q <= T(2) ? ct_wq * (T(-0.75) * (two_q * two_q)) * inv_r : T(0));
        const T inv_hc = T(1) / h_c;
        const T inv_hc2 = inv_hc * inv_hc;
        const T ct_wc = inv_pi * inv_hc2 * inv_hc2;
        const T q_c = r * inv_hc;
        const T two_c = T(2) - q_c;
        const T dwdr_c =
            q_c <= T(1) ? ct_wc * (T(2.25) * r * inv_hc2 - T(3) * inv_hc)
                        : (q_c <= T(2) ? ct_wc * (T(-0.75) * (two_c * two_c)) * inv_r : T(0));

        T ct_fwd, ct_rev;
        if (ISO) {
          ct_fwd = m * (qpor2 + pi_fwd / T(2));
          ct_rev = m * (s[8][j] + pi_rev / T(2));
        } else {
          const T psum = qpor2 + s[8][j];
          ct_fwd = m * (psum + pi_fwd) / T(2);
          ct_rev = m * (psum + pi_rev) / T(2);
        }

        const T coeff = -(fwd ? ct_fwd * dwdr_q : T(0)) - (rev ? ct_rev * dwdr_c : T(0));
        ax += coeff * dx;
        ay += coeff * dy;
        az += coeff * dz;

        const T v_dot_dw_q = v_dot_r * dwdr_q;
        const T v_dot_dw_c = v_dot_r * dwdr_c;
        if (fwd) {
          dv += v_dot_dw_q;
          mumax = mu > mumax ? mu : mumax;
        }
        visc += (fwd ? m * pi_fwd * v_dot_dw_q / T(2) : T(0)) +
                (rev ? m * pi_rev * v_dot_dw_c / T(2) : T(0));

        // near-field gravity correction, term 1: softened - Newtonian
        const T newt_g = inv_r * inv_r * inv_r;
        const T newt_p = -inv_r;
        T cgp = T(0), cpp = T(0);
        if (gmask) {
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
            soft_p = inv_h * (T(4.0 / 3.0) * q2 - q3 + T(0.3) * q2 * q2 - q2 * q3 / T(30) -
                              T(1.6) + T(1.0 / 15.0) * inv_q);
          } else {
            soft_g = newt_g;
            soft_p = newt_p;
          }
          cgp = soft_g - newt_g;
          cpp = soft_p - newt_p;
        }
        if (P3M) {
          // term 2 (Newtonian - mesh shape): exp(-z^2) * erfcx polynomial
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
          cgp += sep ? f * newt_g : T(0);
          cpp += sep ? -erfc_z * inv_r : T(0.7978845608028654) / sigma;
        }
        gx += cgp * dx;
        gy += cgp * dy;
        gz += cgp * dz;
        gp += cpp;
      }
    }
    __syncthreads();  // the planes are overwritten by the next chunk
  }

  if (q >= a.cap) return;
  if (!active) {
    // off-mask rows: zeros, mu_max = -max
    if (sub == 0) {
      const long o = row * a.cap + q;
#pragma unroll
      for (int k = 0; k < 10; ++k) a.out[k][o] = T(0);
      a.out[4][o] = -Num<T>::big();
    }
    return;
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
    a.out[0][qi] = ax;
    a.out[1][qi] = ay;
    a.out[2][qi] = az;
    a.out[3][qi] = m * dv;
    a.out[4][qi] = mumax;
    a.out[5][qi] = visc;
    a.out[6][qi] = m * gx;
    a.out[7][qi] = m * gy;
    a.out[8][qi] = m * gz;
    a.out[9][qi] = m * gp;
  }
}

template <typename T>
int phase_b_from_ptrs(void* const* qp, void* const* cp, const void* scal, void* const* op,
                      int n_cells, int cap, int cw, int iso, int p3m, cudaStream_t stream) {
  if (n_cells <= 0) return 0;
  PhaseBArgs<T> a;
  for (int k = 0; k < 11; ++k) {
    a.q[k] = static_cast<const T*>(qp[k]);
    a.c[k] = static_cast<const T*>(cp[k]);
  }
  for (int k = 0; k < 10; ++k) a.out[k] = static_cast<T*>(op[k]);
  a.scal = static_cast<const T*>(scal);
  a.cap = cap;
  a.cw = cw;
  const dim3 grid(n_cells, (cap + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK);
  if (iso) {
    if (p3m) {
      SPH_LAUNCH((phase_b_kernel<T, true, true>), grid, TILE_THREADS, 0, stream, a);
    } else {
      SPH_LAUNCH((phase_b_kernel<T, true, false>), grid, TILE_THREADS, 0, stream, a);
    }
  } else {
    if (p3m) {
      SPH_LAUNCH((phase_b_kernel<T, false, true>), grid, TILE_THREADS, 0, stream, a);
    } else {
      SPH_LAUNCH((phase_b_kernel<T, false, false>), grid, TILE_THREADS, 0, stream, a);
    }
  }
  return int(cudaGetLastError());
}

}  // namespace sph

// q, c: 11 device pointers each (x y z vx vy vz mask h rho por2 cs); scal:
// device pointer to (m, alpha, beta, sigma); out: 10 device pointers.
extern "C" int sph_phase_b_tiles(void* const* q, void* const* c, const void* scal,
                                 void* const* out, int n_cells, int cap, int cw, int iso,
                                 int p3m, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? sph::phase_b_from_ptrs<double>(q, c, scal, out, n_cells, cap, cw, iso, p3m, s)
             : sph::phase_b_from_ptrs<float>(q, c, scal, out, n_cells, cap, cw, iso, p3m, s);
}
