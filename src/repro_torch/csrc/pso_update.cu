// Fused PSO update (paper Eq. 8) for Hopper (sm_90a), over one stacked
// leaf of the swarm state with per-worker coefficients:
//
//   v' = c0 v + c1 (wl - w) + c2 (wg - w) + d    (clipped to +-clip)
//   w' = w + v'
//
// Replaces the Pallas TPU kernel repro/kernels/pso_update/pso_update.py:
//   pso_update_kernel  <- pso_update_2d (_kernel)
// in the form `core/swarm_dist` needs it: w, v, wl, d stacked (W, n),
// wg (n,) broadcast over the W workers, and one (c0, c1, c2, clip) row
// per worker (clip <= 0: no clip), where the TPU kernel took one (4,)
// row per call over a padded (rows, 128) f32 layout.
//
// What bounds it here: device-memory bytes. Per element it reads five
// values and writes two (14 bytes in bf16, 28 in f32) for ~8 float
// operations, far below the card's balance point; the least time is
// the bytes over 3.35 TB/s.
//
// What the design does about it: one pass, a grid-stride loop per
// worker (blockIdx.y), 16-byte vector loads and stores when every row
// starts on a 16-byte boundary (8 bf16 or 4 f32 values a thread), the
// coefficients read once per thread. No padding: the wrapper passes the
// leaf as it lies.
//
// Rounding points (those of the JAX package's inline leaf, and of the
// plain version, which repeats this arithmetic op for op): wl - w and
// wg - w are rounded to the leaf dtype; the velocity sum is formed in
// f32, left to right; the clip is applied in f32; v' is rounded to the
// leaf dtype and w' = dtype(f32(w) + f32(v')). Every product and sum is
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract them into
// FMAs and the kernel equals the plain version bit for bit. Build
// without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a value rounded to T and read back as f32
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pso_update_kernel(const float* __restrict__ coefs, const T* __restrict__ w,
                  const T* __restrict__ v, const T* __restrict__ wl,
                  const T* __restrict__ wg, const T* __restrict__ d,
                  T* __restrict__ w_out, T* __restrict__ v_out, int64_t n) {
  using P = Pack<T, V>;
  const int worker = blockIdx.y;
  const float c0 = coefs[4 * worker + 0];
  const float c1 = coefs[4 * worker + 1];
  const float c2 = coefs[4 * worker + 2];
  const float clip = coefs[4 * worker + 3];
  const int64_t base = static_cast<int64_t>(worker) * (n / V);
  const P* wp = reinterpret_cast<const P*>(w) + base;
  const P* vp = reinterpret_cast<const P*>(v) + base;
  const P* wlp = reinterpret_cast<const P*>(wl) + base;
  const P* dp = reinterpret_cast<const P*>(d) + base;
  const P* wgp = reinterpret_cast<const P*>(wg);
  P* wo = reinterpret_cast<P*>(w_out) + base;
  P* vo = reinterpret_cast<P*>(v_out) + base;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n / V; i += stride) {
    const P pw = wp[i], pv = vp[i], pl = wlp[i], pg = wgp[i], pd = dp[i];
    P rw, rv;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float fw = to_f(pw.x[e]);
      const float dl = round_t<T>(__fsub_rn(to_f(pl.x[e]), fw));
      const float dg = round_t<T>(__fsub_rn(to_f(pg.x[e]), fw));
      float vn = __fmul_rn(c0, to_f(pv.x[e]));
      vn = __fadd_rn(vn, __fmul_rn(c1, dl));
      vn = __fadd_rn(vn, __fmul_rn(c2, dg));
      vn = __fadd_rn(vn, to_f(pd.x[e]));
      if (clip > 0.f) vn = vn < -clip ? -clip : (vn > clip ? clip : vn);
      const T vt = from_f<T>(vn);
      rv.x[e] = vt;
      rw.x[e] = from_f<T>(__fadd_rn(fw, to_f(vt)));
    }
    wo[i] = rw;
    vo[i] = rv;
  }
}

template <typename T, int V>
int launch(const void* coefs, const void* w, const void* v, const void* wl,
           const void* wg, const void* d, void* w_out, void* v_out, int W,
           int64_t n, cudaStream_t s) {
  const int64_t nv = n / V;
  const int64_t want = (nv + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < kMaxBlocksX ? want
                                                            : kMaxBlocksX),
                  W);
  pso_update_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(coefs), static_cast<const T*>(w),
      static_cast<const T*>(v), static_cast<const T*>(wl),
      static_cast<const T*>(wg), static_cast<const T*>(d),
      static_cast<T*>(w_out), static_cast<T*>(v_out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coefs (W, 4) f32; w, v, wl, d, w_out, v_out (W, n); wg (n,). dtype: 0
// f32, 1 bf16. vec: values per thread access, 1 or 16 / sizeof(T) (then
// n % vec == 0 and every pointer 16-byte aligned). Returns
// cudaGetLastError() after the launch.
extern "C" int pu_pso_update(const void* coefs, const void* w, const void* v,
                             const void* wl, const void* wg, const void* d,
                             void* w_out, void* v_out, int W, long long n,
                             int dtype, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (W <= 0 || W > 65535 || n <= 0) return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(coefs, w, v, wl, wg, d, w_out, v_out,
                                      W, n, s);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(coefs, w, v, wl, wg, d, w_out, v_out,
                                      W, n, s);
    return cudaErrorInvalidValue;
  }
  if (vec == 4)
    return launch<float, 4>(coefs, w, v, wl, wg, d, w_out, v_out, W, n, s);
  if (vec == 1)
    return launch<float, 1>(coefs, w, v, wl, wg, d, w_out, v_out, W, n, s);
  return cudaErrorInvalidValue;
}
