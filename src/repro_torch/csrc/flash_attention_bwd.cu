// Backward of blockwise (flash) attention for Hopper (sm_90a): dq, dk
// and dv of the forward in flash_attention.cu, with its masks (causal,
// sliding window, query offset, valid kv length) and GQA/MQA by
// indexing.
//
// No TPU kernel is replaced: the JAX package differentiates its
// train-mode attention (`chunked_attention`, repro/models/layers.py)
// through XLA's autodiff and has no backward kernel. This is the port's
// own kernel for the gradient of the attention it runs.
//
// Layout: q, o, do, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, K, hd); all
// contiguous, f32 or bf16; lse and the scratch dsum (B, H, Sq) f32. The
// forward's masks: query row i sits at position q_offset + i; key j is
// valid iff j < kv_len, and (causal) j <= q_pos, and (window > 0)
// j > q_pos - window. A row with no valid key has lse = -inf and gets
// zero gradient (p is 0 wherever the mask is false).
//
// FlashAttention-2's split, three launches on one stream:
//   1. dot_kernel:  dsum = rowsum(dO * O) (f32), one warp per row;
//   2. dkdv_kernel: one block per (64 keys, kv head, batch). It walks the
//      H / K query heads that share the kv head and, for each, the query
//      tiles that see one of its keys; recomputes P = exp(S * scale -
//      lse) and accumulates dV += P^T dO and dK += dS^T Q * scale with
//      dS = P * (dO V^T - dsum);
//   3. dq_kernel:   one block per (64 query rows, head, batch) walks the
//      kv tiles its rows see and accumulates dQ += dS K * scale.
// Each output element is summed by one thread in a fixed order: no
// atomics, so the result is the same from run to run.
//
// What bounds it here: operations. Per unmasked (query, key) pair the
// two kernels do ~7 hd multiply-adds (the bound counts the usual 10 hd
// operations at the tensor-core rate) against bytes read once per tile.
// This first kernel runs on the CUDA cores in f32, as the forward does:
// four threads share a key row (dkdv) or a query row (dq), each holding
// an interleaved quarter of hd in registers (its row's k, v and the two
// accumulators, or q, dO and the accumulator); dot products are the sum
// of the four quarters (two xor shuffles). Query or kv tiles are staged
// in shared memory as f32. Tiles with no valid pair are skipped. A
// tensor-core (wgmma) version is later work.
// Build without --use_fast_math (expf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // key rows (dkdv) or query rows (dq) a block
constexpr int kTileQ = 32;    // query rows per staged tile (dkdv)
constexpr int kTileK = 16;    // keys per staged tile (dq): s and dp of a
                              // tile stay in registers without spills

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// the sum of the four quarter dot products of a row (the same value in
// all four threads)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool pair_ok(int key, int q_pos, int Sk,
                                        int kv_len, int causal, int window) {
  bool ok = key < kv_len && key < Sk;
  if (causal) ok = ok && key <= q_pos;
  if (window > 0) ok = ok && key > q_pos - window;
  return ok;
}

// 1. dsum[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
           float* __restrict__ dsum, int B, int Sq, int H) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B * Sq * H) return;     // whole warps leave together
  const size_t off = static_cast<size_t>(warp) * HD;
  float acc = 0.f;
  for (int dd = lane * 4; dd < HD; dd += 128)
    acc = dot4(load4(dout + off + dd), load4(o + off + dd), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = warp % H, i = (warp / H) % Sq, b = warp / (H * Sq);
    dsum[(static_cast<size_t>(b) * H + h) * Sq + i] = acc;
  }
}

// 2. dK, dV for 64 keys of one kv head
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
            int K, int causal, int window, int q_offset, int kv_len,
            float scale) {
  constexpr int kChunks = HD / 4;
  constexpr int kJ = HD / 16;
  __shared__ __align__(16) float qs[kTileQ * HD];
  __shared__ __align__(16) float dos[kTileQ * HD];
  __shared__ float lse_s[kTileQ];
  __shared__ float dsum_s[kTileQ];

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int part = tid & 3;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int k0 = blockIdx.x * kRows;
  const int key = k0 + r;

  float4 kv[kJ], vv[kJ], dk_acc[kJ], dv_acc[kJ];
  const size_t kv_row = (static_cast<size_t>(b) * Sk + key) * K + kh;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int col = (part + 4 * j) * 4;
    kv[j] = key < Sk ? load4(k + kv_row * HD + col)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    vv[j] = key < Sk ? load4(v + kv_row * HD + col)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    dk_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[j] = dk_acc[j];
  }

  // query rows that see one of this block's valid keys
  const int key_hi = min(min(k0 + kRows, Sk), kv_len) - 1;
  int i_begin = 0, i_end = key_hi >= k0 ? Sq : 0;
  if (causal) i_begin = max(i_begin, k0 - q_offset);
  if (window > 0) i_end = min(i_end, key_hi + window - q_offset);
  const int t_begin = max(i_begin, 0) / kTileQ;
  const int t_end = i_end > i_begin ? (i_end + kTileQ - 1) / kTileQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int i0 = tile * kTileQ;
      __syncthreads();   // the previous tile is consumed
      for (int e = tid; e < kTileQ * kChunks; e += kThreads) {
        const int qr = e / kChunks, c4 = e % kChunks;
        const int row = i0 + qr;
        float4 qq = make_float4(0.f, 0.f, 0.f, 0.f), dd = qq;
        if (row < Sq) {
          const size_t off =
              ((static_cast<size_t>(b) * Sq + row) * H + h) * HD + c4 * 4;
          qq = load4(q + off);
          dd = load4(dout + off);
        }
        store4(qs + qr * HD + c4 * 4, qq);
        store4(dos + qr * HD + c4 * 4, dd);
      }
      if (tid < kTileQ) {
        const int row = i0 + tid;
        const size_t off = (static_cast<size_t>(b) * H + h) * Sq + row;
        lse_s[tid] = row < Sq ? lse[off] : 0.f;
        dsum_s[tid] = row < Sq ? dsum[off] : 0.f;
      }
      __syncthreads();

      for (int c = 0; c < kTileQ; ++c) {
        const int row = i0 + c;
        const bool ok = row < Sq && pair_ok(key, q_offset + row, Sk, kv_len,
                                            causal, window);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int col = (part + 4 * j) * 4;
          s = dot4(load4(qs + c * HD + col), kv[j], s);
          dp = dot4(load4(dos + c * HD + col), vv[j], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const float p = ok ? expf(s * scale - lse_s[c]) : 0.f;
        const float ds = p * (dp - dsum_s[c]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int col = (part + 4 * j) * 4;
          axpy4(p, load4(dos + c * HD + col), dv_acc[j]);
          axpy4(ds, load4(qs + c * HD + col), dk_acc[j]);
        }
      }
    }
  }

  if (key < Sk) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int col = (part + 4 * j) * 4;
      const float4 a = dk_acc[j];
      store4(dk + kv_row * HD + col,
             make_float4(a.x * scale, a.y * scale, a.z * scale,
                         a.w * scale));
      store4(dv + kv_row * HD + col, dv_acc[j]);
    }
  }
}

// 3. dQ for 64 query rows of one head
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int Sq, int Sk, int H, int K, int causal,
          int window, int q_offset, int kv_len, float scale) {
  constexpr int kChunks = HD / 4;
  constexpr int kJ = HD / 16;
  __shared__ __align__(16) float ks[kTileK * HD];
  __shared__ __align__(16) float vs[kTileK * HD];

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int part = tid & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q_first = blockIdx.x * kRows;
  const int row = q_first + r;
  const int q_pos = q_offset + row;

  float4 qv[kJ], dov[kJ], dq_acc[kJ];
  const size_t q_row = (static_cast<size_t>(b) * Sq + row) * H + h;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int col = (part + 4 * j) * 4;
    qv[j] = row < Sq ? load4(q + q_row * HD + col)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    dov[j] = row < Sq ? load4(dout + q_row * HD + col)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    dq_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const size_t stat = (static_cast<size_t>(b) * H + h) * Sq + row;
  const float row_lse = row < Sq ? lse[stat] : 0.f;
  const float row_dsum = row < Sq ? dsum[stat] : 0.f;

  // kv tiles holding a valid key for some row of this block
  const int pos_lo = q_offset + q_first;
  const int pos_hi = q_offset + min(q_first + kRows, Sq) - 1;
  int k_begin = 0, k_end = min(kv_len, Sk);
  if (causal) k_end = min(k_end, pos_hi + 1);
  if (window > 0) k_begin = max(k_begin, pos_lo - window + 1);
  const int t_begin = k_begin / kTileK;
  const int t_end = k_end > k_begin ? (k_end + kTileK - 1) / kTileK : 0;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kTileK;
    __syncthreads();   // the previous tile is consumed
    for (int e = tid; e < kTileK * kChunks; e += kThreads) {
      const int kr = e / kChunks, c4 = e % kChunks;
      const int kk = k0 + kr;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bb = a;
      if (kk < Sk) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + kk) * K + kh) * HD + c4 * 4;
        a = load4(k + off);
        bb = load4(v + off);
      }
      store4(ks + kr * HD + c4 * 4, a);
      store4(vs + kr * HD + c4 * 4, bb);
    }
    __syncthreads();

    float s[kTileK], dp[kTileK];
#pragma unroll
    for (int c = 0; c < kTileK; ++c) {
      s[c] = 0.f;
      dp[c] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int col = (part + 4 * j) * 4;
#pragma unroll
      for (int c = 0; c < kTileK; ++c) {
        s[c] = dot4(qv[j], load4(ks + c * HD + col), s[c]);
        dp[c] = dot4(dov[j], load4(vs + c * HD + col), dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileK; ++c) {
      s[c] = quad_sum(s[c]);
      dp[c] = quad_sum(dp[c]);
    }
#pragma unroll
    for (int c = 0; c < kTileK; ++c) {
      const bool ok = row < Sq && pair_ok(k0 + c, q_pos, Sk, kv_len, causal,
                                          window);
      const float p = ok ? expf(s[c] * scale - row_lse) : 0.f;
      const float ds = p * (dp[c] - row_dsum);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        axpy4(ds, load4(ks + c * HD + (part + 4 * j) * 4), dq_acc[j]);
    }
  }

  if (row < Sq) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 a = dq_acc[j];
      store4(dq + q_row * HD + (part + 4 * j) * 4,
             make_float4(a.x * scale, a.y * scale, a.z * scale,
                         a.w * scale));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int K, int causal,
           int window, int q_offset, int kv_len, float scale,
           cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const unsigned dot_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  dot_kernel<T, HD><<<dot_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(o), dot, ds, B, Sq, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 kv_grid((Sk + kRows - 1) / kRows, K, B);
  dkdv_kernel<T, HD><<<kv_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, l, ds, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, H, K, causal, window, q_offset, kv_len, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 q_grid((Sq + kRows - 1) / kRows, H, B);
  dq_kernel<T, HD><<<q_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, l, ds, static_cast<T*>(dq), Sq, Sk, H, K, causal,
      window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const void* lse, void* dsum,
             void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
             int K, int causal, int window, int q_offset, int kv_len,
             float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, H, K, causal, window, q_offset, kv_len, scale,
                           s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, H, K, causal, window, q_offset, kv_len, scale,
                           s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                            Sk, H, K, causal, window, q_offset, kv_len,
                            scale, s);
    default:   // the wrapper raises first (fa_bwd_supports_head_dim)
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Head dims the backward is built for (the switch above); the wrapper
// raises on others.
extern "C" int fa_bwd_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 128;
}

// dtype: 0 f32, 1 bf16 (q, k, v, o, dout and the outputs dq, dk, dv);
// lse and dsum f32 (B, H, Sq), dsum scratch. Three launches on `stream`;
// returns the first non-zero cudaGetLastError(), else 0.
extern "C" int fa_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int K, int hd, int dtype,
    int causal, int window, int q_offset, int kv_len, float scale,
    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, dout, lse, dsum, dq, dk,
                                   dv, B, Sq, Sk, H, K, causal, window,
                                   q_offset, kv_len, scale, s);
  return dispatch<float>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                         Sk, H, K, causal, window, q_offset, kv_len, scale,
                         s);
}
