// Blockwise (flash) attention for Hopper (sm_90a): online-softmax
// attention with causal and sliding-window masks, query offset
// (suffix alignment) and a valid kv length, GQA/MQA by indexing.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_kernel  <- flash_attention_bh (_kernel), with the
//                              GQA repeat and padding of ops.py folded in
//
// Layout: q and out (B, Sq, H, hd), k and v (B, Sk, K, hd), contiguous,
// f32 or bf16. Query row i has absolute position q_offset + i; key j is
// valid iff j < kv_len, and (causal) j <= q_pos, and (window > 0)
// j > q_pos - window. A row with no valid key gives 0.
//
// What bounds it here: at RecurrentGemma-9B's prefill (B 4, H 16, MQA,
// hd 256, S 4096, window 2048) the 4*hd operations per unmasked
// (query, key) pair dominate: ~4e11 operations against ~0.3 GB of
// q, k, v and out, so the tensor-core rate is the bound. This first
// kernel runs on the CUDA cores in f32 (scores, running max and sum,
// accumulator, and P.V with P in f32); a tensor-core (wgmma) version is
// later work.
//
// What the design does:
// - One block of 256 threads per (64 query rows, head, batch). Four
//   neighbouring threads share a query row; each holds a quarter of the
//   row's q (pre-loaded to registers, f32) and the same quarter of its
//   output accumulator, interleaved in 4-float chunks so that the four
//   read neighbouring 16-byte words of shared memory.
// - kv tiles of 32 keys are staged in shared memory as f32 (K and V,
//   32 KiB each at hd 256, opted in above 48 KiB). A score is the sum of
//   the four quarter dot products (two xor shuffles; the same value in
//   all four threads).
// - Only the kv tiles that hold at least one valid key for some row of
//   the block are visited: [q_lo - window + 1, min(kv_len, q_hi + 1)).
//   At S 4096 and window 2048 that is about half of all tiles. Ragged
//   edges (Sq, Sk not multiples of a tile) are bounds checks, not
//   padding. kv head h / (H / K) is indexed, never repeated.
// Build without --use_fast_math (expf, IEEE division).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;   // query rows per block, 4 threads per row
constexpr int kBlockK = 32;   // keys per kv tile
constexpr float kNegInf = -1e30f;

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int K, int causal, int window,
                       int q_offset, int kv_len, float scale) {
  constexpr int kChunks = HD / 4;    // 4-float chunks per row
  constexpr int kJ = HD / 16;        // chunks per thread
  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);   // (kBlockK, HD)
  float* vs = ks + kBlockK * HD;                // (kBlockK, HD)

  const int tid = threadIdx.x;
  const int r = tid >> 2;          // query row within the block
  const int part = tid & 3;        // which interleaved quarter of hd
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q_first = blockIdx.x * kBlockQ;
  const int row = q_first + r;
  const int q_pos = q_offset + row;

  // this thread's quarter of its q row, f32, in registers
  float4 qv[kJ];
  const size_t q_row = (static_cast<size_t>(b) * Sq + row) * H + h;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    qv[j] = row < Sq ? load4(q + q_row * HD + (part + 4 * j) * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_run = kNegInf, l_run = 0.f;

  // kv tiles holding a valid key for some row of this block
  const int pos_lo = q_offset + q_first;
  const int pos_hi = q_offset + min(q_first + kBlockQ, Sq) - 1;
  int k_begin = 0, k_end = min(kv_len, Sk);
  if (causal) k_end = min(k_end, pos_hi + 1);
  if (window > 0) k_begin = max(k_begin, pos_lo - window + 1);
  const int t_begin = k_begin / kBlockK;
  const int t_end = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK : 0;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();   // the previous tile is consumed
    for (int e = tid; e < kBlockK * kChunks; e += kThreads) {
      const int kr = e / kChunks, c4 = e % kChunks;
      const int key = k0 + kr;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < Sk) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + key) * K + kh) * HD + c4 * 4;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      store4(ks + kr * HD + c4 * 4, kk);
      store4(vs + kr * HD + c4 * 4, vv);
    }
    __syncthreads();

    float s[kBlockK];
#pragma unroll
    for (int c = 0; c < kBlockK; ++c) s[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int col = (part + 4 * j) * 4;
#pragma unroll
      for (int c = 0; c < kBlockK; ++c) {
        const float4 kk = load4(ks + c * HD + col);
        s[c] = fmaf(qv[j].x, kk.x, s[c]);
        s[c] = fmaf(qv[j].y, kk.y, s[c]);
        s[c] = fmaf(qv[j].z, kk.z, s[c]);
        s[c] = fmaf(qv[j].w, kk.w, s[c]);
      }
    }
    // the four quarters of each dot product; the same sum in all four
    // threads of the row (fp addition is commutative)
#pragma unroll
    for (int c = 0; c < kBlockK; ++c) {
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
      s[c] += __shfl_xor_sync(0xffffffffu, s[c], 2);
    }

    uint32_t valid = 0;
    float m_new = m_run;
#pragma unroll
    for (int c = 0; c < kBlockK; ++c) {
      const int key = k0 + c;
      bool ok = key < kv_len && key < Sk;
      if (causal) ok = ok && key <= q_pos;
      if (window > 0) ok = ok && key > q_pos - window;
      s[c] = ok ? s[c] * scale : kNegInf;
      valid |= (ok ? 1u : 0u) << c;
      m_new = fmaxf(m_new, s[c]);
    }
    const float alpha = expf(m_run - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int c = 0; c < kBlockK; ++c) {
      s[c] = ((valid >> c) & 1u) ? expf(s[c] - m_new) : 0.f;
      p_sum += s[c];
    }
    l_run = alpha * l_run + p_sum;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
      acc[j].z *= alpha;
      acc[j].w *= alpha;
    }
#pragma unroll
    for (int c = 0; c < kBlockK; ++c) {
      const float p = s[c];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 vv = load4(vs + c * HD + (part + 4 * j) * 4);
        acc[j].x = fmaf(p, vv.x, acc[j].x);
        acc[j].y = fmaf(p, vv.y, acc[j].y);
        acc[j].z = fmaf(p, vv.z, acc[j].z);
        acc[j].w = fmaf(p, vv.w, acc[j].w);
      }
    }
    m_run = m_new;
  }

  if (row < Sq) {
    const float den = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 o = make_float4(acc[j].x / den, acc[j].y / den,
                                   acc[j].z / den, acc[j].w / den);
      store4(out + q_row * HD + (part + 4 * j) * 4, o);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int K, int causal, int window, int q_offset,
           int kv_len, float scale, cudaStream_t s) {
  constexpr int smem = 2 * kBlockK * HD * static_cast<int>(sizeof(float));
  // opt in to more than 48 KiB of dynamic shared memory once, before the
  // first launch (outside any CUDA-graph capture that follows it)
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, K, causal,
      window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int H, int K, int causal, int window,
             int q_offset, int kv_len, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, K, causal, window,
                           q_offset, kv_len, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, K, causal, window,
                           q_offset, kv_len, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, K, causal, window,
                            q_offset, kv_len, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, K, causal, window,
                            q_offset, kv_len, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Head dims this kernel is built for; the wrapper raises on others.
extern "C" int fa_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

// dtype: 0 f32, 1 bf16. Returns cudaGetLastError() after the launch (or
// the error of the shared-memory opt-in).
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Sk, int H,
                                  int K, int hd, int dtype, int causal,
                                  int window, int q_offset, int kv_len,
                                  float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Sk, H, K, causal,
                                   window, q_offset, kv_len, scale, s);
  return dispatch<float>(hd, q, k, v, out, B, Sq, Sk, H, K, causal, window,
                         q_offset, kv_len, scale, s);
}
