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
// contiguous, f32 or bf16; lse (B, H, Sq) f32. The forward's masks:
// query row i sits at position q_offset + i; key j is valid iff
// j < kv_len, and (causal) j <= q_pos, and (window > 0)
// j > q_pos - window. A row with no valid key has lse = -inf and gets
// zero gradient (p is 0 wherever the mask is false).
//
// FlashAttention-2's split, three launches on one stream:
//   1. dsum = rowsum(dO * O) (f32), one warp a row (dot_kernel; for the
//      bf16 kernels prep_tc_kernel, which also copies lse, both into
//      (B, H, Sqp) buffers zero-padded to Sqp = 64 ceil(Sq / 64));
//   2. dK, dV: one block per (keys, kv head, batch) walks the H / K
//      query heads that share its kv head and, for each, the query tiles
//      that see one of its keys; recomputes P = exp(S * scale - lse) and
//      accumulates dV += P^T dO and dK += dS^T Q * scale with
//      dS = P * (dO V^T - dsum);
//   3. dQ: one block per (query rows, head, batch) walks the kv tiles
//      its rows see and accumulates dQ += dS K * scale.
// (The bf16 kernels split step 2's query heads into groups where its
// grid would be small, and add the groups' f32 sums in a fourth launch,
// reduce_kernel: `BwdTc`.) Each output element is summed by one thread
// in a fixed order: no atomics, so the result is the same from run to
// run.
//
// What bounds it: operations. Counted as 10 hd a unmasked (query, key)
// pair (S, dP, dV, dK, dQ) at the bf16 tensor-core peak, 989 TFLOP/s:
// at SmolLM-360M's training shape (B 2, H 15 over 5, hd 64, S 2048,
// causal; 6.29e7 pairs) 0.041 ms; at RecurrentGemma-9B's attention (B 2,
// H 16 over 1, hd 256, S 2048, window 2048; 6.71e7 pairs) 0.174 ms.
//
// Head dims: any hd % 8 == 0 up to 256, each in the next built one of
// 32, 64, 128 and 256 (both routes), its columns from hd on zeros that
// are never stored (flash_wgmma.cuh, `padded_head_dim`): StableLM-3B's
// hd 80 runs in the tensor-core kernels' 128 instantiation.
//
// The bf16 kernels (dkdv_tc_kernel, dq_tc_kernel; hd 40-256) run
// all products on the tensor cores (wgmma, flash_wgmma.cuh) and issue
// 20 hd operations a pair, not 10 hd: 12 hd in dkdv (S^T, dP^T, then dV
// and dK in two terms each; 16 hd at hd 128 and 20 hd at hd 256, below)
// and 8 hd in dq (S and dP again, dQ in two terms; 12 hd at hd 256).
// S and dP take bf16 operands exactly (f32 accumulation), but P and dS
// rounded once to bf16 miss the backward's rule (2 bf16 ulps of the
// plain f32 backward, ulp floored at 2^-12 of the largest gradient) at
// ~7% of the elements of each gradient at S 2048; split into two bf16
// terms (hi + the rounded remainder) they match unsplit f32 within it
// (tests/test_torch_flash_attention_bwd.py emulates it). So each of
// dV += P^T.dO, dK += dS^T.Q and dQ += dS.K is two wgmmas.
//
// The tensor cores' adds truncate: a dK chain over every tile drifted
// past the rule at the mesh shape, a chain over one tile stays within
// it. Each tile's product goes to a fresh accumulator that is added to
// the running sum in f32 on the CUDA cores.
//
// What that design does:
// - Blocks of three warpgroups: a producer warpgroup (setmaxnreg 24),
//   one of whose threads loads the block's fixed tiles once and then a
//   ring of 3 stages (2 at hd 256) by TMA (4D maps over (hd, heads, S,
//   B): ragged tiles read zeros past S, never the next batch) and 1D bulk
//   copies (lse, dsum), behind "full" and "empty" mbarriers; two
//   consumer warpgroups (setmaxnreg 240).
// - dkdv_tc_kernel, one block per (64 keys, kv head, batch), the blocks
//   that see the most query rows launched first: K and V stay in shared
//   memory; each stage holds 64 query rows of Q and dO and their lse and
//   dsum. S^T = K.Q^T and dP^T = V.dO^T by wgmma from shared memory put
//   P^T and dS^T in the accumulator layout with rows = keys, so they are
//   the register A operand of dV += P^T.dO and dK += dS^T.Q (dO and Q
//   read MN-major). At hd 64 the two consumers take alternate stages,
//   each with all of dK and dV in registers, and the second's sums are
//   added to the first's through shared memory at the end (a fixed
//   order): the heaviest block's chain of (head, query tile) steps is
//   split in two. At hd 128 both take every stage with half the columns
//   of dK and dV each (both compute S^T and dP^T), so that dK, dV and a
//   partial fit in registers. At hd 256 a block computes dV or dK (two
//   passes in one launch, twice the blocks), both consumers every stage
//   with 128 of its columns each (`BwdTc`).
// - dq_tc_kernel, one block per (128 query rows, head, batch), 64 a
//   consumer (at hd 256 64 rows, half the columns a consumer), the
//   blocks that see the most keys launched first: Q and dO stay; each
//   stage holds 64 keys of K and V.
//   S = Q.K^T, dP = dO.V^T, dS = P * (dP - dsum) in registers,
//   dQ += dS.K (K read MN-major).
// - The mask only on tiles where some pair is invalid (rows past Sq
//   included); elsewhere p needs no select.
//
// The f32 kernels (dkdv_kernel, dq_kernel; also bf16 at hd <= 32) run
// on the CUDA cores in f32: four threads share a key row (dkdv) or a
// query row (dq), each holding an interleaved quarter of hd in
// registers; dot products are the sum of the four quarters (two xor
// shuffles); query or kv tiles are staged in shared memory as f32. At
// hd 256 eight threads share a row (`F32Bwd`): a quarter of k, v, dk
// and dv would take 256 registers a thread.
// Build without --use_fast_math (expf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 16;    // keys per staged tile (dq): s and dp of a
                              // tile stay in registers without spills

// The CUDA-core kernels' split of a row over threads. Up to hd 128 four
// threads share a key row (dkdv) or a query row (dq), 64 rows a block,
// each holding an interleaved quarter of hd as float4s; dkdv keeps k,
// v, dk and dv of its quarter in registers (16 hd / 4 floats a thread).
// At hd 256 that is 256 registers, past the 255 a thread may have, so
// eight threads share a row (32 rows a block; 128 floats a thread) and
// a staged query tile has 16 rows, so that q and dO tiles stay within
// the 48 KiB of static shared memory.
template <int HD>
struct F32Bwd {
  static constexpr int kParts = HD == 256 ? 8 : 4;   // threads a row
  static constexpr int kRows = kThreads / kParts;    // rows a block
  static constexpr int kJ = HD / (4 * kParts);       // float4s a thread
  static constexpr int kTileQ = HD == 256 ? 16 : 32; // query rows a tile
};

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

// the sum of the P parts' dot products of a row (the same value in all
// P threads)
template <int P>
__device__ __forceinline__ float part_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  if (P == 8) x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ bool pair_ok(int key, int q_pos, int Sk,
                                        int kv_len, int causal, int window) {
  bool ok = key < kv_len && key < Sk;
  if (causal) ok = ok && key <= q_pos;
  if (window > 0) ok = ok && key > q_pos - window;
  return ok;
}

// 1. dsum[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
           float* __restrict__ dsum, int B, int Sq, int H, int hd) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B * Sq * H) return;     // whole warps leave together
  const size_t off = static_cast<size_t>(warp) * hd;
  float acc = 0.f;
  for (int dd = lane * 4; dd < hd; dd += 128)
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
            int K, int hd, int causal, int window, int q_offset, int kv_len,
            float scale) {
  using L = F32Bwd<HD>;
  constexpr int kChunks = HD / 4;
  constexpr int kJ = L::kJ, kP = L::kParts, kRows = L::kRows;
  constexpr int kTileQ = L::kTileQ;
  __shared__ __align__(16) float qs[kTileQ * HD];
  __shared__ __align__(16) float dos[kTileQ * HD];
  __shared__ float lse_s[kTileQ];
  __shared__ float dsum_s[kTileQ];

  const int tid = threadIdx.x;
  const int r = tid / kP;
  const int part = tid % kP;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int k0 = blockIdx.x * kRows;
  const int key = k0 + r;

  float4 kv[kJ], vv[kJ], dk_acc[kJ], dv_acc[kJ];
  const size_t kv_row = (static_cast<size_t>(b) * Sk + key) * K + kh;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int col = (part + kP * j) * 4;
    const bool in = key < Sk && col < hd;
    kv[j] = in ? load4(k + kv_row * hd + col)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    vv[j] = in ? load4(v + kv_row * hd + col)
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
        if (row < Sq && c4 * 4 < hd) {
          const size_t off =
              ((static_cast<size_t>(b) * Sq + row) * H + h) * hd + c4 * 4;
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
          const int col = (part + kP * j) * 4;
          s = dot4(load4(qs + c * HD + col), kv[j], s);
          dp = dot4(load4(dos + c * HD + col), vv[j], dp);
        }
        s = part_sum<kP>(s);
        dp = part_sum<kP>(dp);
        const float p = ok ? expf(s * scale - lse_s[c]) : 0.f;
        const float ds = p * (dp - dsum_s[c]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int col = (part + kP * j) * 4;
          axpy4(p, load4(dos + c * HD + col), dv_acc[j]);
          axpy4(ds, load4(qs + c * HD + col), dk_acc[j]);
        }
      }
    }
  }

  if (key < Sk) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int col = (part + kP * j) * 4;
      if (col >= hd) continue;          // a padded column
      const float4 a = dk_acc[j];
      store4(dk + kv_row * hd + col,
             make_float4(a.x * scale, a.y * scale, a.z * scale,
                         a.w * scale));
      store4(dv + kv_row * hd + col, dv_acc[j]);
    }
  }
}

// 3. dQ for 64 (32 at hd 256) query rows of one head
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int Sq, int Sk, int H, int K, int hd,
          int causal, int window, int q_offset, int kv_len, float scale) {
  using L = F32Bwd<HD>;
  constexpr int kChunks = HD / 4;
  constexpr int kJ = L::kJ, kP = L::kParts, kRows = L::kRows;
  __shared__ __align__(16) float ks[kTileK * HD];
  __shared__ __align__(16) float vs[kTileK * HD];

  const int tid = threadIdx.x;
  const int r = tid / kP;
  const int part = tid % kP;
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
    const int col = (part + kP * j) * 4;
    const bool in = row < Sq && col < hd;
    qv[j] = in ? load4(q + q_row * hd + col)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    dov[j] = in ? load4(dout + q_row * hd + col)
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
      if (kk < Sk && c4 * 4 < hd) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + kk) * K + kh) * hd + c4 * 4;
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
      const int col = (part + kP * j) * 4;
#pragma unroll
      for (int c = 0; c < kTileK; ++c) {
        s[c] = dot4(qv[j], load4(ks + c * HD + col), s[c]);
        dp[c] = dot4(dov[j], load4(vs + c * HD + col), dp[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileK; ++c) {
      s[c] = part_sum<kP>(s[c]);
      dp[c] = part_sum<kP>(dp[c]);
    }
#pragma unroll
    for (int c = 0; c < kTileK; ++c) {
      const bool ok = row < Sq && pair_ok(k0 + c, q_pos, Sk, kv_len, causal,
                                          window);
      const float p = ok ? expf(s[c] * scale - row_lse) : 0.f;
      const float ds = p * (dp[c] - row_dsum);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        axpy4(ds, load4(ks + c * HD + (part + kP * j) * 4), dq_acc[j]);
    }
  }

  if (row < Sq) {
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int col = (part + kP * j) * 4;
      if (col >= hd) continue;          // a padded column
      const float4 a = dq_acc[j];
      store4(dq + q_row * hd + col,
             make_float4(a.x * scale, a.y * scale, a.z * scale,
                         a.w * scale));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int K, int hd, int causal,
           int window, int q_offset, int kv_len, float scale,
           cudaStream_t s) {
  constexpr int kRows = F32Bwd<HD>::kRows;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const unsigned dot_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  dot_kernel<T><<<dot_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(o), dot, ds, B, Sq, H, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 kv_grid((Sk + kRows - 1) / kRows, K, B);
  dkdv_kernel<T, HD><<<kv_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, l, ds, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, H, K, hd, causal, window, q_offset, kv_len, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 q_grid((Sq + kRows - 1) / kRows, H, B);
  dq_kernel<T, HD><<<q_grid, kThreads, 0, s>>>(
      qt, kt, vt, dot, l, ds, static_cast<T*>(dq), Sq, Sk, H, K, hd, causal,
      window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const void* lse, void* dsum,
             void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
             int K, int causal, int window, int q_offset, int kv_len,
             float scale, cudaStream_t s) {
  if (!fa_tc::head_dim_ok(hd)) return static_cast<int>(cudaErrorInvalidValue);
  switch (fa_tc::padded_head_dim(hd)) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, H, K, hd, causal, window, q_offset, kv_len,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                           Sk, H, K, hd, causal, window, q_offset, kv_len,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                            Sk, H, K, hd, causal, window, q_offset, kv_len,
                            scale, s);
    default:
      return launch<T, 256>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                            Sk, H, K, hd, causal, window, q_offset, kv_len,
                            scale, s);
  }
}

// -- the tensor-core kernels: bf16 at hd 64, 128 and 256 -----------------

constexpr int kTcThreads = 384;   // producer + two consumer warpgroups
constexpr int kTcStep = 64;       // query rows (dkdv) or keys (dq) a stage

// dkdv: a block has 64 keys. At hd 64 its two consumer warpgroups take
// alternate query tiles, each with all columns of dK and dV, and add
// their sums at the end; at hd 128 both take every tile, each with half
// the columns (both compute S^T and dP^T), so that dK, dV and a partial
// fit in registers. At hd 256 half the columns of both would not (2 x 64
// + a 64-register partial + S^T and dP^T: ~256 of a consumer's 240), so
// a block computes one of them (`kTwoPass`; the grid's first dimension
// names the pass): dV (S^T, P^T, dV += P^T.dO) or dK (S^T and dP^T,
// dS^T, dK += dS^T.Q), each consumer 128 of its columns: 64 registers
// of the gradient, 64 of the partial, 64 of S^T and dP^T. That adds one
// S^T a pair. dq: 128 query rows a block, 64 and all columns a consumer;
// at hd 256 64 rows, half the columns a consumer (both compute S, dP).
// Shared memory: 2 fixed tiles (K, V; dq's Q and dO: 4 at 128 rows) and
// stages of 2 tiles, 3 stages (2 at hd 256, where a tile is 32 KiB:
// 192 KiB in all).
//
// Head groups (`head_groups`): a dkdv block walks the G = H / K query
// heads of its kv head, so a grid of few kv heads and keys has too few
// blocks for the card, and under a causal mask its first key blocks
// carry most of the work (RecurrentGemma-9B's training shape: 1 kv
// head, 32 key blocks, 2 passes, 2 batches: 128 blocks, the heaviest 32
// query tiles x 16 heads). Then the G heads are split into groups, a
// block each, whose f32 partial sums of dK and dV go to scratch and are
// added in group order by reduce_kernel (no atomics: the same result
// from run to run).
template <int HD>
struct BwdTc {
  static constexpr int kTile = fa_tc::kTileRows * HD * 2;   // 64 rows
  static constexpr bool kAlternate = HD == 64;              // dkdv
  static constexpr bool kTwoPass = HD == 256;               // dkdv
  static constexpr int kCols = kAlternate ? HD : HD / 2;    // dkdv
  static constexpr int kGrads = kTwoPass ? 1 : 2;           // dkdv: dV, dK
  static constexpr int kRowsQ = HD == 256 ? 64 : 128;       // dq
  static constexpr int kColsQ = kRowsQ == 128 ? HD : HD / 2;   // dq
  static constexpr int kStages = HD == 256 ? 2 : 3;
  // the fixed tiles, the stages, the stages' lse and dsum (dkdv), the
  // barriers
  static constexpr int kSmem = 1024 + (kRowsQ / 32) * kTile +
                               kStages * 2 * kTile + kStages * 512 +
                               8 * (1 + 2 * kStages);
};

// 1. dsum and lse log2(e) (the kernels' p = 2^(s scale log2(e) - lse
// log2(e)), `ex2`), each into a (B, H, Sqp) f32 buffer, zeros past Sq;
// one warp a row
__global__ void __launch_bounds__(kThreads)
prep_tc_kernel(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ dsum_p,
               float* __restrict__ lse_p, int B, int Sq, int Sqp, int H,
               int hd) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B * H * Sqp) return;     // whole warps leave together
  const int i = warp % Sqp, bh = warp / Sqp;
  const int h = bh % H, b = bh / H;
  float acc = 0.f;
  if (i < Sq) {
    const size_t off = ((static_cast<size_t>(b) * Sq + i) * H + h) * hd;
    for (int dd = lane * 4; dd < hd; dd += 128)
      acc = dot4(load4(dout + off + dd), load4(o + off + dd), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    dsum_p[warp] = acc;
    lse_p[warp] =
        i < Sq ? lse[static_cast<size_t>(bh) * Sq + i] * fa_tc::kLog2e : 0.f;
  }
}

// The head groups of the dkdv grid: the fewest (a divisor of G) that
// give at least two blocks an SM, else one a query head
inline int head_groups(int B, int Sk, int H, int K, bool two_pass) {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  const long long blocks = static_cast<long long>(K) * B *
                           ((Sk + kTcStep - 1) / kTcStep) * (two_pass ? 2 : 1);
  const int G = H / K;
  for (int ns = 1; ns < G; ++ns)
    if (G % ns == 0 && blocks * ns >= 2LL * sms) return ns;
  return G;
}

// acc += X.B over this tile: X (64 x 64 f32 in the accumulator layout:
// P^T, dS^T or dS) in two bf16 terms as the register A operand, B the N
// columns of a tile read MN-major from `b` on, into a fresh f32 partial
// added to acc on the CUDA cores (the tensor cores' adds truncate: a
// chain over every tile drifts past the rule, one tile's does not)
template <int N>
__device__ __forceinline__ void add_product(float (&acc)[N / 2],
                                            const float (&x)[32],
                                            const uint8_t* b) {
  using namespace fa_tc;
  uint32_t f[4][2][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_frag<2>(x, kk, f[kk]);
  float part[N / 2];        // the first wgmma overwrites it
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      wgmma_rs_tile<N>(part, f[kk][u], b, kk, kk + u > 0);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
}

// 2. dK, dV (or, in two passes, one of them) for 64 keys of one kv head
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse_p,
               const float* __restrict__ dsum_p,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int ns, int Sq, int Sqp, int Sk,
               int H, int K, int hd, int causal, int window, int q_offset,
               int kv_len, float scale) {
  using namespace fa_tc;
  using L = BwdTc<HD>;
  constexpr int NC = L::kCols;
  constexpr int kPasses = L::kTwoPass ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align_1024(smem_raw);        // the block's 64 keys
  uint8_t* sv = sk + L::kTile;
  uint8_t* sst = sv + L::kTile;              // stage s: Q tile, dO tile
  float* sstat = reinterpret_cast<float*>(sst + L::kStages * 2 * L::kTile);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sstat + L::kStages * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  // the grid's slowest dimension walks the key blocks from the first:
  // under a causal mask the blocks that see the most query rows start
  // first. The first dimension is (kv head, head group, pass); pass 0
  // computes dV, pass 1 dK (two passes), and the block walks its group's
  // G / ns query heads.
  const int pass = L::kTwoPass ? blockIdx.x % kPasses : 0;
  const int grp = (blockIdx.x / kPasses) % ns;
  const int kh = blockIdx.x / (kPasses * ns);
  const int b = blockIdx.y;
  const int G = H / K;
  const int Gb = G / ns;             // query heads a block
  const int k_first = blockIdx.z * kTcStep;
  const int kv_end = min(kv_len, Sk);
  // query rows that see one of this block's valid keys
  const int key_hi = min(k_first + kTcStep, kv_end) - 1;
  int i_begin = 0, i_end = key_hi >= k_first ? Sq : 0;
  if (causal) i_begin = max(i_begin, k_first - q_offset);
  if (window > 0) i_end = min(i_end, key_hi + window - q_offset);
  const int t_begin = i_begin / kTcStep;
  const int t_end = i_end > i_begin ? (i_end + kTcStep - 1) / kTcStep : 0;
  const int n_tiles = max(t_end - t_begin, 0);
  const int n_iter = Gb * n_tiles;   // (head, query tile) pairs, in order

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kAlternate ? 128 : 256);   // its consumers
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTile);
      tma_load_tile<HD>(sk, &tk, kv_full, kh, k_first, b);
      tma_load_tile<HD>(sv, &tv, kv_full, kh, k_first, b);
      for (int n = 0; n < n_iter; ++n) {
        const int stage = n % L::kStages;
        mbar_wait(&empty[stage], ((n / L::kStages) & 1) ^ 1);
        const int h = kh * G + grp * Gb + n / n_tiles;
        const int t = t_begin + n % n_tiles;
        uint8_t* qs = sst + stage * 2 * L::kTile;
        float* st = sstat + stage * 128;
        const size_t stat = (static_cast<size_t>(b) * H + h) * Sqp +
                            t * kTcStep;
        mbar_expect_tx(&full[stage], 2 * L::kTile + 512);
        tma_load_tile<HD>(qs, &tq, &full[stage], h, t * kTcStep, b);
        tma_load_tile<HD>(qs + L::kTile, &tdo, &full[stage], h, t * kTcStep,
                          b);
        bulk_load(st, lse_p + stat, 256, &full[stage]);
        bulk_load(st + 64, dsum_p + stat, 256, &full[stage]);
      }
    }
  } else {
    regs_inc<240>();
    const int tid = threadIdx.x & 127;
    const int cw = wg - 1;
    const int half = L::kAlternate ? 0 : cw;        // column block
    const int ka = k_first + frag_row(0, tid);   // keys ka, ka + 8
    const float sc = scale * kLog2e;
    const int cols = half * (NC / 64) * kBoxBytes;  // this block's columns
    // dV, then dK; in two passes the pass's one
    float acc[L::kGrads][NC / 2];
#pragma unroll
    for (int g = 0; g < L::kGrads; ++g) {
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[g][i] = 0.f;
    }
    mbar_wait(kv_full, 0);
    for (int n = L::kAlternate ? cw : 0; n < n_iter;
         n += L::kAlternate ? 2 : 1) {
      const int stage = n % L::kStages;
      const int i0 = (t_begin + n % n_tiles) * kTcStep;
      mbar_wait(&full[stage], (n / L::kStages) & 1);
      const uint8_t* qs = sst + stage * 2 * L::kTile;
      const uint8_t* dos = qs + L::kTile;
      const float* st = sstat + stage * 128;
      // S^T is overwritten by its first wgmma; dP^T (not computed in the
      // dV pass) starts at zero
      float sT[32], dpT[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dpT[i] = 0.f;
      wg_fence();
      gemm_ss<HD>(sT, sk, qs);      // S^T = K.Q^T: rows keys, cols queries
      if (!L::kTwoPass || pass == 1)   // (the dV pass needs no dP^T)
        gemm_ss<HD>(dpT, sv, dos);  // dP^T = V.dO^T
      wg_commit();
      wg_wait_all();
      fence_regs(sT);
      fence_regs(dpT);

      const bool all_valid = tile_all_valid(i0, k_first, Sq, kv_end, causal,
                                            window, q_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = frag_col(i, tid);
        bool ok = true;
        if (!all_valid) {
          const int key = ka + 8 * ((i >> 1) & 1);
          ok = i0 + c < Sq &&
               pair_ok(key, q_offset + i0 + c, Sk, kv_len, causal, window);
        }
        const float p = ok ? ex2(fmaf(sT[i], sc, -st[c])) : 0.f;
        sT[i] = p;
        dpT[i] = p * (dpT[i] - st[64 + c]);
      }
      // this tile's dV part P^T.dO, then its dK part dS^T.Q (two passes:
      // one of them, in branches of their own so that the dV pass keeps
      // no dS^T live)
      if (!L::kTwoPass) {
        add_product<NC>(acc[0], sT, dos + cols);
        add_product<NC>(acc[L::kGrads - 1], dpT, qs + cols);
      } else if (pass == 0) {
        add_product<NC>(acc[0], sT, dos + cols);
      } else {
        add_product<NC>(acc[0], dpT, qs + cols);
      }
      mbar_arrive(&empty[stage]);
    }

    if (L::kAlternate) {
      // the second consumer's sums to the first through the (consumed)
      // stage buffers, added in a fixed order
      float* red = reinterpret_cast<float*>(sst);
      named_sync(1, 256);
      if (cw == 1) {
#pragma unroll
        for (int g = 0; g < L::kGrads; ++g) {
#pragma unroll
          for (int i = 0; i < NC / 2; ++i)
            red[(g * NC / 2 + i) * 128 + tid] = acc[g][i];
        }
      }
      named_sync(1, 256);
      if (cw == 1) return;
#pragma unroll
      for (int g = 0; g < L::kGrads; ++g) {
#pragma unroll
        for (int i = 0; i < NC / 2; ++i)
          acc[g][i] += red[(g * NC / 2 + i) * 128 + tid];
      }
    }
    const bool store_dv = !L::kTwoPass || pass == 0;
    const bool store_dk = !L::kTwoPass || pass == 1;
    // head groups: this group's f32 sums (dK unscaled) to its plane of
    // the scratch, (2, ns, B, Sk, K, hd): dV's planes, then dK's
    const size_t plane = static_cast<size_t>(gridDim.y) * Sk * K * hd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = ka + 8 * r;
      if (key >= Sk) continue;
      const size_t off =
          ((static_cast<size_t>(b) * Sk + key) * K + kh) * hd + half * NC;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        if (half * NC + 8 * j >= hd) continue;   // a padded column group
        const int col = 8 * j + 2 * (tid & 3);
        const int i = 4 * j + 2 * r;
        if (ns > 1) {
          if (store_dk)
            *reinterpret_cast<float2*>(part + (ns + grp) * plane + off +
                                       col) =
                make_float2(acc[L::kGrads - 1][i], acc[L::kGrads - 1][i + 1]);
          if (store_dv)
            *reinterpret_cast<float2*>(part + grp * plane + off + col) =
                make_float2(acc[0][i], acc[0][i + 1]);
          continue;
        }
        if (store_dk)
          *reinterpret_cast<uint32_t*>(dk + off + col) =
              pack_bf16(acc[L::kGrads - 1][i] * scale,
                        acc[L::kGrads - 1][i + 1] * scale);
        if (store_dv)
          *reinterpret_cast<uint32_t*>(dv + off + col) =
              pack_bf16(acc[0][i], acc[0][i + 1]);
      }
    }
  }
}

// 3. (head groups) dK and dV from the groups' f32 partial sums, added in
// group order; 4 elements a thread
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, long long plane, int ns,
              float scale) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= plane) return;
#pragma unroll
  for (int grad = 0; grad < 2; ++grad) {     // dV, then dK
    const float* p = part + grad * ns * plane + i;
    float4 a = load4(p);
    for (int g = 1; g < ns; ++g) {
      const float4 x = load4(p + g * plane);
      a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    }
    if (grad == 1)
      a = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    store4((grad == 1 ? dk : dv) + i, a);
  }
}

// 4. dQ for 128 query rows of one head (64 at hd 256)
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse_p,
             const float* __restrict__ dsum_p, __nv_bfloat16* __restrict__ dq,
             int Sq, int Sqp, int Sk, int H, int K, int hd, int causal,
             int window, int q_offset, int kv_len, float scale) {
  using namespace fa_tc;
  using L = BwdTc<HD>;
  constexpr int NC = L::kColsQ;
  constexpr int kBlocks = L::kRowsQ / 64;   // 64-row tiles of Q, of dO
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);     // rows 0-63 (, 64-127)
  uint8_t* sdo = sq + kBlocks * L::kTile;
  uint8_t* sst = sdo + kBlocks * L::kTile;   // stage s: K tile, V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      sst + L::kStages * 2 * L::kTile + L::kStages * 512);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  // the query blocks from the last: under a causal mask the blocks that
  // see the most keys start first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / (H / K);
  const int q_first = (gridDim.z - 1 - blockIdx.z) * L::kRowsQ;
  const int kv_end = min(kv_len, Sk);
  int t_begin, t_end;
  kv_tiles(q_first, L::kRowsQ, Sq, q_offset, kv_end, causal, window,
           &t_begin, &t_end);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kBlocks * L::kTile);
      for (int r = 0; r < kBlocks; ++r) {
        tma_load_tile<HD>(sq + r * L::kTile, &tq, q_full, h,
                          q_first + 64 * r, b);
        tma_load_tile<HD>(sdo + r * L::kTile, &tdo, q_full, h,
                          q_first + 64 * r, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* ks = sst + stage * 2 * L::kTile;
        mbar_expect_tx(&full[stage], 2 * L::kTile);
        tma_load_tile<HD>(ks, &tk, &full[stage], kh, t * kTcStep, b);
        tma_load_tile<HD>(ks + L::kTile, &tv, &full[stage], kh,
                          t * kTcStep, b);
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    regs_inc<240>();
    const int tid = threadIdx.x & 127;
    const int blk = kBlocks == 2 ? wg - 1 : 0;    // row block
    const int half = kBlocks == 2 ? 0 : wg - 1;   // column block
    const int row0 = q_first + 64 * blk;
    const int ra = row0 + frag_row(0, tid);   // this thread's rows ra, ra + 8
    const uint8_t* qt = sq + blk * L::kTile;
    const uint8_t* dot = sdo + blk * L::kTile;
    const float sc = scale * kLog2e;
    float row_lse[2], row_dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t stat = (static_cast<size_t>(b) * H + h) * Sqp + ra + 8 * r;
      row_lse[r] = ra + 8 * r < Sq ? lse_p[stat] : 0.f;
      row_dsum[r] = ra + 8 * r < Sq ? dsum_p[stat] : 0.f;
    }
    float dq_acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int k0 = t * kTcStep;
      mbar_wait(&full[stage], phase);
      const uint8_t* ks = sst + stage * 2 * L::kTile;
      const uint8_t* vs = ks + L::kTile;
      float s[32], dp[32];    // each overwritten by its first wgmma
      wg_fence();
      gemm_ss<HD>(s, qt, ks);      // S = Q.K^T
      gemm_ss<HD>(dp, dot, vs);    // dP = dO.V^T
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);

      const bool all_valid = tile_all_valid(row0, k0, Sq, kv_end, causal,
                                            window, q_offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        bool ok = true;
        if (!all_valid) {
          const int row = ra + 8 * r;
          ok = row < Sq && pair_ok(k0 + frag_col(i, tid), q_offset + row, Sk,
                                   kv_len, causal, window);
        }
        const float p = ok ? ex2(fmaf(s[i], sc, -row_lse[r])) : 0.f;
        dp[i] = p * (dp[i] - row_dsum[r]);
      }
      // this tile's dS.K (this consumer's columns of K)
      add_product<NC>(dq_acc, dp, ks + half * (NC / 64) * kBoxBytes);
      mbar_arrive(&empty[stage]);
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* drow =
          dq + ((static_cast<size_t>(b) * Sq + row) * H + h) * hd + half * NC;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        if (half * NC + 8 * j < hd)     // not a padded column group
          *reinterpret_cast<uint32_t*>(drow + 8 * j + 2 * (tid & 3)) =
              pack_bf16(dq_acc[4 * j + 2 * r] * scale,
                        dq_acc[4 * j + 2 * r + 1] * scale);
      }
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* scratch, void* dq,
              void* dk, void* dv, int B, int Sq, int Sk, int H, int K,
              int hd, int causal, int window, int q_offset, int kv_len,
              float scale, cudaStream_t s) {
  using L = BwdTc<HD>;
  const int Sqp = (Sq + kTcStep - 1) / kTcStep * kTcStep;
  float* dsum_p = static_cast<float*>(scratch);
  float* lse_p = dsum_p + static_cast<size_t>(B) * H * Sqp;
  CUtensorMap tq, tk, tv, tdo;
  int e = fa_tc::make_map(&tq, q, hd, H, Sq, B);
  if (e == 0) e = fa_tc::make_map(&tk, k, hd, K, Sk, B);
  if (e == 0) e = fa_tc::make_map(&tv, v, hd, K, Sk, B);
  if (e == 0) e = fa_tc::make_map(&tdo, dout, hd, H, Sq, B);
  if (e != 0) return e;
  // opt in to the dynamic shared memory once, before the first launch
  // (outside any CUDA-graph capture that follows it)
  static bool opted = false;
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const long long rows = static_cast<long long>(B) * H * Sqp;
  const unsigned prep_blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  prep_tc_kernel<<<prep_blocks, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), dsum_p, lse_p, B, Sq, Sqp, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // two passes (hd 256): a block for each of dV and dK, in one launch;
  // head groups: a block for each group, their sums added by
  // reduce_kernel
  const int ns = head_groups(B, Sk, H, K, L::kTwoPass);
  float* part = ns > 1 ? lse_p + static_cast<size_t>(B) * H * Sqp : nullptr;
  const dim3 kv_grid(K * ns * (L::kTwoPass ? 2 : 1), B,
                     (Sk + kTcStep - 1) / kTcStep);
  dkdv_tc_kernel<HD><<<kv_grid, kTcThreads, L::kSmem, s>>>(
      tq, tk, tv, tdo, lse_p, dsum_p, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, ns, Sq, Sqp, Sk, H, K, hd,
      causal, window, q_offset, kv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ns > 1) {
    const long long plane = static_cast<long long>(B) * Sk * K * hd;
    const unsigned blocks = static_cast<unsigned>(
        (plane / 4 + kThreads - 1) / kThreads);
    reduce_kernel<<<blocks, kThreads, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), plane, ns, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 q_grid(H, B, (Sq + L::kRowsQ - 1) / L::kRowsQ);
  dq_tc_kernel<HD><<<q_grid, kTcThreads, L::kSmem, s>>>(
      tq, tk, tv, tdo, lse_p, dsum_p, static_cast<__nv_bfloat16*>(dq), Sq,
      Sqp, Sk, H, K, hd, causal, window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims with a launch (hd % 8 == 0, up to 256; each runs in the
// next built one, flash_wgmma.cuh); the wrapper raises on others.
extern "C" int fa_bwd_supports_head_dim(int hd) {
  return fa_tc::head_dim_ok(hd);
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

// Head dims the tensor-core backward takes (bf16 only): those that run
// in its 64, 128 or 256 instantiation. The wrapper routes other bf16 head
// dims (hd <= 32) and f32 to fa_flash_attention_bwd.
extern "C" int fa_bwd_tc_supports_head_dim(int hd) {
  return fa_tc::head_dim_ok(hd) && hd > 32;
}

// The f32 scratch the bf16 tensor-core backward takes at these shapes,
// in floats: dsum and lse as (2, B, H, Sqp) with Sqp = 64 ceil(Sq / 64),
// then, where the dkdv grid is split into ns > 1 head groups, the
// groups' partial dK and dV as (2, ns, B, Sk, K, hd).
extern "C" long long fa_bwd_tc_scratch_floats(int B, int Sq, int Sk, int H,
                                              int K, int hd) {
  const long long Sqp = (Sq + kTcStep - 1) / kTcStep * kTcStep;
  long long n = 2LL * B * H * Sqp;
  const int ns = head_groups(B, Sk, H, K, fa_tc::padded_head_dim(hd) == 256);
  if (ns > 1) n += 2LL * ns * B * Sk * K * hd;
  return n;
}

// The bf16 tensor-core backward: q, k, v, o, dout and the outputs dq,
// dk, dv bf16 with 16-byte aligned bases; lse (B, H, Sq) f32; scratch
// of fa_bwd_tc_scratch_floats() f32, 16-byte aligned. Three launches on
// `stream` (four with head groups); returns the first non-zero error
// (tensor map, shared-memory opt-in, cudaGetLastError()), else 0.
extern "C" int fa_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int K, int hd, int causal,
    int window, int q_offset, int kv_len, float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!fa_bwd_tc_supports_head_dim(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (fa_tc::padded_head_dim(hd)) {
    case 64:
      return launch_tc<64>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq,
                           Sk, H, K, hd, causal, window, q_offset, kv_len,
                           scale, s);
    case 128:
      return launch_tc<128>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B,
                            Sq, Sk, H, K, hd, causal, window, q_offset,
                            kv_len, scale, s);
    default:
      return launch_tc<256>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B,
                            Sq, Sk, H, K, hd, causal, window, q_offset,
                            kv_len, scale, s);
  }
}
