// Blockwise (flash) attention for Hopper (sm_90a): online-softmax
// attention with causal and sliding-window masks, query offset
// (suffix alignment) and a valid kv length, GQA/MQA by indexing.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py:
//   fwd_tc_kernel (bf16, hd 40-256),        <- flash_attention_bh (:97)
//   flash_attention_kernel (f32; bf16 hd <= 32)  and its _kernel, with the
//                                              GQA repeat and padding of
//                                              ops.py folded in
//
// Head dims: any hd % 8 == 0 up to 256, each in the next built one of 32
// (CUDA cores only), 64, 80 (tensor cores only), 128 and 256, its columns
// from hd on zeros that are never stored (flash_wgmma.cuh,
// `padded_head_dim`, `tc_head_dim`); StableLM-3B's hd 80 runs in the
// tensor-core kernel's 80 instantiation, which issues the products of
// 80 columns, not 128: Q.K^T as five k-slices, P.V as an n64 wgmma over
// the first 64-column box and an n16 one over a 16-column tail box in
// the 32-byte swizzle (`Tile`).
//
// Layout: q and out (B, Sq, H, hd), k and v (B, Sk, K, hd), contiguous,
// f32 or bf16. Query row i has absolute position q_offset + i; key j is
// valid iff j < kv_len, and (causal) j <= q_pos, and (window > 0)
// j > q_pos - window. A row with no valid key gives 0. With a non-null
// `lse` (the training forward) each row's log-sum-exp m + log(l) of the
// scaled scores goes to a (B, H, Sq) f32 buffer (-inf for a row with no
// valid key): the backward (flash_attention_bwd.cu) recomputes P from
// it. Only the kv tiles that hold a valid key for some row of the block
// are visited: [q_lo - window + 1, min(kv_len, q_hi + 1)).
//
// What bounds it: operations. Counted as 4 hd a unmasked (query, key)
// pair (Q.K^T and P.V) at the bf16 tensor-core peak, 989 TFLOP/s: at
// RecurrentGemma-9B's prefill (B 4, H 16 over 1 kv head, hd 256, S 4096,
// window 2048; 4.03e8 pairs) 0.417 ms; at SmolLM-360M's training shape
// (B 2, H 15 over 5, hd 64, S 2048, causal; 6.29e7 pairs) 0.016 ms; at
// StableLM-3B's prefill (B 4, H 32, hd 80, S 4096, causal; 1.07e9 pairs)
// 0.347 ms.
//
// The bf16 kernel (fwd_tc_kernel) runs both products on the tensor
// cores (wgmma, flash_wgmma.cuh) and issues 8 hd operations a pair (10
// hd at hd 256, below), not 4 hd: S = Q.K^T takes bf16 q and k exactly
// (f32 accumulation), but P rounded once to bf16 for P.V misses the
// forward's rule (2 bf16 ulps of the plain f32 softmax, ulp floored at
// 2^-16 of the largest output) at ~7% of the outputs at S 2048, and P
// split into two bf16 terms still misses at hd 256 with a window. So P
// is split into three bf16 terms (hi + mid + lo, each the rounded
// remainder of the ones before), and P.V is three wgmmas a k-slice; this
// matches unsplit f32 P within the rule (tests/test_torch_flash_attention.py
// emulates it).
//
// A second finding on the card sets the accumulation: the tensor cores'
// adds truncate, so a P.V chain over every kv tile of a long row drifted
// past the rule at the serve shape, while a chain over one tile stays
// within it, as the CUDA-core kernel does. Each tile's P.V goes to a
// fresh accumulator and O = O * alpha + P.V is an f32 fma.
//
// What that design does:
// - One block of three warpgroups, the blocks that see the most keys
//   launched first. The producer warpgroup gives up its
//   registers (setmaxnreg 24); one of its threads loads the Q tile once
//   and then keeps a ring of 2 (hd 256), 3 (hd 64, 128) or 4 (hd 80)
//   K/V stages of 64 keys in flight by TMA (4D maps over (hd, heads, S,
//   B), so a ragged tile reads zeros past S, never the next batch), each
//   stage behind a "full" and an "empty" mbarrier.
// - Two consumer warpgroups (setmaxnreg 240) take every stage. At hd 64,
//   80 and 128 a block has 128 query rows, 64 a consumer, with all hd
//   columns of O (at hd 80 O and its partial are 2 x 40 registers). At
//   hd 256 a block has 64 rows and each consumer half of O's columns
//   (both compute S): O plus its per-tile partial is 2 x 64 f32
//   registers a thread, where all 256 columns would need 256.
// - Per stage: S = Q.K^T by hd / 16 wgmmas from shared memory; the mask
//   on boundary tiles only (a tile whose every pair is valid skips it);
//   the online max and sum in f32 on the accumulator fragment, four
//   lanes a row, p = 2^(s scale log2(e) - m scale log2(e)) by the SFU
//   (`ex2`; the f32 kernel keeps expf); P split in registers; the
//   partial P.V by 3 x 4 register-A wgmmas with V read MN-major (at hd
//   80 each an n64 and an n16 wgmma, `wgmma_rs_tile`).
// - Rows with no valid key keep p = 0 (the mask selects, it does not
//   add -inf), so l = 0, out = 0 and lse = -inf, with no NaN.
//
// The f32 kernel (flash_attention_kernel, also bf16 at hd 32) runs on
// the CUDA cores in f32: one block of 256 threads per (64 query rows,
// head, batch), four threads a row each holding an interleaved quarter
// of hd, kv tiles of 32 keys staged in shared memory as f32, a score the
// sum of four quarter dot products (two xor shuffles).
// Build without --use_fast_math (the f32 kernel's expf, IEEE division).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H, int K,
                       int hd, int causal, int window, int q_offset,
                       int kv_len, float scale) {
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
    const int col = (part + 4 * j) * 4;
    qv[j] = row < Sq && col < hd ? load4(q + q_row * hd + col)
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
      if (key < Sk && c4 * 4 < hd) {
        const size_t off =
            ((static_cast<size_t>(b) * Sk + key) * K + kh) * hd + c4 * 4;
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
      const int col = (part + 4 * j) * 4;
      const float4 o = make_float4(acc[j].x / den, acc[j].y / den,
                                   acc[j].z / den, acc[j].w / den);
      if (col < hd) store4(out + q_row * hd + col, o);
    }
    // the row's log-sum-exp of the scaled scores, for the backward
    // (-inf for a row with no valid key)
    if (lse != nullptr && part == 0) {
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
          l_run > 0.f ? m_run + logf(l_run) : __int_as_float(0xff800000);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Sk, int H, int K, int hd, int causal,
           int window, int q_offset, int kv_len, float scale,
           cudaStream_t s) {
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
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, H, K, hd, causal, window, q_offset,
      kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int Sq, int Sk, int H, int K, int causal,
             int window, int q_offset, int kv_len, float scale,
             cudaStream_t s) {
  if (!fa_tc::head_dim_ok(hd)) return static_cast<int>(cudaErrorInvalidValue);
  switch (fa_tc::padded_head_dim(hd)) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                           window, q_offset, kv_len, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                           window, q_offset, kv_len, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                            window, q_offset, kv_len, scale, s);
    default:
      return launch<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                            window, q_offset, kv_len, scale, s);
  }
}

// -- the tensor-core kernel: bf16 at hd 64, 80, 128 and 256 --------------

constexpr int kTcThreads = 384;   // producer + two consumer warpgroups

// hd 64, 80 and 128: each consumer warpgroup owns 64 query rows and all
// hd output columns. hd 256: both own the same 64 rows, half the columns
// each (both compute S), so that O and its per-tile partial fit in
// registers. At hd 80 a tile is a 64-column box and a 16-column tail
// box (10 KiB), so Q.K^T is 5 k-slices and P.V 80 columns: 320 column
// units of MMA a (query, key) pair against the 128 build's 512.
template <int HD>
struct FwdTc {
  static constexpr int kSplit = HD == 256 ? 2 : 1;
  static constexpr int kRows = 128 / kSplit;      // query rows a block
  static constexpr int kCols = HD / kSplit;       // O columns a consumer
  static constexpr int kTile = fa_tc::Tile<HD>::kBytes;     // 64 rows
  // the ring fills what shared memory the block has: 2 stages of 64 KiB
  // at hd 256, 3 of 32 KiB at 128, 4 of 20 KiB at 80
  static constexpr int kStages = HD == 256 ? 2 : HD == 80 ? 4 : 3;
  static constexpr int kQ = kRows / 64 * kTile;
  static constexpr int kSmem =
      1024 + kQ + 2 * kStages * kTile + 8 * (1 + 2 * kStages);
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tq_tail,
              const __grid_constant__ CUtensorMap tk_tail,
              const __grid_constant__ CUtensorMap tv_tail,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              int Sq, int Sk, int H, int K, int hd, int causal, int window,
              int q_offset, int kv_len, float scale) {
  using namespace fa_tc;
  using L = FwdTc<HD>;
  constexpr int NC = L::kCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);        // kRows / 64 tiles
  uint8_t* skv = sq + L::kQ;                 // stage s: K tile, V tile
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(skv + 2 * L::kStages * L::kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  // the grid's slowest dimension walks the query blocks from the last:
  // under a causal mask the blocks that see the most keys start first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / (H / K);
  const int q_first = (gridDim.z - 1 - blockIdx.z) * L::kRows;
  const int kv_end = min(kv_len, Sk);
  int t_begin, t_end;
  kv_tiles(q_first, L::kRows, Sq, q_offset, kv_end, causal, window, &t_begin,
           &t_end);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);     // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int r = 0; r < L::kRows / 64; ++r)
        tma_load_tile<HD>(sq + r * L::kTile, &tq, q_full, h, q_first + 64 * r,
                          b, &tq_tail);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kt = skv + stage * 2 * L::kTile;
        mbar_expect_tx(&full[stage], 2 * L::kTile);
        tma_load_tile<HD>(kt, &tk, &full[stage], kh, tile * kTileRows, b,
                          &tk_tail);
        tma_load_tile<HD>(kt + L::kTile, &tv, &full[stage], kh,
                          tile * kTileRows, b, &tv_tail);
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers
    regs_inc<240>();
    const int tid = threadIdx.x & 127;
    const int blk = L::kSplit == 1 ? wg - 1 : 0;    // row block
    const int half = L::kSplit == 1 ? 0 : wg - 1;   // column block
    const int row0 = q_first + 64 * blk;
    const int ra = row0 + frag_row(0, tid);   // this thread's rows ra, ra + 8
    const uint8_t* qt = sq + blk * L::kTile;
    float o[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) o[i] = 0.f;
    // the running max m of the unscaled scores and sum l of each row
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const float c = scale * kLog2e;
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = t_begin; tile < t_end; ++tile) {
      const int k0 = tile * kTileRows;
      mbar_wait(&full[stage], phase);
      const uint8_t* kt = skv + stage * 2 * L::kTile;
      float s[32];    // the first wgmma overwrites it
      wg_fence();
      gemm_ss<HD>(s, qt, kt);
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // the mask only where some pair of the tile is invalid
      uint32_t valid = 0xffffffffu;
      if (!tile_all_valid(row0, k0, Sq, kv_end, causal, window, q_offset)) {
        valid = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + frag_col(i, tid);
          const int pos = q_offset + ra + 8 * ((i >> 1) & 1);
          bool ok = key < kv_end;
          if (causal) ok = ok && key <= pos;
          if (window > 0) ok = ok && key > pos - window;
          s[i] = ok ? s[i] : kNegInf;
          valid |= (ok ? 1u : 0u) << i;
        }
      }
      // online softmax, rows ra (r = 0) and ra + 8 (r = 1), on the
      // unscaled scores (scale > 0: the same max): p = 2^(s c - m c),
      // alpha = 2^((m_old - m) c), exactly 1 while a row has seen no
      // valid key (m_old = m = kNegInf)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      const float alpha[2] = {ex2((m[0] - mx[0]) * c),
                              ex2((m[1] - mx[1]) * c)};
      const float mc[2] = {mx[0] * c, mx[1] * c};
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ((valid >> i) & 1u) ? ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]))
                                   : 0.f;
        ps[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + quad_sum(ps[r]);
        m[r] = mx[r];
      }

      // this tile's P.V with P in three bf16 terms, into a fresh
      // accumulator: the tensor cores' adds truncate, and a chain over
      // every tile of a long row drifts past the rule; one tile's chain
      // does not. O = O * alpha + P.V in f32 on the CUDA cores.
      const uint8_t* vt = kt + L::kTile + half * (NC / 64) * kBoxBytes;
      uint32_t pf[4][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_frag<3>(s, kk, pf[kk]);
      float pv[NC / 2];   // the first wgmma overwrites it
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int t = 0; t < 3; ++t)
          wgmma_rs_tile<NC>(pv, pf[kk][t], vt, kk, kk + t > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(pv);
      mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= Sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      const size_t q_row = (static_cast<size_t>(b) * Sq + row) * H + h;
      __nv_bfloat16* orow = out + q_row * hd + half * NC;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        if (half * NC + 8 * j < hd)     // not a padded column group
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (tid & 3)) =
              pack_bf16(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      }
      // the row's log-sum-exp, for the backward (-inf: no valid key)
      if (lse != nullptr && half == 0 && (tid & 3) == 0) {
        lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
            l[r] > 0.f ? m[r] * scale + logf(l[r])
                       : __int_as_float(0xff800000);
      }
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Sk, int H, int K, int hd,
              int causal, int window, int q_offset, int kv_len, float scale,
              cudaStream_t s) {
  using L = FwdTc<HD>;
  CUtensorMap tq, tk, tv;
  int e = fa_tc::make_map(&tq, q, hd, H, Sq, B);
  if (e == 0) e = fa_tc::make_map(&tk, k, hd, K, Sk, B);
  if (e == 0) e = fa_tc::make_map(&tv, v, hd, K, Sk, B);
  // the tail boxes' maps (hd 80 build); unused copies elsewhere
  CUtensorMap tq_tail = tq, tk_tail = tk, tv_tail = tv;
  if (fa_tc::Tile<HD>::kTail > 0) {
    if (e == 0) e = fa_tc::make_map(&tq_tail, q, hd, H, Sq, B, true);
    if (e == 0) e = fa_tc::make_map(&tk_tail, k, hd, K, Sk, B, true);
    if (e == 0) e = fa_tc::make_map(&tv_tail, v, hd, K, Sk, B, true);
  }
  if (e != 0) return e;
  // opt in to the dynamic shared memory once, before the first launch
  // (outside any CUDA-graph capture that follows it)
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const dim3 grid(H, B, (Sq + L::kRows - 1) / L::kRows);
  fwd_tc_kernel<HD><<<grid, kTcThreads, L::kSmem, s>>>(
      tq, tk, tv, tq_tail, tk_tail, tv_tail,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      Sq, Sk, H, K, hd, causal, window, q_offset, kv_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims with a launch (hd % 8 == 0, up to 256; each runs in the
// next built one, flash_wgmma.cuh); the wrapper raises on others.
extern "C" int fa_supports_head_dim(int hd) {
  return fa_tc::head_dim_ok(hd);
}

// dtype: 0 f32, 1 bf16. lse: null, or a (B, H, Sq) f32 buffer that gets
// each row's log-sum-exp (the training forward; serve passes null).
// Returns cudaGetLastError() after the launch (or the error of the
// shared-memory opt-in).
extern "C" int fa_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int Sq, int Sk,
                                  int H, int K, int hd, int dtype, int causal,
                                  int window, int q_offset, int kv_len,
                                  float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, lse, B, Sq, Sk, H, K,
                                   causal, window, q_offset, kv_len, scale,
                                   s);
  return dispatch<float>(hd, q, k, v, out, lse, B, Sq, Sk, H, K, causal,
                         window, q_offset, kv_len, scale, s);
}

// Head dims the tensor-core kernel takes (bf16 only): those that run in
// its 64, 80, 128 or 256 instantiation. The wrapper routes other bf16
// head dims (hd <= 32) and f32 to fa_flash_attention.
extern "C" int fa_tc_supports_head_dim(int hd) {
  return fa_tc::head_dim_ok(hd) && hd > 32;
}

// The build of the tensor-core kernel that head dim hd runs in (64, 80,
// 128 or 256), 0 where it has none.
extern "C" int fa_tc_build_head_dim(int hd) {
  return fa_tc_supports_head_dim(hd) ? fa_tc::tc_head_dim(hd) : 0;
}

// The bf16 tensor-core forward: q, k, v, out bf16 with 16-byte aligned
// bases; lse null or (B, H, Sq) f32. Returns 0, the error of building a
// tensor map or of the shared-memory opt-in, or cudaGetLastError() after
// the launch.
extern "C" int fa_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int B, int Sq, int Sk, int H, int K,
                                     int hd, int causal, int window,
                                     int q_offset, int kv_len, float scale,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (!fa_tc_supports_head_dim(hd))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (fa_tc::tc_head_dim(hd)) {
    case 64:
      return launch_tc<64>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                           window, q_offset, kv_len, scale, s);
    case 80:
      return launch_tc<80>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                           window, q_offset, kv_len, scale, s);
    case 128:
      return launch_tc<128>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                            window, q_offset, kv_len, scale, s);
    default:
      return launch_tc<256>(q, k, v, out, lse, B, Sq, Sk, H, K, hd, causal,
                            window, q_offset, kv_len, scale, s);
  }
}
