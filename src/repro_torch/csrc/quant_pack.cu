// Quantize-pack kernel family for Hopper (sm_90a): the wire format of
// the M-DSL uplink and downlink.
//
// Replaces the Pallas TPU kernels of repro/kernels/quant_pack/quant_pack.py:
//   quant_pack_ef_kernel<BITS, true>   <- quant_pack_ef_2d (_make_ef_kernel)
//   quant_pack_ef_kernel<BITS, false>  <- quant_pack_2d (_kernel_int8/_int4)
//   dequant_kernel<BITS>               <- dequant_unpack_2d (_make_dequant_kernel)
//
// What bounds them here: device-memory bytes. Per element the fused
// uplink pass reads 8 B (delta + residual) and writes 4 B of residual
// plus 1 or 0.5 B of payload, against ~25 integer and float operations —
// far below the card's operations-per-byte balance. At the M-DSL paper
// shapes (one (256, 128) block per leaf and worker) a launch moves only
// ~20 MB, so the launch itself, not the bytes, is what the time shows.
//
// What the design does about it: one thread block per (256, 128) tile
// and worker (grid = block x worker), so all C workers of a leaf go in
// ONE launch instead of C. Pass 1 reads the tile as float4 and reduces
// |acc| to amax (warp shuffles, then shared memory); pass 2 reads the
// tile again (it is 128 KiB and still in L2), quantizes, packs and
// writes with 16-byte loads and 4-byte stores, neighbouring threads on
// neighbouring lanes. Nothing is staged in shared memory, so no dynamic
// shared memory or opt-in is needed.
//
// Bit-exactness (the wire spec the JAX refs pin):
//   * block_uniform: uint32 wraparound hash of (seed, block, row, lane);
//     `block` is the block's index within the worker's own leaf;
//   * scale = amax * f32(1/qmax), written as the exact float constant;
//   * q = clip(floor(acc / scale + u)) with IEEE division and no FMA
//     contraction (__fdiv_rn, __fadd_rn);
//   * residual = fmaf(-q, scale, acc), the contraction XLA applies to the
//     JAX ref's `acc - q * scale`;
//   * int4: output row r of a block holds q rows r (low nibble) and
//     r + 128 (high nibble), biased by +8.
// Build without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 256;
constexpr int kLanes = 128;
constexpr int kTile = kBlockRows * kLanes;  // elements per scale block
constexpr int kThreads = 256;

template <int BITS> struct Q;
template <> struct Q<8> {
  static constexpr float qmax = 127.0f;
  static constexpr float inv = static_cast<float>(1.0 / 127.0);
};
template <> struct Q<4> {
  static constexpr float qmax = 7.0f;
  static constexpr float inv = static_cast<float>(1.0 / 7.0);
};

__device__ __forceinline__ float block_uniform(uint32_t seed, uint32_t block,
                                               uint32_t row, uint32_t col) {
  uint32_t h = seed * 2654435761u + block * 976686449u + row * 1664525u +
               col * 22695477u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
}

template <int BITS>
__device__ __forceinline__ float quantize(float acc, float scale, float u) {
  const float q = floorf(__fadd_rn(__fdiv_rn(acc, scale), u));
  return fminf(fmaxf(q, -Q<BITS>::qmax), Q<BITS>::qmax);
}

template <bool EF>
__device__ __forceinline__ float4 load_acc(const float4* __restrict__ x,
                                           const float4* __restrict__ r,
                                           int i) {
  float4 a = x[i];
  if (EF) {
    const float4 b = r[i];
    a.x = __fadd_rn(a.x, b.x);
    a.y = __fadd_rn(a.y, b.y);
    a.z = __fadd_rn(a.z, b.z);
    a.w = __fadd_rn(a.w, b.w);
  }
  return a;
}

template <int BITS>
__device__ __forceinline__ float4 quantize4(float4 a, float scale,
                                            uint32_t seed, uint32_t blk,
                                            int row, int col) {
  float4 q;
  q.x = quantize<BITS>(a.x, scale, block_uniform(seed, blk, row, col));
  q.y = quantize<BITS>(a.y, scale, block_uniform(seed, blk, row, col + 1));
  q.z = quantize<BITS>(a.z, scale, block_uniform(seed, blk, row, col + 2));
  q.w = quantize<BITS>(a.w, scale, block_uniform(seed, blk, row, col + 3));
  return q;
}

__device__ __forceinline__ float4 residual4(float4 a, float4 q, float s) {
  return make_float4(fmaf(-q.x, s, a.x), fmaf(-q.y, s, a.y),
                     fmaf(-q.z, s, a.z), fmaf(-q.w, s, a.w));
}

__device__ __forceinline__ unsigned char nibbles(float lo, float hi) {
  return static_cast<unsigned char>(static_cast<int>(lo + 8.0f) |
                                    (static_cast<int>(hi + 8.0f) << 4));
}

// grid = (blocks per worker leaf, C); x, r, res: (C, rows, 128) f32;
// packed: (C, rows, 128) int8 or (C, rows/2, 128) uint8; scales (C, nb).
template <int BITS, bool EF>
__global__ void __launch_bounds__(kThreads)
quant_pack_kernel(const float* __restrict__ x, const float* __restrict__ r,
                  const int32_t* __restrict__ seeds, void* __restrict__ packed,
                  float* __restrict__ scales, float* __restrict__ res,
                  int rows) {
  const int blk = blockIdx.x;
  const int w = blockIdx.y;
  const size_t base =
      (static_cast<size_t>(w) * rows + static_cast<size_t>(blk) * kBlockRows) *
      kLanes;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const float4* r4 = EF ? reinterpret_cast<const float4*>(r + base) : nullptr;

  // pass 1: amax over the tile
  float m = 0.0f;
  for (int i = threadIdx.x; i < kTile / 4; i += kThreads) {
    const float4 a = load_acc<EF>(x4, r4, i);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                       fmaxf(fabsf(a.z), fabsf(a.w))));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  __shared__ float s_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float amax = warp_max[0];
    for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, warp_max[i]);
    const float scale = amax > 0.0f ? __fmul_rn(amax, Q<BITS>::inv) : 1.0f;
    s_scale = scale;
    scales[static_cast<size_t>(w) * gridDim.x + blk] = scale;
  }
  __syncthreads();
  const float scale = s_scale;
  const uint32_t seed = static_cast<uint32_t>(seeds[w]);
  float4* o4 = EF ? reinterpret_cast<float4*>(res + base) : nullptr;

  // pass 2: quantize, pack, residual
  if (BITS == 8) {
    char4* p4 =
        reinterpret_cast<char4*>(static_cast<int8_t*>(packed) + base);
    for (int i = threadIdx.x; i < kTile / 4; i += kThreads) {
      const int e = i * 4;
      const float4 a = load_acc<EF>(x4, r4, i);
      const float4 q = quantize4<BITS>(a, scale, seed, blk, e >> 7, e & 127);
      p4[i] = make_char4(static_cast<signed char>(q.x),
                         static_cast<signed char>(q.y),
                         static_cast<signed char>(q.z),
                         static_cast<signed char>(q.w));
      if (EF) o4[i] = residual4(a, q, scale);
    }
  } else {
    constexpr int kHalf = kTile / 8;  // float4 groups in the top 128 rows
    uchar4* p4 =
        reinterpret_cast<uchar4*>(static_cast<uint8_t*>(packed) + base / 2);
    for (int i = threadIdx.x; i < kHalf; i += kThreads) {
      const int e = i * 4;
      const int row = e >> 7, col = e & 127;
      const float4 lo = load_acc<EF>(x4, r4, i);
      const float4 hi = load_acc<EF>(x4, r4, i + kHalf);
      const float4 ql = quantize4<BITS>(lo, scale, seed, blk, row, col);
      const float4 qh = quantize4<BITS>(hi, scale, seed, blk, row + 128, col);
      p4[i] = make_uchar4(nibbles(ql.x, qh.x), nibbles(ql.y, qh.y),
                          nibbles(ql.z, qh.z), nibbles(ql.w, qh.w));
      if (EF) {
        o4[i] = residual4(lo, ql, scale);
        o4[i + kHalf] = residual4(hi, qh, scale);
      }
    }
  }
}

// One thread per output element of n = blocks * 32768; scales are
// indexed by the global block (stacked workers are consecutive blocks).
template <int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const void* __restrict__ packed,
               const float* __restrict__ scales, float* __restrict__ out,
               long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long b = i / kTile;
    float q;
    if (BITS == 8) {
      q = static_cast<float>(static_cast<const int8_t*>(packed)[i]);
    } else {
      const int within = static_cast<int>(i - b * kTile);
      const int row = within >> 7, col = within & 127;
      const int byte = static_cast<const uint8_t*>(
          packed)[b * (kTile / 2) + (row & 127) * kLanes + col];
      q = static_cast<float>(row < 128 ? (byte & 0xF) - 8 : (byte >> 4) - 8);
    }
    out[i] = __fmul_rn(q, scales[b]);
  }
}

template <int BITS>
void launch_quant_pack(const float* x, const float* r, const int32_t* seeds,
                       void* packed, float* scales, float* res, int C,
                       int rows, cudaStream_t s) {
  const dim3 grid(rows / kBlockRows, C);
  if (r != nullptr)
    quant_pack_kernel<BITS, true>
        <<<grid, kThreads, 0, s>>>(x, r, seeds, packed, scales, res, rows);
  else
    quant_pack_kernel<BITS, false>
        <<<grid, kThreads, 0, s>>>(x, r, seeds, packed, scales, res, rows);
}

}  // namespace

// x, r, res: (C, rows, 128) f32 (r and res NULL for the plain pass);
// seeds: (C,) int32; returns cudaGetLastError().
extern "C" int qp_quant_pack(const void* x, const void* r, const void* seeds,
                             void* packed, void* scales, void* res, int C,
                             int rows, int bits, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rf = static_cast<const float*>(r);
  const auto* sd = static_cast<const int32_t*>(seeds);
  auto* sc = static_cast<float*>(scales);
  auto* rs = static_cast<float*>(res);
  if (bits == 8)
    launch_quant_pack<8>(xf, rf, sd, packed, sc, rs, C, rows, s);
  else
    launch_quant_pack<4>(xf, rf, sd, packed, sc, rs, C, rows, s);
  return static_cast<int>(cudaGetLastError());
}

// packed + scales over `blocks` consecutive (256, 128) blocks -> f32.
extern "C" int qp_dequant_unpack(const void* packed, const void* scales,
                                 void* out, long long blocks, int bits,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long n = blocks * kTile;
  const long long want = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  if (bits == 8)
    dequant_kernel<8><<<grid, kThreads, 0, s>>>(packed, sc, o, n);
  else
    dequant_kernel<4><<<grid, kThreads, 0, s>>>(packed, sc, o, n);
  return static_cast<int>(cudaGetLastError());
}
