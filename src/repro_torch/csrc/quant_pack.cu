// Quantize-pack kernel family for Hopper (sm_90a): the wire format of
// the M-DSL uplink and downlink.
//
// Replaces the Pallas TPU kernels of repro/kernels/quant_pack/quant_pack.py:
//   quant_pack_kernel<BITS, true>   <- quant_pack_ef_2d (_make_ef_kernel)
//   quant_pack_kernel<BITS, false>  <- quant_pack_2d (_kernel_int8/_int4)
//   dequant_kernel<BITS>            <- dequant_unpack_2d (_make_dequant_kernel)
//
// What bounds them here: device-memory bytes. Per element the fused
// uplink pass reads 8 B (delta + residual) and writes 4 B of residual
// plus 1 or 0.5 B of payload, against ~25 integer and float operations —
// far below the card's operations-per-byte balance. At the M-DSL paper
// shapes (one (256, 128) block per leaf and worker) a launch moves only
// ~20 MB, so the launch itself, not the bytes, is what the time shows.
//
// What held the first design back: one 256-thread block per (256, 128)
// tile and worker, reading the tile twice (amax, then quantize) in two
// 32-iteration float4 loops. At the paper shapes that is one tile per
// leaf (C = 1 downlink, C = 50 uplink), so a launch took ~25 us on one
// SM whatever the other 131 did: a latency chain, not bytes.
//
// The design now: each tile and worker gets a thread-block cluster of 8
// CTAs (__cluster_dims__(8, 1, 1); grid = (8 x tiles per leaf, C)), and
// every element is read from device memory once, into registers.
//  * Row ownership (`vec_index` below, the one place the split is made;
//    the wrapper's `_plan` passes the cluster size, the rows a CTA and
//    the grid, which the entry point checks): int8, CTA k owns tile rows
//    [32k, 32k + 32); int4, rows [16k, 16k + 16) and [128 + 16k, 128 +
//    16k + 16), so that both nibbles of an output byte (row r low, row
//    r + 128 high) are quantized in one CTA. Each of 256 threads holds 4
//    float4 (16 elements; under EF x and r, 8 loads), neighbouring
//    threads on neighbouring 16-byte words.
//  * Scale: each CTA reduces |acc| to its amax (warp shuffles, then
//    shared memory); the cluster's amax is the max of the 8 CTAs' words,
//    read over distributed shared memory (mapa + ld.shared::cluster)
//    between two cluster barriers. Max is exact, so the scale is bitwise
//    the plain version's in any order. Rank 0 writes `scales`. The
//    second barrier (each CTA arrives after its remote reads, waits
//    before it exits) keeps every CTA's word alive until all have read
//    it, and overlaps with the quantize.
//  * Quantize from registers with the same hash arguments as before (the
//    tile's index within the worker's leaf, the row within the tile, the
//    lane), then pack and write with 4-byte stores, and the residual
//    with 16-byte stores.
// Nothing is staged in shared memory beyond 9 words, so no dynamic
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

#include "tma.cuh"

namespace {

constexpr int kBlockRows = 256;
constexpr int kLanes = 128;
constexpr int kTile = kBlockRows * kLanes;  // elements per scale block
constexpr int kThreads = 256;
constexpr int kCluster = 8;                         // CTAs a tile
constexpr int kCtaRows = kBlockRows / kCluster;     // tile rows a CTA
constexpr int kVecs = kCtaRows * kLanes / 4 / kThreads;  // float4 a thread
constexpr int kDqThreads = 256;                     // dequant: threads a CTA

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

__device__ __forceinline__ float amax4(float4 a) {
  return fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fmaxf(fabsf(a.z), fabsf(a.w)));
}

// the float4 index within the tile (0 .. kTile / 4 - 1) of vector j of
// thread t in cluster rank k: int8, rows [32k, 32k + 32); int4, vectors
// 0-1 in rows [16k, 16k + 16) and vectors 2-3 the rows 128 below them
template <int BITS>
__device__ __forceinline__ int vec_index(int k, int j, int t) {
  constexpr int kRowVecs = kLanes / 4;                 // float4 in a row
  if (BITS == 8) return (k * kCtaRows + j * 8) * kRowVecs + t;
  return ((j & 1) * 8 + k * (kCtaRows / 2) + (j >> 1) * 128) * kRowVecs + t;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at `p` in the shared memory of cluster CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(tma::smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// grid = (kCluster x tiles per worker leaf, C), clusters of kCluster
// CTAs along x; x, r, res: (C, rows, 128) f32; packed: (C, rows, 128)
// int8 or (C, rows/2, 128) uint8; scales (C, rows / 256).
template <int BITS, bool EF>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
quant_pack_kernel(const float* __restrict__ x, const float* __restrict__ r,
                  const int32_t* __restrict__ seeds, void* __restrict__ packed,
                  float* __restrict__ scales, float* __restrict__ res,
                  int rows) {
  const int rank = blockIdx.x % kCluster;     // = %cluster_ctarank
  const int blk = blockIdx.x / kCluster;
  const int w = blockIdx.y;
  const int t = threadIdx.x;
  const size_t base =
      (static_cast<size_t>(w) * rows + static_cast<size_t>(blk) * kBlockRows) *
      kLanes;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const float4* r4 = EF ? reinterpret_cast<const float4*>(r + base) : nullptr;

  // the one read of this CTA's rows, and their amax
  float4 acc[kVecs];
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    acc[j] = load_acc<EF>(x4, r4, vec_index<BITS>(rank, j, t));
    m = fmaxf(m, amax4(acc[j]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  __shared__ float cta_max;
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  if (t == 0) {
    float a = warp_max[0];
    for (int i = 1; i < kThreads / 32; ++i) a = fmaxf(a, warp_max[i]);
    cta_max = a;
  }
  // the cluster's amax: lane l of every warp reads CTA l's word
  cluster_arrive();
  cluster_wait();
  const int lane = t & 31;
  float amax = ld_cluster(&cta_max, static_cast<uint32_t>(lane % kCluster));
  for (int off = kCluster / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  cluster_arrive();             // this CTA is done reading the others
  const float scale = amax > 0.0f ? __fmul_rn(amax, Q<BITS>::inv) : 1.0f;
  if (rank == 0 && t == 0)
    scales[static_cast<size_t>(w) * (gridDim.x / kCluster) + blk] = scale;

  // quantize from registers, pack, residual
  const uint32_t seed = static_cast<uint32_t>(seeds[w]);
  float4* o4 = EF ? reinterpret_cast<float4*>(res + base) : nullptr;
  if (BITS == 8) {
    char4* p4 =
        reinterpret_cast<char4*>(static_cast<int8_t*>(packed) + base);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int i = vec_index<BITS>(rank, j, t);
      const int e = i * 4;
      const float4 q = quantize4<BITS>(acc[j], scale, seed, blk, e >> 7,
                                       e & 127);
      p4[i] = make_char4(static_cast<signed char>(q.x),
                         static_cast<signed char>(q.y),
                         static_cast<signed char>(q.z),
                         static_cast<signed char>(q.w));
      if (EF) o4[i] = residual4(acc[j], q, scale);
    }
  } else {
    constexpr int kHalf = kTile / 8;  // float4 groups in the top 128 rows
    uchar4* p4 =
        reinterpret_cast<uchar4*>(static_cast<uint8_t*>(packed) + base / 2);
#pragma unroll
    for (int j = 0; j < kVecs / 2; ++j) {
      const int i = vec_index<BITS>(rank, j, t);   // low row; high: + kHalf
      const int e = i * 4;
      const int row = e >> 7, col = e & 127;
      const float4 ql = quantize4<BITS>(acc[j], scale, seed, blk, row, col);
      const float4 qh =
          quantize4<BITS>(acc[j + 2], scale, seed, blk, row + 128, col);
      p4[i] = make_uchar4(nibbles(ql.x, qh.x), nibbles(ql.y, qh.y),
                          nibbles(ql.z, qh.z), nibbles(ql.w, qh.w));
      if (EF) {
        o4[i] = residual4(acc[j], ql, scale);
        o4[i + kHalf] = residual4(acc[j + 2], qh, scale);
      }
    }
  }
  cluster_wait();               // no CTA leaves while its word is read
}

// Decode, a 2D grid (parts x tiles per worker, C): a CTA of 8 warps
// takes 1 / parts of one (256, 128) tile of one worker, each warp one
// 512-byte chunk of the tile's payload. Thread 0 reads the tile's scale
// once into shared memory. A warp loads its chunk with one 16-byte
// vector a lane (every payload byte read once), passes it through
// shared memory so that lane l then holds words l, l + 32, l + 64, l +
// 96, and stores each word's 4 values (and at int4 its high nibbles' 4,
// in row r + 128) as one float4: every store instruction writes 512
// contiguous bytes. No division by the tile size and no grid-stride
// loop.
template <int BITS>
__global__ void __launch_bounds__(kDqThreads)
dequant_kernel(const uint8_t* __restrict__ packed,
               const float* __restrict__ scales, float* __restrict__ out,
               int nb, int parts) {
  constexpr int kWarps = kDqThreads / 32;
  constexpr int kTileBytes = kTile / (BITS == 4 ? 2 : 1);
  __shared__ float s_scale;
  __shared__ uint4 xpose[kWarps][32];
  const int tile = blockIdx.x / parts, part = blockIdx.x % parts;
  const size_t t = static_cast<size_t>(blockIdx.y) * nb + tile;  // global
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = part * kWarps + warp;            // its 512 bytes
  const uint4* src = reinterpret_cast<const uint4*>(packed + t * kTileBytes);
  float* dst = out + t * kTile;
  if (threadIdx.x == 0) s_scale = scales[t];
  xpose[warp][lane] = src[chunk * 32 + lane];
  __syncthreads();
  const float sc = s_scale;
  const uint32_t* x = reinterpret_cast<const uint32_t*>(xpose[warp]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = x[32 * i + lane];
    const int b = chunk * 512 + 128 * i + 4 * lane;   // tile byte
    float q[4], h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (word >> (8 * j)) & 0xFFu;
      if constexpr (BITS == 8) {
        q[j] = static_cast<float>(static_cast<int8_t>(byte));
      } else {
        q[j] = static_cast<float>(static_cast<int>(byte & 0xF) - 8);
        h[j] = static_cast<float>(static_cast<int>(byte >> 4) - 8);
      }
    }
    // int8: byte b is output b; int4: packed row b / 128 holds output
    // rows b / 128 (low nibbles) and b / 128 + 128 (high)
    float* o = dst + (BITS == 8 ? b : (b >> 7) * kLanes + (b & 127));
    *reinterpret_cast<float4*>(o) =
        make_float4(__fmul_rn(q[0], sc), __fmul_rn(q[1], sc),
                    __fmul_rn(q[2], sc), __fmul_rn(q[3], sc));
    if constexpr (BITS == 4)
      *reinterpret_cast<float4*>(o + 128 * kLanes) =
          make_float4(__fmul_rn(h[0], sc), __fmul_rn(h[1], sc),
                      __fmul_rn(h[2], sc), __fmul_rn(h[3], sc));
  }
}

template <int BITS>
void launch_quant_pack(const float* x, const float* r, const int32_t* seeds,
                       void* packed, float* scales, float* res, int rows,
                       dim3 grid, cudaStream_t s) {
  if (r != nullptr)
    quant_pack_kernel<BITS, true>
        <<<grid, kThreads, 0, s>>>(x, r, seeds, packed, scales, res, rows);
  else
    quant_pack_kernel<BITS, false>
        <<<grid, kThreads, 0, s>>>(x, r, seeds, packed, scales, res, rows);
}

}  // namespace

// x, r, res: (C, rows, 128) f32 (r and res NULL for the plain pass);
// seeds: (C,) int32. The launch plan (cluster size, tile rows a CTA,
// grid) comes from the wrapper's `_plan`; one that is not this kernel's
// returns cudaErrorInvalidValue. Returns cudaGetLastError().
extern "C" int qp_quant_pack(const void* x, const void* r, const void* seeds,
                             void* packed, void* scales, void* res, int C,
                             int rows, int bits, int cluster, int cta_rows,
                             int grid_x, int grid_y, void* stream) {
  if (cluster != kCluster || cta_rows != kCtaRows || rows % kBlockRows != 0 ||
      grid_x != kCluster * (rows / kBlockRows) || grid_y != C ||
      (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rf = static_cast<const float*>(r);
  const auto* sd = static_cast<const int32_t*>(seeds);
  auto* sc = static_cast<float*>(scales);
  auto* rs = static_cast<float*>(res);
  const dim3 grid(grid_x, grid_y);
  if (bits == 8)
    launch_quant_pack<8>(xf, rf, sd, packed, sc, rs, rows, grid, s);
  else
    launch_quant_pack<4>(xf, rf, sd, packed, sc, rs, rows, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// packed (C, rows, 128) int8 / (C, rows / 2, 128) uint8, 16-byte
// aligned, + scales (C, rows / 256) -> out (C, rows, 128) f32. The launch
// plan (threads, CTAs a tile, grid) comes from the wrapper's
// `_dequant_plan`; one this kernel does not take returns
// cudaErrorInvalidValue. Returns cudaGetLastError().
extern "C" int qp_dequant_unpack(const void* packed, const void* scales,
                                 void* out, int C, int rows, int bits,
                                 int threads, int parts, int grid_x,
                                 int grid_y, void* stream) {
  const int chunks = kTile / (bits == 4 ? 2 : 1) / 512;
  if ((bits != 8 && bits != 4) || rows < kBlockRows ||
      rows % kBlockRows != 0 || threads != kDqThreads ||
      parts * (kDqThreads / 32) != chunks ||
      grid_x != parts * (rows / kBlockRows) || grid_y != C || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  const dim3 grid(grid_x, grid_y);
  const int nb = rows / kBlockRows;
  if (bits == 8)
    dequant_kernel<8><<<grid, kDqThreads, 0, s>>>(p, sc, o, nb, parts);
  else
    dequant_kernel<4><<<grid, kDqThreads, 0, s>>>(p, sc, o, nb, parts);
  return static_cast<int>(cudaGetLastError());
}
