// Fused dequant + masked aggregate for Hopper (sm_90a): the parameter
// server's Eq.-7 decode of C packed uplink payloads of one leaf.
//
// Replaces the Pallas TPU kernel repro/kernels/wire_agg/wire_agg.py:
//   wire_agg_kernel<BITS, MODE, VEC>  <- wire_agg_2d (_make_agg_kernel /
//                                        _aggregate_block)
//
// What bounds it here: device-memory bytes. Per output element it reads
// C payload bytes (int8) or C/2 (int4) and writes 4 B, with ~3C float
// operations for the mean — below the card's balance point, but not by
// much once every operation is an instruction of its own (~6 a worker
// and element). At the M-DSL paper shapes (C = 50, one (256, 128) block
// per leaf) a launch moves under 1 MB, so latency sets its time there; a
// large leaf (rows 8192) moves 30 MB at int4.
//
// What held the first design back: one thread per output element; each
// block loaded C scales, masks and weights, then one thread summed the C
// totals in a serial chain between two barriers before any payload byte
// moved; each thread then read one byte per worker from device memory in
// a chain of dependent adds, and at int4 the threads of rows r and
// r + 128 read the same packed byte from two blocks.
//
// The design now (the launch is the wrapper's `_plan`, which the entry
// point checks):
//  * A CTA owns a strip of `strip` packed rows (1, 2, 4 or 8) of one
//    scale block. Thread 0 stages all C workers' bytes of the strip into
//    shared memory with one TMA copy: a box (128 lanes, strip rows, C
//    workers) of a 3D map over (128, packed rows, C) behind an mbarrier.
//    When C is over a box's 256 or the strip's bytes overflow shared
//    memory, the workers come in chunks through a ring of two stages: a
//    stage is refilled as soon as every thread has left it (a barrier),
//    and the sum goes on in worker order. (Smaller chunks, all in flight
//    at once, measured slower on the card: each box and barrier costs
//    more than the overlap gains.)
//  * While the copy is in flight every thread writes its share of the C
//    worker records (mask * weight, the strip block's scale, the staged
//    offset) to shared memory, all loads at once; warp 0 then packs the
//    records of the workers whose mask * weight is nonzero to the front,
//    in worker order (ballots). A worker with mask * weight = 0 adds
//    exact zeros, which change no sum that is not -0, and no sum here
//    is; so the sums' loops run over the kept workers with no branch.
//  * A thread takes VEC payload bytes of one packed row and emits both
//    nibbles of each at int4 (rows r and r + 128 of the block), so every
//    payload byte is read from device memory once. VEC is 1 (128
//    threads a row) at the main path's one-block leaves, where the time
//    is a latency chain and more warps shorten it, and 4 (one 32-bit
//    shared load a worker, 16-byte stores) at large leaves, where
//    instruction issue competes with the bytes. Each thread sums the
//    mask * weight total in worker order beside its outputs (no serial
//    chain before the payload). Bytes become values by the 2^23 trick
//    (exact), not by the slow integer-to-float conversion. (A table of
//    each worker's 16 int4 terms in shared memory measured no faster.)
//  * The robust modes (C <= kMaxRobust, one stage) sort from the same
//    staged bytes, one output element at a time.
//
// Modes, as repro/kernels/wire_agg/ref.py:
//   mean / sum      s = sum_c mw_c * d_c (mw = mask * weight, summed in
//                   worker order with __fadd_rn/__fmul_rn), mean divides
//                   by max(sum_c mw_c, 1)
//   median          d_c * w_c of the k delivered workers, lost workers at
//                   +inf, sorted per thread in a local array; the
//                   order statistics (k-1)//2 and (k-1) - (k-1)//2
//   trimmed_mean    drop t = min(int(trim * k), (k-1)//2) per end, mean
//                   of the rest, summed in sorted order
// A round with every upload lost (k = 0) aggregates to 0. The robust
// modes hold at most kMaxRobust workers (the wrapper raises above it).
// Build without --use_fast_math.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kMaxRobust = 64;
constexpr int kMaxBox = 256;          // elements along a TMA box dimension
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may use

enum Mode { kMean = 0, kSum = 1, kMedian = 2, kTrimmed = 3 };

// dynamic shared memory of a plan: 128 bytes of alignment slack, the
// stages (chunk workers x strip rows x 128 bytes each), a 16-byte record
// a worker, one mbarrier a stage, and each chunk's first kept record (and
// the count). The kernel has no static shared memory, so a plan may take
// all of kSmemMax.
__host__ __device__ inline int plan_smem(int C, int strip, int chunk,
                                         int stages) {
  return 128 + stages * chunk * strip * kLanes + 16 * C + 8 * stages +
         4 * ((C + chunk - 1) / chunk + 1);
}

// A worker as the sum reads it: mask * weight (the robust modes: the
// weight), the scale of the strip's block, the byte offset of its staged
// strip in shared memory, and (robust modes) the mask.
struct alignas(16) Worker {
  float m;
  float scl;
  int off;
  float mk;
};

// A payload byte as its quantized value, exact, without the slow
// integer-to-float conversion: 2^23 + n as a float is exact for n < 2^23,
// so subtracting 2^23 + bias leaves n - bias. int4: a nibble, biased by
// 8; int8: the byte as a signed value (b ^ 0x80 is b + 128 mod 256).
__device__ __forceinline__ float nibble(uint32_t byte, bool high) {
  return __fsub_rn(
      __int_as_float(0x4B000000 | (high ? byte >> 4 : byte & 0xF)),
      8388616.0f);
}
__device__ __forceinline__ float signed_byte(uint32_t byte) {
  return __fsub_rn(__int_as_float(0x4B000000 | (byte ^ 0x80)), 8388736.0f);
}

// packed: a 3D map over (C, prow, 128) int8 / uint8 bytes; scales (C,
// nb); mask, weights (C,); out (rows, 128). A thread takes VEC (1 or 4)
// payload bytes of one packed row; blockDim.x = strip x 128 / VEC.
template <int BITS, int MODE, int VEC>
__global__ void __launch_bounds__(256)
wire_agg_kernel(const __grid_constant__ CUtensorMap map,
                const float* __restrict__ scales,
                const float* __restrict__ mask,
                const float* __restrict__ weights, float* __restrict__ out,
                int C, int prow, int chunk, int stages, float trim_ratio) {
  constexpr bool kLinear = MODE == kMean || MODE == kSum;
  constexpr int kBlockProw = BITS == 4 ? 128 : 256;   // packed rows a block
  constexpr int kPer = kLanes / VEC;                  // threads a packed row
  constexpr int kE = BITS == 4 ? 2 * VEC : VEC;       // outputs a thread
  extern __shared__ uint8_t smem_raw[];
  const int strip = blockDim.x / kPer;
  const int slab = strip * kLanes;                    // a worker's bytes
  const int stage_bytes = chunk * slab;
  const int nchunks = (C + chunk - 1) / chunk;
  uint8_t* stage0 = smem_raw + ((128u - (tma::smem_u32(smem_raw) & 127u)) &
                                127u);
  Worker* wk = reinterpret_cast<Worker*>(stage0 + stages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(wk + C);
  int* beg = reinterpret_cast<int*>(full + stages);   // (nchunks + 1,)

  const int pr0 = blockIdx.x * strip;                 // first packed row
  const int blk = pr0 / kBlockProw;                   // its scale block
  const int nb = prow / kBlockProw;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map)) : "memory");
    for (int s = 0; s < stages; ++s) tma::mbar_init(&full[s], 1);
    tma::mbar_init_fence();
    for (int s = 0; s < stages && s < nchunks; ++s) {
      tma::mbar_expect_tx(&full[s], stage_bytes);
      tma::tma_load_3d(stage0 + s * stage_bytes, &map, &full[s], 0, pr0,
                       s * chunk);
    }
  }
  // while the copy is in flight: every worker's record, all loads at once
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int k = c / chunk;
    Worker w;
    w.scl = scales[static_cast<size_t>(c) * nb + blk];
    w.m = kLinear ? __fmul_rn(mask[c], weights[c]) : weights[c];
    w.mk = kLinear ? 0.0f : mask[c];
    w.off = (k % stages) * stage_bytes + (c - k * chunk) * slab;
    wk[c] = w;
  }
  __syncthreads();
  if (kLinear && threadIdx.x < 32) {
    // warp 0 packs the records of the workers with mask * weight != 0 to
    // the front in worker order, and notes where each chunk's begin
    const int lane = threadIdx.x;
    int n = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      Worker w;
      if (c < C) w = wk[c];
      const bool keep = c < C && w.m != 0.0f;
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      const int pos = n + __popc(kept & ((1u << lane) - 1u));
      __syncwarp();               // every lane has read before any writes
      if (c < C && c % chunk == 0) beg[c / chunk] = pos;
      if (keep) wk[pos] = w;
      n += __popc(kept);
    }
    if (lane == 0) beg[nchunks] = n;
  }
  __syncthreads();

  const int row = threadIdx.x / kPer;                 // within the strip
  const int col = VEC * (threadIdx.x % kPer);         // first lane
  const int off = row * kLanes + col;                 // within a slab
  const int pr = pr0 + row;
  // int8: output row pr; int4: rows lo (low nibbles) and lo + 128
  const size_t lo = BITS == 8 ? static_cast<size_t>(pr)
                              : static_cast<size_t>(blk) * 256 + (pr & 127);
  float res[kE];

  if constexpr (kLinear) {
    // each thread sums mask * weight in worker order itself, beside its
    // outputs: no serial chain before the payload
    float total = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) res[e] = 0.0f;
    for (int k = 0; k < nchunks; ++k) {
      const int s = k % stages;
      tma::mbar_wait(&full[s], (k / stages) & 1);
      const int i1 = beg[k + 1];
#pragma unroll 4
      for (int i = beg[k]; i < i1; ++i) {
        const Worker w = wk[i];
        total = __fadd_rn(total, w.m);
        const uint8_t* p = stage0 + w.off + off;
        const uint32_t word =
            VEC == 4 ? *reinterpret_cast<const uint32_t*>(p) : *p;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const uint32_t byte = (word >> (8 * j)) & 0xFFu;
          if constexpr (BITS == 8) {
            res[j] = __fadd_rn(
                res[j], __fmul_rn(w.m, __fmul_rn(signed_byte(byte), w.scl)));
          } else {
            res[j] = __fadd_rn(
                res[j],
                __fmul_rn(w.m, __fmul_rn(nibble(byte, false), w.scl)));
            res[VEC + j] = __fadd_rn(
                res[VEC + j],
                __fmul_rn(w.m, __fmul_rn(nibble(byte, true), w.scl)));
          }
        }
      }
      if (k + stages < nchunks) {
        __syncthreads();          // every thread has left stage s
        if (threadIdx.x == 0) {
          tma::mbar_expect_tx(&full[s], stage_bytes);
          tma::tma_load_3d(stage0 + s * stage_bytes, &map, &full[s], 0, pr0,
                           (k + stages) * chunk);
        }
      }
    }
    if constexpr (MODE == kMean) {
      const float den = fmaxf(total, 1.0f);
#pragma unroll
      for (int e = 0; e < kE; ++e) res[e] = __fdiv_rn(res[e], den);
    }
  } else {
    tma::mbar_wait(&full[0], 0);                      // one stage: C <= 64
    float total = 0.0f;                               // delivered workers
    for (int c = 0; c < C; ++c) total = __fadd_rn(total, wk[c].mk);
    const int k = static_cast<int>(total);
    for (int e = 0; e < kE; ++e) {
      if (k <= 0) {       // every upload lost: the global model stays w_t
        res[e] = 0.0f;
        continue;
      }
      float v[kMaxRobust];
      for (int c = 0; c < C; ++c) {
        const Worker w = wk[c];
        const uint32_t byte = stage0[w.off + off + e % VEC];
        const float q = BITS == 8 ? signed_byte(byte) : nibble(byte, e >= VEC);
        const float d = __fmul_rn(q, w.scl);
        const float x = w.mk > 0.0f ? __fmul_rn(d, w.m) : INFINITY;
        int j = c;  // insertion sort, ascending
        while (j > 0 && v[j - 1] > x) {
          v[j] = v[j - 1];
          --j;
        }
        v[j] = x;
      }
      const int km1 = k - 1;
      if constexpr (MODE == kMedian) {
        const int a = km1 / 2, b = km1 - a;
        res[e] = __fmul_rn(0.5f, __fadd_rn(v[a], v[b]));
      } else {
        int t = static_cast<int>(__fmul_rn(trim_ratio, static_cast<float>(k)));
        t = min(t, km1 / 2);
        float s = 0.0f;
        for (int c = t; c < k - t; ++c) s = __fadd_rn(s, v[c]);
        res[e] = __fdiv_rn(s, fmaxf(static_cast<float>(k - 2 * t), 1.0f));
      }
    }
  }

  float* o = out + lo * kLanes + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2],
                                                res[3]);
    if constexpr (BITS == 4)
      *reinterpret_cast<float4*>(o + 128 * kLanes) =
          make_float4(res[4], res[5], res[6], res[7]);
  } else {
    o[0] = res[0];
    if constexpr (BITS == 4) o[128 * kLanes] = res[1];
  }
}

// A 3D map over the (C, prow, 128) payload bytes, innermost first: (128,
// prow, C), box (128, strip, chunk), no swizzle; workers past C read as
// zeros. Plain host work, so it may run while a CUDA graph is captured.
int make_map(CUtensorMap* map, const void* packed, int C, int prow, int strip,
             int chunk) {
  const tma::EncodeTiledFn enc = tma::encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kLanes),
                              static_cast<cuuint64_t>(prow),
                              static_cast<cuuint64_t>(C)};
  const cuuint64_t strides[2] = {kLanes,
                                 static_cast<cuuint64_t>(kLanes) * prow};
  const cuuint32_t box[3] = {kLanes, static_cast<cuuint32_t>(strip),
                             static_cast<cuuint32_t>(chunk)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(packed), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

struct Args {
  const CUtensorMap* map;
  const float *sc, *mk, *w;
  float* o;
  int C, prow, strip, chunk, stages, grid, smem;
  float trim;
  cudaStream_t s;
};

// The launch of one instantiation, after its one-time opt-in to the most
// dynamic shared memory (outside any CUDA-graph capture that follows).
template <int BITS, int MODE, int VEC>
int run(const Args& a) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        wire_agg_kernel<BITS, MODE, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  wire_agg_kernel<BITS, MODE, VEC>
      <<<a.grid, a.strip * kLanes / VEC, a.smem, a.s>>>(
          *a.map, a.sc, a.mk, a.w, a.o, a.C, a.prow, a.chunk, a.stages,
          a.trim);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int VEC>
int run_mode(int mode, const Args& a) {
  switch (mode) {
    case kMean:
      return run<BITS, kMean, VEC>(a);
    case kSum:
      return run<BITS, kSum, VEC>(a);
    case kMedian:
      return run<BITS, kMedian, VEC>(a);
    default:
      return run<BITS, kTrimmed, VEC>(a);
  }
}

}  // namespace

// packed (C, prow, 128) int8 (bits 8, prow = rows) or uint8 (bits 4, prow
// = rows / 2), 16-byte aligned; scales (C, rows / 256); mask, weights
// (C,); out (rows, 128) f32. mode: 0 mean, 1 sum, 2 median, 3
// trimmed_mean. The launch plan (strip rows, payload bytes a thread,
// worker chunk, stages, grid, dynamic shared memory) comes from the
// wrapper's `_plan`; one this kernel does not take returns
// cudaErrorInvalidValue. Returns the error of the tensor map or
// of the shared-memory opt-in, else cudaGetLastError() after the launch.
extern "C" int wa_wire_agg(const void* packed, const void* scales,
                           const void* mask, const void* weights, void* out,
                           int C, int rows, int bits, int mode,
                           float trim_ratio, int strip, int vec, int chunk,
                           int stages, int grid, int smem, void* stream) {
  const int prow = bits == 4 ? rows / 2 : rows;
  const bool robust = mode == kMedian || mode == kTrimmed;
  const int nchunks = chunk > 0 ? (C + chunk - 1) / chunk : 0;
  if ((bits != 8 && bits != 4) || mode < kMean || mode > kTrimmed ||
      C < 1 || rows < 256 || rows % 256 != 0 ||
      (strip != 1 && strip != 2 && strip != 4 && strip != 8) ||
      (vec != 1 && vec != 4) || strip * kLanes / vec > 256 ||
      grid != prow / strip || chunk < 1 || chunk > kMaxBox || chunk > C ||
      stages != (nchunks == 1 ? 1 : 2) ||
      smem != plan_smem(C, strip, chunk, stages) || smem > kSmemMax ||
      (robust && (C > kMaxRobust || stages != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int e = make_map(&map, packed, C, prow, strip, chunk);
  if (e != 0) return e;
  const Args a{&map,
               static_cast<const float*>(scales),
               static_cast<const float*>(mask),
               static_cast<const float*>(weights),
               static_cast<float*>(out),
               C, prow, strip, chunk, stages, grid, smem, trim_ratio,
               static_cast<cudaStream_t>(stream)};
  if (bits == 8)
    return vec == 4 ? run_mode<8, 4>(mode, a) : run_mode<8, 1>(mode, a);
  return vec == 4 ? run_mode<4, 4>(mode, a) : run_mode<4, 1>(mode, a);
}
