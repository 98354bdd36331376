// Fused dequant + masked aggregate for Hopper (sm_90a): the parameter
// server's Eq.-7 decode of C packed uplink payloads of one leaf.
//
// Replaces the Pallas TPU kernel repro/kernels/wire_agg/wire_agg.py:
//   wire_agg_kernel<BITS, MODE>  <- wire_agg_2d (_make_agg_kernel /
//                                   _aggregate_block)
//
// What bounds it here: device-memory bytes. Per output element it reads
// C payload bytes (int8) or C/2 (int4) and writes 4 B, with ~3C float
// operations for the mean — below the card's balance point. At the
// M-DSL paper shapes (C = 50, one (256, 128) block per leaf) a launch
// moves well under 1 MB, so the launch overhead dominates.
//
// What the design does about it: one thread per output element, all C
// workers in one pass. The block's C scales (all 256 threads of a block
// share one 256x128 scale block), the delivery mask and the weights sit
// in shared memory; each thread loops c = 0..C-1 in order, so
// neighbouring threads read neighbouring payload bytes of the same
// worker. The TPU kernel's VMEM-bound chunking of the mean over groups
// of 64 workers is not needed: the loop carries one running sum.
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 256;
constexpr int kLanes = 128;
constexpr int kTile = kBlockRows * kLanes;
constexpr int kThreads = 256;
constexpr int kMaxRobust = 64;

enum Mode { kMean = 0, kSum = 1, kMedian = 2, kTrimmed = 3 };

template <int BITS>
__device__ __forceinline__ float load_q(const void* __restrict__ packed,
                                        size_t worker_stride, int c, int blk,
                                        int within) {
  if (BITS == 8) {
    return static_cast<float>(static_cast<const int8_t*>(
        packed)[c * worker_stride + static_cast<size_t>(blk) * kTile + within]);
  }
  const int row = within >> 7, col = within & 127;
  const int byte = static_cast<const uint8_t*>(
      packed)[c * worker_stride + static_cast<size_t>(blk) * (kTile / 2) +
              (row & 127) * kLanes + col];
  return static_cast<float>(row < 128 ? (byte & 0xF) - 8 : (byte >> 4) - 8);
}

// packed: (C, rows, 128) int8 or (C, rows/2, 128) uint8; scales (C, nb);
// mask, weights (C,); out (rows, 128). One thread per output element.
template <int BITS, int MODE>
__global__ void __launch_bounds__(kThreads)
wire_agg_kernel(const void* __restrict__ packed,
                const float* __restrict__ scales,
                const float* __restrict__ mask,
                const float* __restrict__ weights, float* __restrict__ out,
                int C, int rows, float trim_ratio) {
  extern __shared__ float sh[];
  float* sc = sh;          // (C,) this block's scale per worker
  float* mw = sh + C;      // (C,) mask * weight (mean/sum) or weight
  float* mk = sh + 2 * C;  // (C,) mask (robust modes)
  __shared__ float s_total;
  __shared__ int s_k;

  const int nb = rows / kBlockRows;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int blk = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * kThreads) / kTile);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    sc[c] = scales[static_cast<size_t>(c) * nb + blk];
    if (MODE == kMean || MODE == kSum) {
      mw[c] = __fmul_rn(mask[c], weights[c]);
    } else {
      mw[c] = weights[c];
      mk[c] = mask[c];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int c = 0; c < C; ++c)
      total = __fadd_rn(total, (MODE == kMean || MODE == kSum) ? mw[c] : mk[c]);
    s_total = total;
    s_k = static_cast<int>(total);
  }
  __syncthreads();
  if (idx >= static_cast<long long>(rows) * kLanes) return;

  const int within = static_cast<int>(idx - static_cast<long long>(blk) * kTile);
  const size_t worker_stride =
      static_cast<size_t>(rows) * kLanes / (BITS == 4 ? 2 : 1);

  if (MODE == kMean || MODE == kSum) {
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float d =
          __fmul_rn(load_q<BITS>(packed, worker_stride, c, blk, within), sc[c]);
      s = __fadd_rn(s, __fmul_rn(mw[c], d));
    }
    out[idx] = MODE == kSum ? s : __fdiv_rn(s, fmaxf(s_total, 1.0f));
    return;
  }

  const int k = s_k;
  if (k <= 0) {  // every upload lost: the global model stays w_t
    out[idx] = 0.0f;
    return;
  }
  float v[kMaxRobust];
  for (int c = 0; c < C; ++c) {
    const float d =
        __fmul_rn(load_q<BITS>(packed, worker_stride, c, blk, within), sc[c]);
    float x = mk[c] > 0.0f ? __fmul_rn(d, mw[c]) : INFINITY;
    int j = c;  // insertion sort, ascending
    while (j > 0 && v[j - 1] > x) {
      v[j] = v[j - 1];
      --j;
    }
    v[j] = x;
  }
  const int km1 = k - 1;
  if (MODE == kMedian) {
    const int lo = km1 / 2, hi = km1 - lo;
    out[idx] = __fmul_rn(0.5f, __fadd_rn(v[lo], v[hi]));
    return;
  }
  int t = static_cast<int>(__fmul_rn(trim_ratio, static_cast<float>(k)));
  t = min(t, km1 / 2);
  float s = 0.0f;
  for (int c = t; c < k - t; ++c) s = __fadd_rn(s, v[c]);
  out[idx] = __fdiv_rn(s, fmaxf(static_cast<float>(k - 2 * t), 1.0f));
}

template <int BITS>
void launch(const void* packed, const float* scales, const float* mask,
            const float* weights, float* out, int C, int rows, int mode,
            float trim_ratio, cudaStream_t s) {
  const long long n = static_cast<long long>(rows) * kLanes;
  const int grid = static_cast<int>((n + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(3 * C) * sizeof(float);
  switch (mode) {
    case kMean:
      wire_agg_kernel<BITS, kMean><<<grid, kThreads, smem, s>>>(
          packed, scales, mask, weights, out, C, rows, trim_ratio);
      break;
    case kSum:
      wire_agg_kernel<BITS, kSum><<<grid, kThreads, smem, s>>>(
          packed, scales, mask, weights, out, C, rows, trim_ratio);
      break;
    case kMedian:
      wire_agg_kernel<BITS, kMedian><<<grid, kThreads, smem, s>>>(
          packed, scales, mask, weights, out, C, rows, trim_ratio);
      break;
    default:
      wire_agg_kernel<BITS, kTrimmed><<<grid, kThreads, smem, s>>>(
          packed, scales, mask, weights, out, C, rows, trim_ratio);
  }
}

}  // namespace

extern "C" int wa_max_robust_workers() { return kMaxRobust; }

// mode: 0 mean, 1 sum, 2 median, 3 trimmed_mean; returns cudaGetLastError().
extern "C" int wa_wire_agg(const void* packed, const void* scales,
                           const void* mask, const void* weights, void* out,
                           int C, int rows, int bits, int mode,
                           float trim_ratio, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scales);
  const auto* mk = static_cast<const float*>(mask);
  const auto* w = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  if (bits == 8)
    launch<8>(packed, sc, mk, w, o, C, rows, mode, trim_ratio, s);
  else
    launch<4>(packed, sc, mk, w, o, C, rows, mode, trim_ratio, s);
  return static_cast<int>(cudaGetLastError());
}
