// Linear-recurrence scan for Hopper (sm_90a): the RG-LRU core
// h_t = a_t * h_{t-1} + b_t over the sequence, for every (batch, channel)
// lane, starting from h0.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/rglru_scan.py:
//   rglru_scan_kernel  <- rglru_scan_raw (_kernel)
//
// What bounds it here: device-memory bytes. Each step reads a_t and b_t
// and writes h_t (12 bytes per element, 2 float operations), far below
// the card's balance point; the least time is 12*B*S*D / 3.35 TB/s.
//
// What the design does about it: one thread per (batch, channel) lane
// loops over time, so neighbouring threads read and write neighbouring
// channels (coalesced) and the carried state never leaves a register.
// The TPU kernel's sequence blocks and VMEM carry are not needed: the
// loop carries h across the whole sequence. Parallelism is only B*D
// lanes (16,384 at RecurrentGemma-9B's prefill), so each thread issues
// the loads of kUnroll steps before it consumes them, keeping enough
// bytes in flight to approach the memory rate with one or two blocks
// per SM.
//
// The step is __fadd_rn(__fmul_rn(a, h), b): no FMA contraction, so the
// result is bitwise equal to the plain version's `h = a[:, t] * h +
// b[:, t]` (a multiply then an add, each rounded). Build without
// --use_fast_math.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 32;

// h0 (B, D); a, b, out (B, S, D); all f32, contiguous.
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ h0, const float* __restrict__ a,
                  const float* __restrict__ b, float* __restrict__ out, int S,
                  int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t lane = static_cast<size_t>(blockIdx.y) * S * D + d;
  const size_t step = static_cast<size_t>(D);
  float h = h0[static_cast<size_t>(blockIdx.y) * D + d];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
    const size_t off = lane + static_cast<size_t>(t) * step;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(a + off + u * step);
      bv[u] = __ldg(b + off + u * step);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      out[off + u * step] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t off = lane + static_cast<size_t>(t) * step;
    h = __fadd_rn(__fmul_rn(__ldg(a + off), h), __ldg(b + off));
    out[off] = h;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int rs_rglru_scan(const void* h0, const void* a, const void* b,
                             void* out, int B, int S, int D, void* stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(out), S, D);
  return static_cast<int>(cudaGetLastError());
}
