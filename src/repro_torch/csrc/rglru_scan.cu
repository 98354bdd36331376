// Linear-recurrence scan for Hopper (sm_90a): the RG-LRU core
// h_t = a_t * h_{t-1} + b_t over the sequence, for every (batch, channel)
// lane, starting from h0.
//
// Its backward is csrc/rglru_scan_bwd.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/rglru_scan.py:
//   rglru_scan_kernel  <- rglru_scan_raw (_kernel)
//
// What bounds it here: device-memory bytes. Each step reads a_t and b_t
// and writes h_t (12 bytes per element, 2 float operations), far below
// the card's balance point; the least time is 12*B*S*D / 3.35 TB/s.
// Parallelism cannot come from the sequence: the result is held bitwise
// to the plain loop, which runs the steps in time order. So only the
// memory pipeline is designed; the arithmetic is one lane per thread.
//
// The design: a TMA-fed, staged scan.
//  * Grid: one CTA per (channel tile, batch). A tile of kTile = 128
//    channels (512 B of a row) gives 4 x 32 = 128 CTAs at
//    RecurrentGemma-9B's prefill (B 4, D 4096), one per SM. The wrapper's
//    launch plan (kernels/rglru_scan/ops.py `_plan`) passes the grid and
//    the constants below, which the entry point checks.
//  * Loads: one producer thread keeps a ring of kStages = 4 stages in
//    flight. A stage holds kStageRows = 32 time rows of a and of b, each
//    loaded by one TMA box (128, 32, 1) from a 3D tensor map over (D, S,
//    B), completing on the stage's mbarrier. A stage is 32 KiB, so the
//    ring keeps up to 128 KiB of reads in flight on each SM, where the
//    old one-thread-per-lane kernel issued ~32 KiB and then let the
//    memory idle while it computed and stored each chunk.
//  * Why these constants: a sweep over tiles of 64 and 128 channels, 16
//    and 32 rows a stage and 3 to 6 stages found no plan clearly faster
//    at the prefill's shape (a 64-channel tile at 32 rows and 6 stages,
//    two 116 KiB CTAs an SM, was slower), so one plan is built.
//  * Compute: one consumer thread per channel (a warpgroup)
//    reads a[t][c], b[t][c] from shared memory (consecutive threads on
//    consecutive words: no bank conflict, no swizzle), carries h in a
//    register over the whole sequence, and writes h_t into an output
//    stage. At the end of a stage the consumers fence their writes to
//    the async proxy and meet at a named barrier; one thread releases
//    the input stage to the producer and sends the output stage to
//    `out` with one TMA store. Two output stages alternate; before the
//    barrier that lets the next stage's writes begin, that thread waits
//    (wait_group.read) until the previous store has read its buffer.
//  * Ragged edges: TMA fills loads past S and D with zeros and clips the
//    stores, so there is no masking. Past S the zero-filled steps drive h
//    to 0; the kernel writes no final state (the wrapper takes the
//    states' row S - 1). The maps' strides must be multiples of 16
//    bytes: D % 4 == 0 (the wrapper checks it).
//  * CUDA graphs: the tensor maps are encoded on the host each call (no
//    device call) and shared memory is opted in at a plan's first
//    launch, before any capture, so later launches can be captured.
//
// The step is __fadd_rn(__fmul_rn(a, h), b): no FMA contraction, so the
// result is bitwise equal to the plain version's `h = a[:, t] * h +
// b[:, t]` (a multiply then an add, each rounded). Build without
// --use_fast_math.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kTile = 128;        // channels a CTA scans
constexpr int kStageRows = 32;    // time rows a stage holds
constexpr int kStages = 4;        // input stages in flight
constexpr int kOutStages = 2;     // output buffers (the store of one
                                  // overlaps the next stage's compute)
constexpr int kStage = kStageRows * kTile;      // floats in one buffer
// dynamic shared memory: the input ring (a and b per stage), the output
// stages and 1024 bytes to align the base
constexpr int kSmem = (2 * kStages + kOutStages) * kStage * 4 + 1024;
static_assert(kSmem + 2 * kStages * 8 <= 232448,
              "over the shared memory a block may use");

// grid = (ceil(D / kTile), B); kTile consumer threads + one producer warp
__global__ void __launch_bounds__(kTile + 32)
rglru_scan_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tout,
                  const float* __restrict__ h0, int S, int D) {
  using namespace tma;
  extern __shared__ uint8_t smem_raw[];
  float* sa = reinterpret_cast<float*>(align_1024(smem_raw));
  float* sb = sa + kStages * kStage;
  float* so = sb + kStages * kStage;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kTile, bi = blockIdx.y;
  const int nk = (S + kStageRows - 1) / kStageRows;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTile) {                           // the producer warp
    if (tid == kTile) {
      for (int k = 0; k < nk; ++k) {
        const int s = k % kStages;
        mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kStage * 4);
        tma_load_3d(sa + s * kStage, &ta, &full[s], d0, k * kStageRows, bi);
        tma_load_3d(sb + s * kStage, &tb, &full[s], d0, k * kStageRows, bi);
      }
    }
    return;
  }

  const int d = d0 + tid;
  float h = d < D ? h0[static_cast<size_t>(bi) * D + d] : 0.0f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % kStages;
    float* o = so + (k % kOutStages) * kStage;
    mbar_wait(&full[s], (k / kStages) & 1);
    const float* a = sa + s * kStage + tid;
    const float* b = sb + s * kStage + tid;
#pragma unroll
    for (int t = 0; t < kStageRows; ++t) {
      h = __fadd_rn(__fmul_rn(a[t * kTile], h), b[t * kTile]);
      o[t * kTile + tid] = h;
    }
    fence_proxy_async();
    // the store of stage k - 1 has read its buffer, which stage k + 1
    // writes after the barrier
    if (tid == 0) bulk_wait_read<kOutStages - 2>();
    named_sync(1, kTile);
    if (tid == 0) {
      mbar_arrive(&empty[s]);
      tma_store_3d(&tout, o, d0, k * kStageRows, bi);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// A 3D map over a contiguous f32 (B, S, D) tensor, innermost first: (D,
// S, B), box (kTile, kStageRows, 1), no swizzle; loads outside it give
// zeros and stores there are dropped. Plain host work (no device call).
int make_map(CUtensorMap* map, const void* base, int D, int S, int B) {
  const tma::EncodeTiledFn enc = tma::encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 4;      // bytes
  const cuuint64_t strides[2] = {row, row * dims[1]};
  const cuuint32_t box[3] = {kTile, kStageRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// h0 (B, D), a, b, out (B, S, D): f32, contiguous, 16-byte aligned. The
// launch plan (tile, stage rows, stage count, grid, dynamic shared
// memory) comes from the wrapper's `_plan`; one that is not this
// kernel's returns cudaErrorInvalidValue. Returns cudaGetLastError()
// after the launch.
extern "C" int rs_rglru_scan(const void* h0, const void* a, const void* b,
                             void* out, int B, int S, int D, int tile,
                             int stage_rows, int stages, int grid_x,
                             int grid_y, int smem, void* stream) {
  if (S < 1 || D < 1 || D % 4 != 0 || tile != kTile ||
      stage_rows != kStageRows || stages != kStages || smem != kSmem ||
      grid_y != B || grid_x != (D + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb, tout;
  int e = make_map(&ta, a, D, S, B);
  if (e == 0) e = make_map(&tb, b, D, S, B);
  if (e == 0) e = make_map(&tout, out, D, S, B);
  if (e != 0) return e;
  // opt in to the dynamic shared memory at the first launch (which runs
  // outside any CUDA-graph capture that follows it)
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  rglru_scan_kernel<<<dim3(grid_x, grid_y), kTile + 32, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tout, static_cast<const float*>(h0), S, D);
  return static_cast<int>(cudaGetLastError());
}
