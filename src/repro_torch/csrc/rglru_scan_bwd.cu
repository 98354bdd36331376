// Backward of the linear-recurrence scan for Hopper (sm_90a): the
// gradient of h_t = a_t * h_{t-1} + b_t (csrc/rglru_scan.cu) for the
// upstream gradient g of the states, for every (batch, channel) lane:
//
//   dh_{S-1} = g_{S-1};  dh_t = g_t + a_{t+1} * dh_{t+1}
//   db_t = dh_t;  da_t = dh_t * h_{t-1} (h_{-1} = h0);  dh0 = a_0 * dh_0
//
// Replaces no TPU kernel: the JAX package gets this gradient from XLA's
// autodiff of its associative scan (repro/models/recurrent.py:112-119,
// `jax.lax.associative_scan` in rglru_apply).
//
// What bounds it here: device-memory bytes. Each step reads g_t, a_t and
// h_{t-1} and writes da_t and db_t (20 bytes per element, 3 float
// operations), far below the card's balance point; the least time is
// 20*B*S*D / 3.35 TB/s (100.2 us at RecurrentGemma-9B's training shape
// (2, 2048, 4096)). As in the forward, the result is held bitwise to the
// plain reverse loop, so parallelism comes from the lanes only and the
// design is the memory pipeline.
//
// The design: the forward's TMA-fed staged scan, walking time in reverse.
//  * Grid: one CTA per (channel tile, batch), kTile = 128 channels, as
//    the forward (the wrapper's `_bwd_plan` passes the grid and the
//    constants below, which the entry point checks). At the training
//    shape that is 32 x 2 = 64 CTAs on 132 SMs: too few to fill the card,
//    left for a later change (a simple kernel that is right first).
//  * Loads: one producer thread keeps kStages = 3 stages in flight, from
//    the last stage to the first. A stage holds kStageRows = 32 time rows
//    of g, of a and of the states, each one TMA box (128, 32, 1) from a
//    3D map over (D, S, B). The states' box starts one row earlier (row
//    k*32 - 1), so that its row r is h_{t-1} for t = k*32 + r; at k = 0
//    that row is -1, which TMA fills with zeros (the consumer takes h0
//    there). A stage is 48 KiB: three in flight (144 KiB) and two output
//    stages of da and db (64 KiB) fit the 227 KiB a block may use.
//  * Compute: one consumer thread per channel carries dh and a_{t+1} in
//    registers across rows and stages (a_{t+1} is the row the reverse
//    walk has just left), reads its column of each box from shared
//    memory (consecutive threads on consecutive words: no bank
//    conflict), and writes da_t and db_t into an output stage; the stage
//    goes out by two TMA stores, as the forward's (fence, named barrier,
//    one thread releases the input stage and stores; two output stages
//    alternate). dh0 is written from registers at the end.
//  * Ragged edges: the last stage's rows past S come first and hold
//    zeros (g = 0, a = 0), so dh stays exactly 0 through them and
//    a_{t+1} is 0 at t = S - 1, as the plain version's start (dh = 0,
//    a_S = 0). Loads past D are zeros; stores past S and D are clipped.
//    The maps' strides must be multiples of 16 bytes: D % 4 == 0 (the
//    wrapper checks it).
//  * CUDA graphs: tensor maps are encoded on the host each call, and
//    shared memory is opted in at the first launch, before any capture.
//
// Each step is dh = __fadd_rn(g, __fmul_rn(a_next, dh)) and da =
// __fmul_rn(dh, h_prev): no FMA contraction, so the result is bitwise
// equal to the plain version's `dh = g[:, t] + a_next * dh` and `dh *
// h_prev` (each product and sum rounded). Build without --use_fast_math.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kTile = 128;        // channels a CTA walks
constexpr int kStageRows = 32;    // time rows a stage holds
constexpr int kStages = 3;        // input stages in flight
constexpr int kOutStages = 2;     // output buffers (da and db each)
constexpr int kStage = kStageRows * kTile;      // floats in one buffer
// dynamic shared memory: the input ring (g, a, states per stage), the
// output stages (da, db per stage) and 1024 bytes to align the base
constexpr int kSmem = (3 * kStages + 2 * kOutStages) * kStage * 4 + 1024;
static_assert(kSmem + 2 * kStages * 8 <= 232448,
              "over the shared memory a block may use");

// grid = (ceil(D / kTile), B); kTile consumer threads + one producer warp
__global__ void __launch_bounds__(kTile + 32)
rglru_scan_bwd_kernel(const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap th,
                      const __grid_constant__ CUtensorMap tda,
                      const __grid_constant__ CUtensorMap tdb,
                      const float* __restrict__ h0,
                      float* __restrict__ dh0, int S, int D) {
  using namespace tma;
  extern __shared__ uint8_t smem_raw[];
  float* sg = reinterpret_cast<float*>(align_1024(smem_raw));
  float* sa = sg + kStages * kStage;
  float* sh = sa + kStages * kStage;
  float* oa = sh + kStages * kStage;            // da output stages
  float* ob = oa + kOutStages * kStage;         // db output stages
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
      for (int i = 0; i < nk; ++i) {            // stage k = nk - 1 - i
        const int s = i % kStages, row = (nk - 1 - i) * kStageRows;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 3 * kStage * 4);
        tma_load_3d(sg + s * kStage, &tg, &full[s], d0, row, bi);
        tma_load_3d(sa + s * kStage, &ta, &full[s], d0, row, bi);
        // h_{t-1}: one row earlier (row -1 reads as zeros)
        tma_load_3d(sh + s * kStage, &th, &full[s], d0, row - 1, bi);
      }
    }
    return;
  }

  const int d = d0 + tid;
  const float hinit = d < D ? h0[static_cast<size_t>(bi) * D + d] : 0.0f;
  float dh = 0.0f, a_next = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages, k = nk - 1 - i;
    float* pa = oa + (i % kOutStages) * kStage;
    float* pb = ob + (i % kOutStages) * kStage;
    mbar_wait(&full[s], (i / kStages) & 1);
    const float* g = sg + s * kStage + tid;
    const float* a = sa + s * kStage + tid;
    const float* h = sh + s * kStage + tid;
#pragma unroll
    for (int r = kStageRows - 1; r >= 0; --r) {
      dh = __fadd_rn(g[r * kTile], __fmul_rn(a_next, dh));
      const float hp = (k == 0 && r == 0) ? hinit : h[r * kTile];
      pb[r * kTile + tid] = dh;
      pa[r * kTile + tid] = __fmul_rn(dh, hp);
      a_next = a[r * kTile];
    }
    fence_proxy_async();
    // the stores of stage i - 1 have read their buffers, which stage
    // i + 1 writes after the barrier
    if (tid == 0) bulk_wait_read<kOutStages - 2>();
    named_sync(1, kTile);
    if (tid == 0) {
      mbar_arrive(&empty[s]);
      tma_store_3d(&tda, pa, d0, k * kStageRows, bi);
      tma_store_3d(&tdb, pb, d0, k * kStageRows, bi);
      bulk_commit();
    }
  }
  if (d < D) dh0[static_cast<size_t>(bi) * D + d] = __fmul_rn(a_next, dh);
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

// h0, dh0 (B, D); a, states, g, da, db (B, S, D): f32, contiguous, the
// (B, S, D) ones 16-byte aligned. The launch plan (tile, stage rows,
// stage count, grid, dynamic shared memory) comes from the wrapper's
// `_bwd_plan`; one that is not this kernel's returns
// cudaErrorInvalidValue. Returns cudaGetLastError() after the launch.
extern "C" int rs_rglru_scan_bwd(const void* h0, const void* a,
                                 const void* states, const void* g,
                                 void* dh0, void* da, void* db, int B, int S,
                                 int D, int tile, int stage_rows, int stages,
                                 int grid_x, int grid_y, int smem,
                                 void* stream) {
  if (S < 1 || D < 1 || D % 4 != 0 || tile != kTile ||
      stage_rows != kStageRows || stages != kStages || smem != kSmem ||
      grid_y != B || grid_x != (D + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tg, ta, th, tda, tdb;
  int e = make_map(&tg, g, D, S, B);
  if (e == 0) e = make_map(&ta, a, D, S, B);
  if (e == 0) e = make_map(&th, states, D, S, B);
  if (e == 0) e = make_map(&tda, da, D, S, B);
  if (e == 0) e = make_map(&tdb, db, D, S, B);
  if (e != 0) return e;
  // opt in to the dynamic shared memory at the first launch (which runs
  // outside any CUDA-graph capture that follows it)
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  rglru_scan_bwd_kernel<<<dim3(grid_x, grid_y), kTile + 32, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      tg, ta, th, tda, tdb, static_cast<const float*>(h0),
      static_cast<float*>(dh0), S, D);
  return static_cast<int>(cudaGetLastError());
}
