// Device helpers shared by the tensor-core flash kernels
// (flash_attention.cu, flash_attention_bwd.cu) for Hopper (sm_90a):
// TMA tile loads behind mbarriers, wgmma (bf16 in, f32 accumulate) with
// shared-memory descriptors in the 128-byte swizzle, and the fragment
// arithmetic between one product's accumulator and the next product's
// register A operand. The mbarrier, TMA, bulk-copy and named-barrier
// primitives and the host's cuTensorMapEncodeTiled lookup live in
// tma.cuh (shared with the RG-LRU scan) and are brought into fa_tc
// below under their old names.
//
// Tiles in shared memory. A tile is 64 rows of hd bf16 values, stored as
// hd / 64 boxes of 64 rows x 128 bytes (8 KiB each), each box written by
// one TMA load with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8). Boxes start on 1024-byte boundaries,
// so the swizzle that TMA applies and the one wgmma reads agree. The
// forward's hd-80 build adds a tail box of the last 16 columns, 64 rows
// x 32 bytes (2 KiB) in CU_TENSOR_MAP_SWIZZLE_32B (chunk c of row r at
// c ^ ((r / 4) % 2)), read by wgmma through descriptors of the 32-byte
// layout: one k-slice of Q.K^T, and the n16 part of P.V (`Tile`).
//
// Fragments of a warpgroup's m64nN accumulator (f32, N / 2 registers a
// thread): element i of thread t (warp w = t / 32 in the warpgroup,
// lane l) sits at row 16 w + l / 4 + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). The bf16 A operand of an m64k16
// wgmma from registers has the same layout for its 16 columns, so the
// k-slice kk of an accumulator (its columns 16 kk .. 16 kk + 15) is the
// A fragment of the next product as the pairs of elements 8 kk .. 8 kk
// + 7, packed low element first (`to_frag`). An n64 accumulator followed
// by an n16 one is, element for element, the layout of an n80 one.
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace fa_tc {

using tma::align_1024;
using tma::bulk_load;
using tma::encode_tiled;
using tma::EncodeTiledFn;
using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_init_fence;
using tma::mbar_wait;
using tma::named_sync;
using tma::smem_u32;
using tma::tma_load_4d;

constexpr int kTileRows = 64;                 // rows of a tile, of a box
constexpr int kBoxBytes = kTileRows * 128;    // one 64 x 64 bf16 box
constexpr int kRowBytes = 128;                // one swizzled box row

// -- head dims -----------------------------------------------------------

// Both flash sources are built for head dims 32, 64, 128 and 256, and the
// tensor-core forward also for 80. Any hd with hd % 8 == 0 (16-byte rows
// of bf16, as TMA's strides need) up to 256 runs in the next of them:
// `padded_head_dim` for the backward and the CUDA-core forward,
// `fwd_tc_head_dim` for the tensor-core forward (hd 72 and 80 in the 80
// build). Its columns from hd on read as zeros (the maps' dimension is
// hd, so TMA fills the rest of a box with zeros; the CUDA-core kernels
// skip those loads) and are never stored. A zero column adds exact zeros
// to Q.K^T, dO.V^T and to every output column's sum, so the result is
// the hd-wide one, with the caller's scale 1/sqrt(hd).
__host__ __device__ inline bool head_dim_ok(int hd) {
  return hd > 0 && hd <= 256 && hd % 8 == 0;
}
__host__ __device__ inline int padded_head_dim(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}
__host__ __device__ inline int fwd_tc_head_dim(int hd) {
  return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 128 ? 128 : 256;
}

// A 64-row tile at build head dim HD: HD / 64 boxes of 64 columns in the
// 128-byte swizzle, then (HD = 80) a tail box of 16 columns in the
// 32-byte swizzle. Every tile size is a multiple of 1024 bytes, so
// consecutive tiles keep the boxes' alignment.
template <int HD>
struct Tile {
  static constexpr int kBoxes = HD / 64;
  static constexpr int kTail = HD % 64;                   // 0 or 16 columns
  static constexpr int kTailBytes = kTileRows * kTail * 2;
  static constexpr int kBytes = kBoxes * kTileRows * 128 + kTailBytes;
  static_assert(kTail == 0 || kTail == 16, "a tail box is 16 columns");
  static_assert(kBytes % 1024 == 0, "tiles keep the boxes' alignment");
};

// -- TMA ---------------------------------------------------------------

// the boxes of one 64-row tile: rows `row0` .. `row0` + 63 of head `head`
// in batch `b`; the tail box (HD = 80) from `tail`, a 16-column map
template <int HD>
__device__ __forceinline__ void tma_load_tile(
    uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int head, int row0,
    int b, const CUtensorMap* tail = nullptr) {
#pragma unroll
  for (int c = 0; c < Tile<HD>::kBoxes; ++c)
    tma_load_4d(dst + c * kBoxBytes, map, bar, c * 64, head, row0, b);
  if constexpr (Tile<HD>::kTail > 0)
    tma_load_4d(dst + Tile<HD>::kBoxes * kBoxBytes, tail, bar,
                Tile<HD>::kBoxes * 64, head, row0, b);
}

// -- warpgroup register split --------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor; `layout` is the swizzle (1: 128-byte,
// 3: 32-byte). K-major operand (a tile read as rows x hd): start at the
// k-slice's first chunk, SBO 8 rows (1024 bytes in a 128-byte box, 256
// in a 32-byte tail), LBO unused. MN-major operand (a tile read as its
// rows = the reduction dim): start at the k-slice's first row, SBO the
// next 8 rows, LBO the next atom of columns (64 in a 128-byte box: one
// box further; a tail has one atom of 16).
__device__ __forceinline__ uint64_t desc_sw(const void* p, uint32_t lbo,
                                            uint32_t sbo,
                                            uint64_t layout = 1) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (layout << 62);
}

// k-slice kk (columns 16 kk .. 16 kk + 15) of a tile read K-major
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return desc_sw(tile + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16,
                 8 * kRowBytes);
}

// k-slice kk (rows 16 kk .. 16 kk + 15) of a tile read MN-major
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return desc_sw(tile + kk * 16 * kRowBytes, kBoxBytes, 8 * kRowBytes);
}

// a 16-column tail box (32-byte rows, 32-byte swizzle): its one k-slice
// read K-major, and its rows 16 kk .. 16 kk + 15 read MN-major
__device__ __forceinline__ uint64_t desc_k_tail(const uint8_t* tail) {
  return desc_sw(tail, 16, 8 * 32, 3);
}
__device__ __forceinline__ uint64_t desc_mn_tail(const uint8_t* tail,
                                                 int kk) {
  return desc_sw(tail + kk * 16 * 32, kTileRows * 32, 8 * 32, 3);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// keeps the compiler from moving accumulator registers across a wgmma
// that is still in flight
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x 64) += A(64 x 16) * B(16 x 64): A and B K-major in shared
// memory (descriptors); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16) * B(16 x 64): A from registers (a bf16
// fragment from `to_frag`), B MN-major in shared memory (descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D(64 x 128) += A(64 x 16) * B(16 x 128): A from registers (a bf16
// fragment from `to_frag`), B MN-major in shared memory (descriptor).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D(64 x 256) += A(64 x 16) * B(16 x 256): A from registers (a bf16
// fragment from `to_frag`), B MN-major in shared memory (descriptor).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D(64 x 80) += A(64 x 16) * B(16 x 80): A from registers, B MN-major in
// shared memory, its columns 0-63 from a 128-byte box (descriptor db, an
// n64 wgmma into d[0..31]) and 64-79 from a tail box (dt, an n16 wgmma
// into d[32..39]); the two accumulators make the n80 layout.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db, uint64_t dt,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(dt),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, scale_d);
  else wgmma_rs_n256(d, a, db, scale_d);
}

// D(64 x N) (+)= A(64 x 16) * rows 16 kk .. 16 kk + 15 of a tile read
// MN-major from column block `b` on: N columns of its 128-byte boxes, or
// at N = 80 the first box's 64 and the tail box's 16. scale_d 0
// overwrites D (a fresh accumulator needs no zeros).
template <int N>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              const uint8_t* b, int kk,
                                              int scale_d) {
  if constexpr (N == 80)
    wgmma_rs_n80(d, a, desc_mn(b, kk), desc_mn_tail(b + kBoxBytes, kk),
                 scale_d);
  else
    wgmma_rs<N>(d, a, desc_mn(b, kk), scale_d);
}

// S(64 x 64) = A(64 x HD) * B(64 x HD)^T, both tiles K-major in shared
// memory (HD / 16 wgmmas, the tail's among them; not committed)
template <int HD>
__device__ __forceinline__ void gemm_ss(float (&d)[32], const uint8_t* a,
                                        const uint8_t* b) {
  constexpr int kMain = Tile<HD>::kBoxes * 4;
#pragma unroll
  for (int kk = 0; kk < kMain; ++kk)
    wgmma_ss_n64(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
  if constexpr (Tile<HD>::kTail > 0)
    wgmma_ss_n64(d, desc_k_tail(a + Tile<HD>::kBoxes * kBoxBytes),
                 desc_k_tail(b + Tile<HD>::kBoxes * kBoxBytes), 1);
}

// -- masks ---------------------------------------------------------------

// The kv tiles of 64 keys [*t_begin, *t_end) that hold a valid key for
// some query row q_first .. q_first + rows - 1 (rows past Sq excluded).
__device__ __forceinline__ void kv_tiles(int q_first, int rows, int Sq,
                                         int q_offset, int kv_end, int causal,
                                         int window, int* t_begin,
                                         int* t_end) {
  const int pos_lo = q_offset + q_first;
  const int pos_hi = q_offset + min(q_first + rows, Sq) - 1;
  int k_begin = 0, k_end = kv_end;
  if (causal) k_end = min(k_end, pos_hi + 1);
  if (window > 0) k_begin = max(k_begin, pos_lo - window + 1);
  *t_begin = k_begin / kTileRows;
  *t_end = k_end > k_begin ? (k_end + kTileRows - 1) / kTileRows : 0;
}

// every (query, key) pair of a 64 x 64 tile valid: queries q0 .. q0 + 63
// (all below Sq), keys k0 .. k0 + 63 (all below kv_end = min(kv_len, Sk))
__device__ __forceinline__ bool tile_all_valid(int q0, int k0, int Sq,
                                               int kv_end, int causal,
                                               int window, int q_offset) {
  return k0 + 64 <= kv_end && q0 + 64 <= Sq &&
         (!causal || k0 + 63 <= q_offset + q0) &&
         (window <= 0 || k0 > q_offset + q0 + 63 - window);
}

// -- fragments -----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// row (0 .. 63) and column of accumulator element i of this thread
__device__ __forceinline__ int frag_row(int i, int tid) {
  return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i, int tid) {
  return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1);
}

// The A fragment of k-slice kk of x, split into T bf16 terms: term 0 is
// x rounded to bf16, each later term the rounded remainder of what the
// terms before it left. The remainders are exact (__fsub_rn: no FMA
// contraction), so the terms sum to x within 2^-8T relative. Each pair
// is rounded by one packed conversion (cvt.rn.bf16x2.f32), not two.
template <int T>
__device__ __forceinline__ void to_frag(const float (&x)[32], int kk,
                                        uint32_t (&f)[T][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = x[8 * kk + 2 * j], b = x[8 * kk + 2 * j + 1];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // .x = a
      f[t][j] = *reinterpret_cast<const uint32_t*>(&v);
      if (t + 1 < T) {
        a = __fsub_rn(a, __low2float(v));
        b = __fsub_rn(b, __high2float(v));
      }
    }
  }
}

// 2^x by the SFU (ex2.approx.ftz: relative error ~2^-22, 2^-inf = 0).
// The kernels compute exp(s * scale - m) as 2^(s * scale log2(e) - m
// log2(e)), one fma and one ex2 an element, in place of expf's range
// reduction; the error stays ~1e-6 relative, far inside the bf16 rules.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the four lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- host: tensor maps ----------------------------------------------------

// A 4D map over a contiguous bf16 (B, S, heads, hd) tensor, innermost
// first: (hd, heads, S, B), box (64, 1, 64, 1) in the 128-byte swizzle,
// or (tail) box (16, 1, 64, 1) in the 32-byte swizzle for a tail box;
// reads past S in a batch, or past hd, give zeros. Plain host work (no
// device call), so it may run while a CUDA graph is captured. Returns 0
// or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, int hd, int heads,
                    int S, int B, bool tail = false) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // an empty S (no key to load: the kernel visits no tile) still needs
  // a dimension of at least 1
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S > 0 ? S : 1),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;   // bytes
  const cuuint64_t strides[3] = {row, row * heads,
                                 row * heads * dims[2]};
  const cuuint32_t box[4] = {tail ? 16u : 64u, 1, kTileRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      tail ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fa_tc
