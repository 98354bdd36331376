// Worker-batched 3x3 stride-1 "SAME" convolution for Hopper (sm_90a):
// C workers' f32 weights over their own images (or over one set of
// images every worker reads, through a worker stride of 0), one launch
// for all C workers, in three device functions:
//
//   worker_conv_fwd    y[c] = conv(x[c], w[c]) + b[c]      (bias in the
//                      epilogue)
//   worker_conv_dgrad  dx[c] = conv(gy[c], flip(w[c])^T)   (the same
//                      loop on the flipped, transposed weights)
//   worker_conv_wgrad  dw[c] = sum over pixels of x[c] (x) gy[c],
//                      db[c] = sum of gy[c]
//
// Layouts: x (C, N, K, H, W), w (C, 3, 3, Cin, Cout) (the models' HWIO
// leaf with a worker dimension in front), b (C, Cout), y and gy (C, N,
// Cout, H, W), all contiguous f32.
//
// Replaces no TPU kernel: the JAX package vmaps `lax.conv` and leaves
// the batched convolution to XLA. In the port `torch.func.vmap` made
// of each convolution a grouped one that cuDNN runs one worker at a
// time: at C 200, some 100,000 launches a round, each over one
// worker's 64 images, leaving most of the 132 SMs empty, and issued one
// by one by the host.
//
// What bounds it here: f32 operations on the CUDA cores. CNN5 (8, 16,
// 16 channels at 28, 14 and 7 pixels) does 2 x 9 x Cin operations per
// output value and moves each activation once: about 1.6 TFLOP and
// 95 GB a round at C 200, 24 ms of operations against 28 ms of bytes
// at the card's peaks, with little reuse outside a block. No TF32: the
// configuration states f32, so every product is an FMA in f32.
//
// What the design does about it: a block takes one worker (blockIdx.y)
// and a tile of its images; that worker's weights (at most a few KiB),
// its bias and the images with a one-pixel zero halo are staged in
// shared memory once, so each thread's inner loop is shared-memory
// loads and FMAs: kPix output pixels times 8 or 16 output channels in
// registers, one weight row per (input channel, tap) read as float4
// broadcasts. The image tile is sized so that a block has up to 256
// threads and several blocks share an SM: at C 200 the forward and
// input-gradient grids hold 1,400-12,800 blocks in training and
// 41,000-409,600 in scoring. The staging is cp.async, so a block's
// copies are all in flight at once. The weight gradient gives each
// block one worker and 8 output channels over all of that worker's
// images, staged a chunk at a time in two buffers (the next chunk's
// copies in flight while the current one is summed): each thread holds
// the 9 taps x 8 sums of one input channel (and of the bias) over one
// group of pixels, and the groups' partial sums are then added in a
// fixed order in shared memory. No float atomics, so two calls give the
// same bits. Measured at C 200 (chip_smoke.py phase 42) the kernels run
// at an eighth to a half of their bound.
//
// The plans below size every launch from the shapes alone, and refuse
// what a block cannot stage: images over 1,024 pixels, a worker's
// weights with one image over the shared memory, a weight-gradient
// image with its halo over it (at 32 x 32, more than 18 input
// channels). The wrapper asks them (wc_plan) and routes only what they
// take, so wider layers stay the library's convolution.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 4;            // output pixels a thread (fwd, dgrad)
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;
constexpr int kWgradCt = 8;        // output channels a weight-grad block

// a 4-byte copy from device memory to shared memory that does not stall
// the thread (cp.async): a block issues all of its staging copies, then
// waits once
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage nk planes of H x W floats (x, contiguous) into shared memory with
// a one-pixel zero halo: s[ik * pstride + hp * (W + 2) + wp], pstride >=
// (H + 2) (W + 2). Each warp takes whole rows, its lanes the columns
// (several short rows a warp), and walks its rows by a fixed stride, so
// that no element needs a division.
__device__ __forceinline__ void stage_planes(float* s, const float* x, int nk,
                                             int H, int W, int pstride) {
  const int HP = H + 2, WP = W + 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = WP < 32 ? WP : 32, rpw = 32 / cols;
  const int sub = lane / cols, col0 = lane % cols;
  if (sub >= rpw) return;
  const int stride = (blockDim.x >> 5) * rpw;
  const int dk = stride / HP, dh = stride % HP;
  const int r0 = warp * rpw + sub;
  int ik = r0 / HP, hp = r0 % HP;
  while (ik < nk) {
    const bool inside = hp >= 1 && hp <= H;
    const float* src = x + (static_cast<int64_t>(ik) * H + hp - 1) * W - 1;
    float* dst = s + ik * pstride + hp * WP;
    for (int col = col0; col < WP; col += cols) {
      if (inside && col >= 1 && col <= W)
        cp_async4(dst + col, src + col);
      else
        dst[col] = 0.f;
    }
    hp += dh;
    ik += dk;
    if (hp >= HP) {
      hp -= HP;
      ++ik;
    }
  }
}

// the forward and the input gradient: K input channels into M output
// channels (Mp of them padded to 8), CT at a time. DGRAD reads w (3, 3,
// M, K) flipped and transposed; the forward reads w (3, 3, K, M).
template <int CT, bool DGRAD>
__device__ __forceinline__ void conv_body(
    const float* __restrict__ x, int64_t xs, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, int N, int K, int M,
    int H, int W, int imgs) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  const int Mp = (M + 7) / 8 * 8;
  float* s_b = s_w + 9 * K * Mp;
  float* s_x = s_b + Mp;
  const int HP = H + 2, WP = W + 2, HW = H * W, plane = HP * WP;
  const int c = blockIdx.y;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * imgs;
  const int nimg = static_cast<int>(min(static_cast<int64_t>(imgs), N - n0));
  const int tid = threadIdx.x, T = blockDim.x;

  stage_planes(s_x, x + c * xs + n0 * K * HW, nimg * K, H, W, plane);
  const float* wc = w + static_cast<int64_t>(c) * 9 * K * M;
  for (int i = tid; i < 9 * K * Mp; i += T) {
    const int o = i % Mp, r = i / Mp, k = r % K, tap = r / K;
    if (o < M)
      cp_async4(s_w + i, DGRAD ? wc + ((8 - tap) * M + o) * K + k
                               : wc + (tap * K + k) * M + o);
    else
      s_w[i] = 0.f;
  }
  for (int o = tid; o < Mp; o += T)
    s_b[o] = (!DGRAD && o < M) ? b[static_cast<int64_t>(c) * M + o] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  int base[kPix], img[kPix], rr[kPix];
  bool ok[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int q = tid + j * T;
    ok[j] = q < nimg * HW;
    img[j] = ok[j] ? q / HW : 0;
    rr[j] = ok[j] ? q % HW : 0;
    base[j] = img[j] * K * plane + (rr[j] / W) * WP + rr[j] % W;
  }
  for (int m0 = 0; m0 < Mp; m0 += CT) {
    float acc[kPix][CT];
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int o = 0; o < CT; ++o) acc[j][o] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float* xk = s_x + k * plane;
      const float* wk = s_w + k * Mp + m0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * WP + tap % 3;
        float v[kPix];
#pragma unroll
        for (int j = 0; j < kPix; ++j) v[j] = xk[base[j] + off];
        const float4* wt = reinterpret_cast<const float4*>(wk + tap * K * Mp);
#pragma unroll
        for (int o4 = 0; o4 < CT / 4; ++o4) {
          const float4 wv = wt[o4];
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            acc[j][4 * o4 + 0] = fmaf(v[j], wv.x, acc[j][4 * o4 + 0]);
            acc[j][4 * o4 + 1] = fmaf(v[j], wv.y, acc[j][4 * o4 + 1]);
            acc[j][4 * o4 + 2] = fmaf(v[j], wv.z, acc[j][4 * o4 + 2]);
            acc[j][4 * o4 + 3] = fmaf(v[j], wv.w, acc[j][4 * o4 + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!ok[j]) continue;
      float* yp = y + ((static_cast<int64_t>(c) * N + n0 + img[j]) * M + m0) *
                          HW + rr[j];
#pragma unroll
      for (int o = 0; o < CT; ++o)
        if (m0 + o < M)
          yp[static_cast<int64_t>(o) * HW] =
              DGRAD ? acc[j][o] : __fadd_rn(acc[j][o], s_b[m0 + o]);
    }
  }
}

template <int CT>
__global__ void __launch_bounds__(kMaxThreads) worker_conv_fwd(
    const float* __restrict__ x, int64_t xs, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, int N, int K, int M,
    int H, int W, int imgs) {
  conv_body<CT, false>(x, xs, w, b, y, N, K, M, H, W, imgs);
}

template <int CT>
__global__ void __launch_bounds__(kMaxThreads) worker_conv_dgrad(
    const float* __restrict__ gy, const float* __restrict__ w,
    float* __restrict__ dx, int N, int K, int M, int H, int W, int imgs) {
  // K = Cout channels read, M = Cin channels written
  conv_body<CT, true>(gy, static_cast<int64_t>(N) * K * H * W, w, nullptr,
                      dx, N, K, M, H, W, imgs);
}

// The weight and bias gradients: block (output-channel chunk, worker).
// Thread (group g, input channel k) holds the 9 taps x kWgradCt output
// channels of k's weight gradient (and, for k = 0, the bias's) over the
// pixels g, g + groups, ... of each staged chunk of the worker's images.
// Chunks are staged in two buffers, the next one's copies in flight
// while the current one is summed. The groups' partial sums are then
// added in group order in shared memory, one tap at a time.
__global__ void __launch_bounds__(kMaxThreads) worker_conv_wgrad(
    const float* __restrict__ x, int64_t xs, const float* __restrict__ gy,
    float* __restrict__ dw, float* __restrict__ db, int N, int K, int M,
    int H, int W, int imgs, int groups) {
  constexpr int CT = kWgradCt;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int WP = W + 2, HW = H * W;
  // an odd plane stride, so that the K channels' reads of one pixel fall
  // in different banks
  const int pstride = ((H + 2) * WP) | 1;
  // a buffer: the chunk's images with their halo, then gy's CT channels
  // of each image ([image][channel][pixel], as gy lies)
  const int xbuf = imgs * K * pstride, bufsize = xbuf + imgs * CT * HW;
  const int c = blockIdx.y, m0 = blockIdx.x * CT;
  const int tid = threadIdx.x, T = blockDim.x;
  const int k = tid % K, g = tid / K;
  const bool active = g < groups;
  const float* xc = x + c * xs;
  const float* gc = gy + static_cast<int64_t>(c) * N * M * HW;
  const int valid = min(CT, M - m0) * HW;   // gy floats of an image that exist
  // a group's step through a chunk's pixels, as (image, row, column)
  const int sw = groups % W, sh = (groups / W) % H, si = groups / HW;

  auto stage = [&](int n0, float* s) {
    const int nimg = min(imgs, N - n0);
    stage_planes(s, xc + static_cast<int64_t>(n0) * K * HW, nimg * K, H, W,
                 pstride);
    for (int im = 0; im < nimg; ++im) {
      const float* src = gc + (static_cast<int64_t>(n0 + im) * M + m0) * HW;
      float* dst = s + xbuf + im * CT * HW;
      for (int e = tid; e < CT * HW; e += T) {
        if (e < valid)
          cp_async4(dst + e, src + e);
        else
          dst[e] = 0.f;
      }
    }
    cp_async_commit();
  };

  float acc[9][CT], accb[CT];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int o = 0; o < CT; ++o) acc[t][o] = 0.f;
#pragma unroll
  for (int o = 0; o < CT; ++o) accb[o] = 0.f;

  const int chunks = (N + imgs - 1) / imgs;
  stage(0, smem);
  for (int i = 0; i < chunks; ++i) {
    if (i + 1 < chunks) {
      stage((i + 1) * imgs, smem + ((i + 1) & 1) * bufsize);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int nimg = min(imgs, N - i * imgs);
    const float* s_x = smem + (i & 1) * bufsize;
    const float* s_g = s_x + xbuf;
    if (active) {
      int pi = g / HW, ph = (g / W) % H, pw = g % W;
      for (int p = g; p < nimg * HW; p += groups) {
        const float* xb = s_x + (pi * K + k) * pstride + ph * WP + pw;
        const float* gp = s_g + pi * CT * HW + ph * W + pw;
        float xv[9], gv[CT];
#pragma unroll
        for (int t = 0; t < 9; ++t) xv[t] = xb[(t / 3) * WP + t % 3];
#pragma unroll
        for (int o = 0; o < CT; ++o) gv[o] = gp[o * HW];
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int o = 0; o < CT; ++o) acc[t][o] = fmaf(xv[t], gv[o], acc[t][o]);
        if (k == 0) {
#pragma unroll
          for (int o = 0; o < CT; ++o) accb[o] = __fadd_rn(accb[o], gv[o]);
        }
        pw += sw;
        ph += sh;
        pi += si;
        if (pw >= W) {
          pw -= W;
          ++ph;
        }
        if (ph >= H) {
          ph -= H;
          ++pi;
        }
      }
    }
    __syncthreads();
  }
  // the groups' partial sums, added in group order, a tap (then the
  // bias) at a time: s_red[g][k][CT]
  float* s_red = smem;
  const int per = K * CT;
#pragma unroll
  for (int t = 0; t < 10; ++t) {
    if (active && (t < 9 || k == 0)) {
#pragma unroll
      for (int o = 0; o < CT; ++o)
        s_red[(g * K + k) * CT + o] = t < 9 ? acc[t][o] : accb[o];
    }
    __syncthreads();
    for (int i = tid; i < (t < 9 ? per : CT); i += T) {
      float s = 0.f;
      for (int gg = 0; gg < groups; ++gg) s = __fadd_rn(s, s_red[gg * per + i]);
      const int o = i % CT, kk = i / CT, m = m0 + o;
      if (m >= M) continue;
      if (t < 9)
        dw[static_cast<int64_t>(c) * 9 * K * M + (t * K + kk) * M + m] = s;
      else
        db[static_cast<int64_t>(c) * M + m] = s;
    }
    __syncthreads();
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// The launch plans, the one place that sizes a launch (the wrapper asks
// them through wc_plan, both to route a convolution and to bound its
// sums in the tests). A plan is 0, or cudaErrorInvalidValue where the
// shape does not fit the kernel: then the model's convolution stays
// the library's.
struct Plan {
  int imgs;     // images a block (fwd, dgrad) or a staged chunk (wgrad)
  int threads;  // a block
  int ct;       // output channels a thread at a time
  int groups;   // wgrad: pixel groups a block (0 for fwd, dgrad)
  int smem;     // dynamic shared memory a block, bytes
};

constexpr int kSmemPlan = 64 * 1024;   // a block's staged images, planned
                                       // so that several blocks share an SM

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

bool bad_shape(int C, int N, int K, int M, int H, int W) {
  return C < 1 || C > 65535 || N < 1 || K < 1 || M < 1 || H < 1 || W < 1;
}

// fwd and dgrad: K channels read into M written. A block holds the
// worker's weights (M padded to 8) and bias, then up to kSmemPlan of
// images with their halo, as many as kMaxThreads threads of kPix pixels
// cover: images of at most 1,024 pixels.
int plan_conv(int C, int N, int K, int M, int H, int W, Plan* p) {
  if (bad_shape(C, N, K, M, H, W)) return invalid();
  const int64_t Mp = (M + 7) / 8 * 8, HW = static_cast<int64_t>(H) * W;
  const int64_t fixed = 4 * (9 * K * Mp + Mp);
  const int64_t per_img = 4LL * K * (H + 2) * (W + 2);
  if (HW > kPix * kMaxThreads || fixed + per_img > kSmemMax) return invalid();
  int64_t imgs = kPix * kMaxThreads / HW;
  if (imgs > N) imgs = N;
  if (imgs > (kSmemPlan - fixed) / per_img) imgs = (kSmemPlan - fixed) / per_img;
  if (imgs < 1) imgs = 1;
  const int64_t needed = (imgs * HW + kPix - 1) / kPix;
  *p = {static_cast<int>(imgs), static_cast<int>((needed + 31) / 32 * 32),
        Mp % 16 == 0 ? 16 : 8, 0, static_cast<int>(fixed + imgs * per_img)};
  return 0;
}

// wgrad: thread (group, input channel), kMaxThreads / K groups; a chunk
// of whole images (each with its halo at an odd plane stride, and gy's
// kWgradCt channels) in each of two buffers: at least a pixel a group
// where memory allows, up to kSmemPlan; then the groups' partial sums.
int plan_wgrad(int C, int N, int K, int M, int H, int W, Plan* p) {
  if (bad_shape(C, N, K, M, H, W)) return invalid();
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t per_img =
      8 * (K * ((static_cast<int64_t>(H + 2) * (W + 2)) | 1) + kWgradCt * HW);
  if (K > kMaxThreads || per_img > kSmemMax) return invalid();
  const int groups = kMaxThreads / K;
  int64_t imgs = (groups + HW - 1) / HW;
  if (imgs < kSmemPlan / per_img) imgs = kSmemPlan / per_img;
  if (imgs > kSmemMax / per_img) imgs = kSmemMax / per_img;
  if (imgs > N) imgs = N;
  const int64_t staged = imgs * per_img, red = 4LL * groups * K * kWgradCt;
  *p = {static_cast<int>(imgs), K * groups, kWgradCt, groups,
        static_cast<int>(staged > red ? staged : red)};
  return 0;
}

}  // namespace

extern "C" {

// the plan of a launch, as {imgs, threads, ct, groups, smem}: of the
// weight gradient if wgrad, else of fwd (K = Cin, M = Cout) or dgrad
// (K = Cout, M = Cin)
int wc_plan(int wgrad, int C, int N, int K, int M, int H, int W, int* out) {
  Plan p;
  if (int err = wgrad ? plan_wgrad(C, N, K, M, H, W, &p)
                      : plan_conv(C, N, K, M, H, W, &p))
    return err;
  out[0] = p.imgs;
  out[1] = p.threads;
  out[2] = p.ct;
  out[3] = p.groups;
  out[4] = p.smem;
  return 0;
}

int wc_forward(const void* x, long long xs, const void* w, const void* b,
               void* y, int C, int N, int K, int M, int H, int W,
               void* stream) {
  Plan p;
  if (int err = plan_conv(C, N, K, M, H, W, &p)) return err;
  const dim3 grid((N + p.imgs - 1) / p.imgs, C);
  auto kernel = p.ct == 16 ? worker_conv_fwd<16> : worker_conv_fwd<8>;
  if (cudaError_t err = allow_smem(kernel, p.smem))
    return static_cast<int>(err);
  kernel<<<grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), xs, static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), N, K, M, H, W,
      p.imgs);
  return static_cast<int>(cudaGetLastError());
}

// K = Cout (gy's channels), M = Cin (dx's)
int wc_dgrad(const void* gy, const void* w, void* dx, int C, int N, int K,
             int M, int H, int W, void* stream) {
  Plan p;
  if (int err = plan_conv(C, N, K, M, H, W, &p)) return err;
  const dim3 grid((N + p.imgs - 1) / p.imgs, C);
  auto kernel = p.ct == 16 ? worker_conv_dgrad<16> : worker_conv_dgrad<8>;
  if (cudaError_t err = allow_smem(kernel, p.smem))
    return static_cast<int>(err);
  kernel<<<grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gy), static_cast<const float*>(w),
      static_cast<float*>(dx), N, K, M, H, W, p.imgs);
  return static_cast<int>(cudaGetLastError());
}

// K = Cin, M = Cout
int wc_wgrad(const void* x, long long xs, const void* gy, void* dw, void* db,
             int C, int N, int K, int M, int H, int W, void* stream) {
  Plan p;
  if (int err = plan_wgrad(C, N, K, M, H, W, &p)) return err;
  const dim3 grid((M + kWgradCt - 1) / kWgradCt, C);
  if (cudaError_t err = allow_smem(worker_conv_wgrad, p.smem))
    return static_cast<int>(err);
  worker_conv_wgrad<<<grid, p.threads, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), xs, static_cast<const float*>(gy),
      static_cast<float*>(dw), static_cast<float*>(db), N, K, M, H, W, p.imgs,
      p.groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
