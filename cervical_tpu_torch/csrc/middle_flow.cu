// Eval-mode Xception middle flow (backbone blocks 4-19) for Hopper, sm_90a.
//
// Replaces the TPU kernel cervical_tpu/ops/pallas_xception.py::middle_flow_eval
// (_block_kernel).  Per block: skip = relu(x); three times [ReLU, depthwise
// 3x3 at dilation d with zero padding, folded BN1 affine, pointwise C x C
// product with BN2's scale folded in, + BN2 shift]; out = z + skip.
//
// What bounds it.  At 512^2 input, output stride 16, batch 8, the middle flow
// works on (8, 32, 32, 728): 48 pointwise products of M=8192, K=N=728, i.e.
// 417 GFLOP of bf16 tensor-core work against ~76 MB that must move (block
// input and output, 51 MB of folded weights).  The whole function is bound
// by operations; one separable conv alone (f32 z in, f32 z out, 23.9 MB
// each way) is bound by its bytes.
//
// What the design does about it.  The TPU kernel keeps one image's
// (32, 32, 728) activation in VMEM across all 16 blocks on a sequential
// (batch, block) grid.  On Hopper that activation is 1.49 MB in bf16 against
// 227 KB of shared memory per block, and CUDA blocks run in no order, so the
// block axis is a host loop.  Each separable conv is two launches (a kernel
// that computed the stencil into the GEMM's shared-memory A panel measured
// slower on the H100; PERF.md):
//   * mf_dw_stencil: ReLU, the 9 zero-padded taps at dilation d and the BN1
//     affine in f32, with the same operations in the same order and no FMA
//     as the plain version (bit-identical zb, in bf16).  The stencil reads
//     each element of z 9 times; read through L2 from scattered threads that
//     costs ~3x the bytes' time.  Here a thread owns 8 channels of one
//     column w and walks `rows` output rows h = r, r + d, ... (one residue r
//     of h mod d), so the input rows it needs slide by one row per step: it
//     loads each input row once (3 pixels: w - d, w, w + d) and keeps three
//     running sums in registers, for the outputs that row closes (dy = +1),
//     continues (dy = 0) and opens (dy = -1).  Each output's 9 terms are
//     still added in the plain version's order.  Blocks of 8 x 32 threads
//     take 64 channels of 32 neighbouring columns, so the w +- d loads of
//     one thread are its neighbours' w loads, served by L1.  Device memory
//     sees z about (rows + 2) / rows times.
//   * mf_pw_gemm: zb @ W, a warp-specialised wgmma GEMM.  One producer
//     thread streams A's 256 x 64 and W^T's 184 x 64 boxes of each k-tile by
//     TMA (cp.async.bulk.tensor.2d, 128-byte swizzle) into one of 4 stages
//     guarded by full/empty mbarriers; two consumer warpgroups each multiply
//     their 128 rows (two m64 panels) with the same W^T box
//     (wgmma.mma_async m64n184k16, f32 += bf16 x bf16), with one commit
//     group in flight while the previous stage is released.  The product
//     is bound by what each SM pulls from L2, (rows + columns) x K per tile
//     for rows x columns outputs: 256 x 184 tiles read 30% less per output
//     than 128 x 184, and at os16 their 128 tiles are one wave on 132 SMs.
//     W is kept K-major as W^T (N, K), a copy made once by the fold, so
//     both operands are K-major.  N = 728 is 4 x 184 - 8.  setmaxnreg
//     moves registers from the producer warpgroup (40) to the consumers
//     (232, of which the accumulators take 184); that needs
//     ptxas to give the kernel 168 registers per thread, which the host
//     checks before the first launch (else setmaxnreg.inc would wait
//     forever).  The epilogue works from the accumulator registers: + BN2
//     shift and, at a block's third conv (FINAL), + relu(block input) and a
//     bf16 rounding; 8-byte (f32 pairs) or 4-byte (bf16 pairs) stores, each
//     quad of lanes filling one 32-byte sector.
// Ragged shapes: K and N = 728 are 11 x 64 + 24.  TMA zero-fills the k
// columns past K in A's and W^T's boxes, so the last k-tile's extra k16
// steps add nothing; the epilogue skips rows past M and columns past N (N
// is a multiple of 8, so a column pair is wholly in or out).
//
// In f32 (compute_dtype=float32: the folded weights, zb and the block
// output are f32, and zb is not rounded) the same function runs on two
// more kernels:
//   * mf_dw_stencil_f32: the same operations in the same order without
//     FMA as the plain version (bit-identical zb, f32).  It is bound by its
//     bytes (f32 z in, f32 zb out: 2 x 23.9 MB at os16, 0.0143 ms at 3.35
//     TB/s), so the design keeps many bytes in flight without registers:
//     one block per (image, 32 columns, `rows` output rows of one residue
//     of h mod d, channel slice) asks TMA (cp.async.bulk.tensor.4d over the
//     NHWC tensor) for all the rows + 2 input rows it needs at once, each
//     box the slice's channels x 32 + 2d columns, one mbarrier per row; the
//     box's out-of-bounds zero fill is the zero padding (rows wholly
//     outside the image are not loaded: they read as zeros).  A thread owns
//     one column (its lane) and 4 channels and carries the three running
//     sums of the rolling-row design above through its rows, reading each
//     input row once from shared memory (3 pixels, 16-byte loads), the
//     taps and the BN1 affine from shared memory too (one address per warp:
//     a broadcast).  The slice is 4 x SQ channels, SQ the largest odd
//     divisor of C / 4 up to 13: at C = 728, 13 quads (416 threads), 14
//     slices, no idle lane, and an odd number of 16-byte chunks per column
//     keeps a warp's loads free of bank conflicts.  Each output row goes
//     to one of 4 shared buffers and out by a TMA store (clipped past W),
//     one barrier per row; up to two stores may still read their buffers
//     while the next rows compute.  `rows` (ops/middle_flow.py
//     STENCIL_F32_ROWS: 4 at dilation 1, 3 at 2) trades the halo's extra
//     rows against whole waves of blocks (3 blocks of 48 registers x 416
//     threads and 72 KB fit an SM).  What holds it above its byte bound
//     (PERF.md): each block asks for its rows in one burst and then
//     computes, so an SM's loads come in bursts of 3 blocks; a block with
//     no loads (rows read as zeros) alone takes its byte bound's time.
//   * mf_pw_gemm_f32: zb @ W + c2 (FINAL: + relu(skip_src)) to f32
//     accuracy on the tensor cores, in the split form ("3xTF32"): each
//     operand x = hi + lo, hi = tf32_rna(x), lo = tf32_rna(x - hi) (cvt.rna
//     ties away; x - hi is exact), and a b ~ a_hi b_hi + a_hi b_lo + a_lo
//     b_hi, all three by wgmma.mma_async m64n184k8 .f32.tf32.tf32 into one
//     accumulator set.  The dropped a_lo b_lo and the roundings of the low
//     parts leave ~3 x 2^-22 |a||b| per term at worst, random in sign.  The
//     tensor cores' own sums are the larger error: accumulated in one set
//     over K = 728 (273 wgmma k8 steps) the product measured 4.3e-5 from an
//     f64 product on the H100 where cuBLAS's SGEMM is 9.6e-6 (PERF.md), the
//     bias of sums cut rather than rounded (a CPU model of it:
//     tests/torch_port_helpers.py split_gemm_model).  So each k-tile's
//     three products start a fresh accumulator set (scale-d 0) and are then
//     added to a second set in registers with one rounded FADD each
//     ("promotion"): the tensor cores' sums span 12 steps only (3.3e-6 from
//     f64, a third of cuBLAS's).  W's split is
//     made once by the fold (wpw_t_split: hi and lo, K-major); A's split is
//     made in registers: PTX takes a .tf32 A operand from registers, so
//     each consumer loads its fragment from the swizzled stage (4 floats a
//     k8 step, conflict-free), splits it and issues the wgmma with A in
//     registers and W's part from shared memory (no second A plane to
//     write, and half the shared-memory reads of two descriptors).  Tiles
//     of 128 x 184 (N = 728 is 4 x 184 - 8): one m64 panel per consumer
//     warpgroup, whose two accumulator sets take 184 registers (setmaxnreg
//     gives the consumers 240 and the producer 24, which needs ptxas's 168
//     a thread, checked before the first launch as for the bf16 GEMM).
//     TMA streams A's 128 x 32 box and W_hi's and W_lo's 184 x 32 boxes of
//     each k-tile (128 bytes of f32, the 128-byte swizzle) into 3 stages of
//     63,488 bytes (A plus two W parts; a fourth does not fit 227 KB).  The
//     RS form needs A's registers until the k-tile's products are done, so
//     each warpgroup waits for them once a k-tile; the two warpgroups take
//     turns issuing their k-tile's 12 products (named barriers), so one's
//     products run on the tensor cores while the other waits, promotes and
//     splits its next fragment (in lockstep the tensor cores idled through
//     both promotions: 0.094 against 0.075 ms, PERF.md).  The
//     split product is bound by its tensor-core operations: 3 x 8.68 GFLOP
//     per product at os16 at 495 TFLOP/s TF32, 0.0526 ms (against 0.1296 ms
//     for one FFMA product at 67 TFLOP/s).  Ragged shapes as the bf16 GEMM:
//     TMA zero-fills past K (K = 728 is 22 x 32 + 24), the epilogue skips
//     rows past M and columns past N.
//
// The tensor maps are encoded on the host per call with
// cuTensorMapEncodeTiled, fetched from the driver through the runtime's
// cudaGetDriverEntryPoint (no -lcuda), and passed as __grid_constant__
// kernel parameters.  Every entry point takes a plain C interface (pointers
// and the stream as void*), launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError(), ENCODE_ERROR + CUresult when a
// tensor map cannot be encoded, or REGS_ERROR + registers when ptxas gave
// the GEMM too few registers for setmaxnreg.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ENCODE_ERROR = 10000;
constexpr int REGS_ERROR = 20000;
// mf_dw_stencil: blocks of ST_CX 8-channel chunks x ST_WY columns
constexpr int ST_CX = 8;
constexpr int ST_WY = 32;
// mf_pw_gemm: 256 x 184 output tiles (N = 728 is 4 x 184 - 8), A and W^T
// streamed together through GSTAGES stages that both warpgroups share
constexpr int BK = 64;       // k per TMA box and swizzle atom (128 bytes)
constexpr int THREADS = 384; // producer warpgroup + 2 consumer warpgroups
constexpr int GBM = 256;
constexpr int GBN = 184;
constexpr int GSTAGES = 4;
constexpr int MH = GBM / 128;       // 64-row wgmma panels per warpgroup
constexpr int PRODUCER_REGS = 40;   // setmaxnreg, per thread
constexpr int CONSUMER_REGS = 232;
constexpr int GA_HALF = 64 * BK * 2;        // one consumer's 64 rows of A
constexpr int GA_TILE = GBM * BK * 2;       // 32 KB
constexpr int GB_TILE = GBN * BK * 2;       // 23 KB, a multiple of 1024
constexpr int G_STAGE = GA_TILE + GB_TILE;  // 56,320 bytes
// mf_pw_gemm_f32: FBM x GBN output tiles, one m64 panel per consumer
// warpgroup; k-tiles of FBK f32 (128 bytes, the swizzle's width) of A,
// W_hi and W_lo streamed through FSTAGES stages
constexpr int FBK = 32;
constexpr int FBM = 128;
constexpr int FSTAGES = 3;
constexpr int F_PRODUCER_REGS = 24;
constexpr int F_CONSUMER_REGS = 240;
constexpr int FA_TILE = FBM * FBK * 4;          // 16 KB
constexpr int FW_TILE = GBN * FBK * 4;          // 23,552 bytes, 23 x 1024
constexpr int F_STAGE = FA_TILE + 2 * FW_TILE;  // 63,488 bytes
constexpr int F_SMEM = 1024 + FSTAGES * F_STAGE + 16 * FSTAGES;
static_assert(FA_TILE % 1024 == 0 && FW_TILE % 1024 == 0,
              "each box starts on a 1024-byte swizzle atom");
static_assert(F_SMEM <= 232448, "a block may opt in to 227 KB");
static_assert(128 * F_PRODUCER_REGS + 256 * F_CONSUMER_REGS <= 65536,
              "setmaxnreg moves registers inside the SM's 64K");
// mf_dw_stencil_f32: blocks of SW columns (one a lane) x SQ channel quads,
// SQ the largest odd divisor of C / 4 up to SQ_MAX; S_OUT output row
// buffers in the TMA-store ring
constexpr int SW = 32;
constexpr int SQ_MAX = 13;
constexpr int S_OUT = 4;

// Eight consecutive channels as f32 (16-byte loads; c is a multiple of 8).
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// One tap's 8 bf16 weights as f32, loaded where it is used: a volatile load
// (L1-resident, 13 KB for all taps) that the compiler cannot hoist out of
// the row loop, where 72 more live registers would halve the occupancy.
__device__ __forceinline__ void load_tap(const bf16* p, float v[8]) {
  uint4 u;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Eight consecutive channels of zb, rounded to bf16 (one 16-byte store).
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = out;
}

// relu(z[n, h, w + (dx - 1) d, c:c+8]) for dx = 0, 1, 2; zeros outside the
// image (the zero padding).
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ z, float v[3][8],
                                         int n, int h, int w, int H, int W,
                                         int C, int c, int d) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int ww = w + (dx - 1) * d;
    if (h >= 0 && h < H && ww >= 0 && ww < W) {
      load8(z + ((n * H + h) * W + ww) * C + c, v[dx]);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[dx][j] = fmaxf(v[dx][j], 0.f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[dx][j] = 0.f;
    }
  }
}

// acc += the three terms of tap row ky (dy = ky - 1) for one output, in the
// plain version's order (dx = -1, 0, 1), each rounded: no FMA.
template <typename TC>
__device__ __forceinline__ void add_taps(float acc[8], const float v[3][8],
                                         const TC* __restrict__ wdw, int ky,
                                         int C, int c) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float wt[8];
    load_tap(wdw + (ky * 3 + dx) * C + c, wt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(v[dx][j], wt[j]));
  }
}

// zb[n, h, w, c:c+8] = TC((sum_t relu(z[n, h+dy*d, w+dx*d, c]) * wdw[t, c])
// * s1[c] + c1[c]), t = (dy+1)*3 + (dx+1), summed from 0 in t's order.
// TC, the compute type, is the taps' and zb's: bf16 (z bf16 or f32; the
// f32 set has its own kernel, dw_stencil_f32_kernel).
// blockIdx.x: channel tile + ST_CX-chunk column tile; blockIdx.y: residue r
// of h mod d + segment of `rows` steps; blockIdx.z: image.  Step t of
// residue r is output row h = r + t d.  When input row h + d arrives it
// closes output h (its dy = +1 terms, added last), continues output h + d
// (dy = 0) and opens output h + 2d (dy = -1, added first).  Three blocks
// per SM (<= 85 registers, 24 warps): BN1's affine is read from L1 at each
// store rather than held, which measured 6-11% faster than two blocks.
template <typename T, typename TC>
__global__ void __launch_bounds__(ST_CX * ST_WY, 3)
    dw_stencil_kernel(const T* __restrict__ z, const TC* __restrict__ wdw,
                      const float* __restrict__ s1,
                      const float* __restrict__ c1, TC* __restrict__ zb,
                      int H, int W, int C, int d, int rows) {
  const int C8 = C / 8;
  const int ctiles = (C8 + ST_CX - 1) / ST_CX;
  const int q = (blockIdx.x % ctiles) * ST_CX + threadIdx.x;
  const int w = (blockIdx.x / ctiles) * ST_WY + threadIdx.y;
  if (q >= C8 || w >= W) return;
  const int c = q * 8;
  const int r = blockIdx.y % d;
  const int t0 = (blockIdx.y / d) * rows;
  const int t1 = min(t0 + rows, (H - r + d - 1) / d);
  if (t0 >= t1) return;
  const int n = blockIdx.z;
  float v[3][8], close[8], cont[8];
  // the two input rows before the first step's: h0 - d, h0
  const int h0 = r + t0 * d;
#pragma unroll
  for (int j = 0; j < 8; ++j) close[j] = 0.f;
  load_row(z, v, n, h0 - d, w, H, W, C, c, d);
  add_taps(close, v, wdw, 0, C, c);
  load_row(z, v, n, h0, w, H, W, C, c, d);
  add_taps(close, v, wdw, 1, C, c);
#pragma unroll
  for (int j = 0; j < 8; ++j) cont[j] = 0.f;
  add_taps(cont, v, wdw, 0, C, c);
  for (int t = t0; t < t1; ++t) {
    const int h = r + t * d;
    load_row(z, v, n, h + d, w, H, W, C, c, d);
    add_taps(close, v, wdw, 2, C, c);
    float sc[8], sh[8], o[8];
    load8(s1 + c, sc);
    load8(c1 + c, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __fadd_rn(__fmul_rn(close[j], sc[j]), sh[j]);
    store8(zb + ((n * H + h) * W + w) * C + c, o);
    if (t + 1 == t1) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) close[j] = cont[j];
    add_taps(close, v, wdw, 1, C, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) cont[j] = 0.f;
    add_taps(cont, v, wdw, 0, C, c);
  }
}

// ---------------------------------------------------------------------------
// PTX wrappers: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait that lasts
// ~2^32 cycles (seconds) traps: a pipeline fault fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 32))
      __trap();
  }
}

// 2-D tiled TMA load of the box at (c0 = inner element, c1 = row) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes (64 bf16 of k), 8-row atoms of 1024 bytes
// (stride byte offset 1024), atoms 1024-aligned.  The leading byte offset
// is unused by swizzled K-major layouts (1 by convention).  Moving k by 16
// elements inside the atom adds 32 bytes (2 in the >>4 address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 184] += A[64 x 16] * B[16 x 184], both from shared memory,
// K-major.  Accumulator fragment: thread t of the warpgroup holds, for n8
// block i (of 23), d[4i + 0/1] at (row 16*(t/32) + (t%32)/4, col 8i +
// 2*(t%4) + 0/1) and d[4i + 2/3] eight rows lower.
__device__ __forceinline__ void wgmma_m64n184k16(float (&d)[92], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %94, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91}, "
      "%92, %93, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The pointwise product alone (mf_pw_gemm): out = A @ Wt^T + c2 (f32) or,
// FINAL, bf16(that + relu(skip_src)).  One block per GBM x 184 output tile;
// the producer streams A's GBM x 64 and W^T's 184 x 64 boxes of each k-tile
// into one stage; consumer warpgroup j multiplies A's rows GBM / 2 j.. (MH
// panels of 64) with the whole W^T box (m64n184k16).
template <bool FINAL>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w,
                const float* __restrict__ c2,
                const bf16* __restrict__ skip_src, float* __restrict__ out_f32,
                bf16* __restrict__ out_bf16, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + GSTAGES * G_STAGE);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (GSTAGES + s); };
  const int nkt = (K + BK - 1) / BK;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one release per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), G_STAGE);
        const uint32_t dst = smem_u32(smem + stage * G_STAGE);
        tma_load_2d(dst, &map_a, full(stage), kt * BK, m0);
        tma_load_2d(dst + GA_TILE, &map_w, full(stage), kt * BK, n0);
        if (++stage == GSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int j = tid / 128 - 1;
  const int lane = tid % 32, wl = (tid % 128) / 32;
  const bool leader = tid % 128 == 0;
  // acc[u]: rows 64 (MH j + u) .. of the tile
  float acc[MH][92];
#pragma unroll
  for (int u = 0; u < MH; ++u)
#pragma unroll
    for (int i = 0; i < 92; ++i) acc[u][i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    mbar_wait(full(stage), phase);
    const uint32_t base = smem_u32(smem + stage * G_STAGE);
    const uint64_t db = sw128_desc(base + GA_TILE);
#pragma unroll
    for (int u = 0; u < MH; ++u) fence_acc(acc[u]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
#pragma unroll
      for (int u = 0; u < MH; ++u)
        wgmma_m64n184k16(acc[u],
                         sw128_desc(base + (MH * j + u) * GA_HALF) + 2 * k,
                         db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < MH; ++u) fence_acc(acc[u]);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < MH; ++u) fence_acc(acc[u]);
    if (kt > 0 && leader) mbar_arrive(empty(prev));
    prev = stage;
    if (++stage == GSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int u = 0; u < MH; ++u) fence_acc(acc[u]);

#pragma unroll
  for (int u = 0; u < MH; ++u) {
    const int row0 = m0 + (MH * j + u) * 64 + wl * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < GBN / 8; ++i) {
      const int col = n0 + i * 8 + (lane % 4) * 2;
      if (col < N) {
        const float2 b = *reinterpret_cast<const float2*>(c2 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row < M) {
            float v0 = __fadd_rn(acc[u][4 * i + 2 * h], b.x);
            float v1 = __fadd_rn(acc[u][4 * i + 2 * h + 1], b.y);
            const long long o = (long long)row * N + col;
            if (FINAL) {
              const float2 s = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(skip_src + o));
              v0 = __fadd_rn(v0, fmaxf(s.x, 0.f));
              v1 = __fadd_rn(v1, fmaxf(s.y, 0.f));
              *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 kernels
// ---------------------------------------------------------------------------

// x = hi + lo + e: hi = tf32_rna(x), lo = tf32_rna(x - hi) (x - hi is exact
// in f32), |e| <= 2^-22 |x|; both as f32 bit patterns with the 13 low
// mantissa bits zero (the mask keeps that whatever cvt leaves there).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d[64 x 184] (+)= A[64 x 8] * B[8 x 184]: A tf32 from registers (thread t
// of the warpgroup: a[0] at (row 16*(t/32) + (t%32)/4, k t%4), a[1] eight
// rows lower, a[2] and a[3] the same at k + 4), B tf32 from shared memory,
// K-major.  scale_d 0 ignores d's old value.  d's fragment as
// wgmma_m64n184k16's.
__device__ __forceinline__ void wgmma_tf32_m64n184k8(float (&d)[92],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %97, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91}, "
      "{%92, %93, %94, %95}, %96, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Named barrier `id` among `n` threads: wait for all, or arrive only.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The pointwise product in f32 (mf_pw_gemm_f32): out = A @ Wt^T + c2 or,
// FINAL, that + relu(skip_src), all f32, from the split parts.  One block per
// FBM x GBN output tile; the producer streams A's FBM x FBK, W_hi's and
// W_lo's GBN x FBK boxes of each k-tile into one stage; consumer warpgroup j
// splits A's rows 64 j.. in registers and runs, per k8 step, A_hi W_lo,
// A_lo W_hi, A_hi W_hi (small parts first) into `part`, zeroed by the
// k-tile's first product, then adds `part` to `sum` in order, one FADD each.
template <bool FINAL>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_wh,
                    const __grid_constant__ CUtensorMap map_wl,
                    const float* __restrict__ c2,
                    const float* __restrict__ skip_src,
                    float* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + FSTAGES * F_STAGE);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (FSTAGES + s); };
  const int nkt = (K + FBK - 1) / FBK;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * FBM;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one release per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        F_PRODUCER_REGS));
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), F_STAGE);
        const uint32_t dst = smem_u32(smem + stage * F_STAGE);
        tma_load_2d(dst, &map_a, full(stage), kt * FBK, m0);
        tma_load_2d(dst + FA_TILE, &map_wh, full(stage), kt * FBK, n0);
        tma_load_2d(dst + FA_TILE + FW_TILE, &map_wl, full(stage), kt * FBK,
                    n0);
        if (++stage == FSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      F_CONSUMER_REGS));
  const int j = tid / 128 - 1;
  const int lane = tid % 32, wl = (tid % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const bool leader = tid % 128 == 0;
  // this thread's A rows in a stage: 64 j + 16 wl + g and 8 lower (the same
  // row mod 8, so the same swizzle); k = 8 s + t + 4 h is in 16-byte chunk
  // 2 s + h, stored at chunk (2 s + h) ^ (row mod 8)
  const int a_row = (64 * j + 16 * wl + g) * 128 + t * 4;
  float part[92], sum[92];
#pragma unroll
  for (int i = 0; i < 92; ++i) sum[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    mbar_wait(full(stage), phase);
    const uint8_t* st = smem + stage * F_STAGE;
    uint32_t ah[FBK / 8][4], al[FBK / 8][4];
#pragma unroll
    for (int s = 0; s < FBK / 8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q: (h, lower) = (q / 2, q % 2)
        const float x = *reinterpret_cast<const float*>(
            st + a_row + (q % 2) * 1024 + (((2 * s + q / 2) ^ g) << 4));
        tf32_split(x, ah[s][q], al[s][q]);
      }
    const uint32_t base = smem_u32(st);
    const uint64_t dwh = sw128_desc(base + FA_TILE);
    const uint64_t dwl = sw128_desc(base + FA_TILE + FW_TILE);
    // ping-pong: the warpgroups issue their k-tiles' products in turns
    // (0, 1, 0, 1, ...; named barriers 1 and 2), so the tensor cores run
    // one's products while the other waits, promotes and splits
    if (kt > 0 || j == 1) named_bar_sync(1 + j, 256);
    fence_acc(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < FBK / 8; ++s) {
      wgmma_tf32_m64n184k8(part, ah[s], dwl + 2 * s, s > 0);
      wgmma_tf32_m64n184k8(part, al[s], dwh + 2 * s, 1);
      wgmma_tf32_m64n184k8(part, ah[s], dwh + 2 * s, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt + 1 < nkt || j == 0) named_bar_arrive(2 - j, 256);
    fence_acc(part);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(part);
    if (leader) mbar_arrive(empty(stage));
#pragma unroll
    for (int i = 0; i < 92; ++i) sum[i] = __fadd_rn(sum[i], part[i]);
    if (++stage == FSTAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int row0 = m0 + 64 * j + wl * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < GBN / 8; ++i) {
    const int col = n0 + i * 8 + (lane % 4) * 2;
    if (col < N) {
      const float2 b = *reinterpret_cast<const float2*>(c2 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M) {
          float v0 = __fadd_rn(sum[4 * i + 2 * h], b.x);
          float v1 = __fadd_rn(sum[4 * i + 2 * h + 1], b.y);
          const long long o = (long long)row * N + col;
          if (FINAL) {
            const float2 sk = *reinterpret_cast<const float2*>(skip_src + o);
            v0 = __fadd_rn(v0, fmaxf(sk.x, 0.f));
            v1 = __fadd_rn(v1, fmaxf(sk.y, 0.f));
          }
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

// The splits of x[0:n] as the GEMM makes them (mf_tf32_split).
__global__ void tf32_split_kernel(const float* __restrict__ x,
                                  uint32_t* __restrict__ hi,
                                  uint32_t* __restrict__ lo, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) tf32_split(x[i], hi[i], lo[i]);
}

// 4-D tiled TMA load of the box at (c0, c1, c2, c3) (innermost first).
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 4-D tiled TMA store of shared memory at src to the box at (c0, c1, c2, c3);
// elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory layout of mf_dw_stencil_f32's block (byte offsets from a
// 128-aligned base): taps, BN1 scale and shift (11 x cs f32), the input
// rows (rows + 2 slots), the output ring (S_OUT), one mbarrier per input
// row.
struct StencilSmem {
  int cs, slot, in, out, bars, bytes;
  __host__ __device__ StencilSmem(int sq, int d, int rows) {
    cs = 4 * sq;
    slot = ((SW + 2 * d) * cs * 4 + 127) / 128 * 128;
    in = (11 * cs * 4 + 127) / 128 * 128;
    out = in + (rows + 2) * slot;
    bars = out + S_OUT * SW * cs * 4;
    bytes = 128 + bars + 8 * (rows + 2);  // + alignment slack
  }
};

// zb[n, h, w, c] = f32((sum_t relu(z[n, h+dy*d, w+dx*d, c]) * wdw[t, c])
// * s1[c] + c1[c]), t = (dy+1)*3 + (dx+1), summed from 0 in t's order, as
// dw_stencil_kernel; z and zb through TMA maps over (C, W, H, B).
// blockIdx.x: channel slice + column tile; blockIdx.y: residue r of h mod d
// + segment of `rows` steps; blockIdx.z: image.  Thread (x, y): column
// w0 + x, channels c0 + 4 y...  Input slot j holds row r + (t0 - 1 + j) d,
// columns w0 - d .. w0 + SW + d - 1.
__global__ void __launch_bounds__(SW * SQ_MAX)
    dw_stencil_f32_kernel(const __grid_constant__ CUtensorMap map_z,
                          const __grid_constant__ CUtensorMap map_zb,
                          const float* __restrict__ wdw,
                          const float* __restrict__ s1,
                          const float* __restrict__ c1, int H, int W, int C,
                          int d, int rows, int sq) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const StencilSmem L(sq, d, rows);
  const int cs = L.cs;
  const int slices = C / cs;
  const int c0 = (blockIdx.x % slices) * cs;
  const int w0 = (blockIdx.x / slices) * SW;
  const int r = blockIdx.y % d;
  const int t0 = (blockIdx.y / d) * rows;
  const int t1 = min(t0 + rows, (H - r + d - 1) / d);
  if (t0 >= t1) return;  // the whole block
  const int n = blockIdx.z;
  const int tid = threadIdx.y * SW + threadIdx.x;
  const int nin = t1 - t0 + 2;
  const int hin0 = r + (t0 - 1) * d;  // slot 0's row
  // rows wholly above or below the image are not loaded
  const int j_lo = hin0 < 0 ? (-hin0 + d - 1) / d : 0;
  const int j_hi = min(nin, (H - 1 - hin0) / d + 1);
  const uint32_t bars = smem_u32(smem + L.bars);
  if (tid == 0) {
    for (int j = j_lo; j < j_hi; ++j) mbar_init(bars + 8u * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t box = (SW + 2 * d) * cs * 4;
    for (int j = j_lo; j < j_hi; ++j) {
      mbar_expect_tx(bars + 8u * j, box);
      tma_load_4d(smem_u32(smem + L.in + j * L.slot), &map_z, bars + 8u * j,
                  c0, w0 - d, hin0 + j * d, n);
    }
  }
  float* taps = reinterpret_cast<float*>(smem);  // [11][cs]
  if (tid < 11 * sq) {
    const int k = tid / sq, q4 = (tid % sq) * 4;
    const float* src = k < 9 ? wdw + k * C : (k == 9 ? s1 : c1);
    *reinterpret_cast<float4*>(taps + k * cs + q4) =
        *reinterpret_cast<const float4*>(src + c0 + q4);
  }
  __syncthreads();

  const int q4 = threadIdx.y * 4;
  const int x = threadIdx.x;
  float v[3][4], close[4], cont[4];
  // relu(input row j) at columns x + dx d of the slot (w + (dx - 1) d)
  auto load_row = [&](int j) {
    if (j < j_lo || j >= j_hi) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[dx][i] = 0.f;
      return;
    }
    mbar_wait(bars + 8u * j, 0);
    const float* row =
        reinterpret_cast<const float*>(smem + L.in + j * L.slot) + q4;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float4 p =
          *reinterpret_cast<const float4*>(row + (x + dx * d) * cs);
      v[dx][0] = fmaxf(p.x, 0.f);
      v[dx][1] = fmaxf(p.y, 0.f);
      v[dx][2] = fmaxf(p.z, 0.f);
      v[dx][3] = fmaxf(p.w, 0.f);
    }
  };
  // acc += the three terms of tap row ky, in the plain version's order
  auto add_taps = [&](float acc[4], int ky) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float4 w =
          *reinterpret_cast<const float4*>(taps + (ky * 3 + dx) * cs + q4);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(v[dx][0], w.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(v[dx][1], w.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(v[dx][2], w.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(v[dx][3], w.w));
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) close[i] = 0.f;
  load_row(0);
  add_taps(close, 0);
  load_row(1);
  add_taps(close, 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) cont[i] = 0.f;
  add_taps(cont, 0);
  for (int t = t0; t < t1; ++t) {
    load_row(t - t0 + 2);
    add_taps(close, 2);
    const float4 sc = *reinterpret_cast<const float4*>(taps + 9 * cs + q4);
    const float4 sh = *reinterpret_cast<const float4*>(taps + 10 * cs + q4);
    const int b = (t - t0) % S_OUT;
    float* o = reinterpret_cast<float*>(smem + L.out) + b * SW * cs;
    *reinterpret_cast<float4*>(o + x * cs + q4) =
        make_float4(__fadd_rn(__fmul_rn(close[0], sc.x), sh.x),
                    __fadd_rn(__fmul_rn(close[1], sc.y), sh.y),
                    __fadd_rn(__fmul_rn(close[2], sc.z), sh.z),
                    __fadd_rn(__fmul_rn(close[3], sc.w), sh.w));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      tma_store_4d(&map_zb, smem_u32(o), c0, w0, r + t * d, n);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // at most S_OUT - 2 stores still reading: the buffer that step t + 2
      // writes, last read by the store of step t + 2 - S_OUT, is free
      // before this thread reaches the barrier of step t + 1, which the
      // writers pass first
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(S_OUT - 2)
                   : "memory");
    }
    if (t + 1 == t1) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) close[i] = cont[i];
    add_taps(close, 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) cont[i] = 0.f;
    add_taps(cont, 0);
  }
  // the stores must have read their buffers before the block's shared
  // memory goes
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) bf16 row-major tensor, read in boxes of BK columns x
// box_rows rows with the 128-byte swizzle; out-of-bounds elements read 0.
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
             int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return ENCODE_ERROR + 999;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// A (rows, cols) f32 row-major tensor, read in boxes of FBK columns x
// box_rows rows with the 128-byte swizzle; out-of-bounds elements read 0.
int make_map_f32(CUtensorMap* map, const void* ptr, int rows, int cols,
                 int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return ENCODE_ERROR + 999;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)FBK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// An NHWC (B, H, W, C) f32 tensor as a 4-D map over (C, W, H, B), read or
// written in boxes of cs channels x box_w columns of one row, unswizzled;
// out-of-bounds elements read 0 and are not written.
int make_map_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W,
                  int C, int cs, int box_w) {
  const EncodeTiled enc = encoder();
  if (!enc) return ENCODE_ERROR + 999;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                 (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cs, (cuuint32_t)box_w, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                         const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// The GEMM's register budget: setmaxnreg only moves registers inside the
// block's allocation, so the producer's and the consumers' counts must fit
// in what ptxas gave each of the 384 threads (168).  Returns 0, a CUDA
// error, or REGS_ERROR + the registers ptxas gave.
template <bool FINAL>
int gemm_regs_ok() {
  static int regs = 0;
  if (!regs) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, gemm_kernel<FINAL>);
    if (e != cudaSuccess) return (int)e;
    regs = a.numRegs;
  }
  return regs * THREADS >= 128 * PRODUCER_REGS + 256 * CONSUMER_REGS
             ? 0
             : REGS_ERROR + regs;
}

template <bool FINAL>
int launch_gemm(const CUtensorMap& ma, const CUtensorMap& mw, const void* c2,
                const void* skip_src, void* out, int M, int K, int N, int smem,
                cudaStream_t s) {
  const int e = gemm_regs_ok<FINAL>();
  if (e) return e;
  static int smem_set = 0;  // above 48 KB only after this attribute
  if (smem > smem_set) {
    const cudaError_t r = cudaFuncSetAttribute(
        gemm_kernel<FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
    smem_set = smem;
  }
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<FINAL><<<grid, THREADS, smem, s>>>(
      ma, mw, (const float*)c2, (const bf16*)skip_src,
      FINAL ? nullptr : (float*)out, FINAL ? (bf16*)out : nullptr, M, K, N);
  return (int)cudaGetLastError();
}

// The f32 GEMM's register budget, as gemm_regs_ok: its producer (24) and
// consumers (240) need the same 168 per thread.
template <bool FINAL>
int gemm_f32_regs_ok() {
  static int regs = 0;
  if (!regs) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, gemm_f32_kernel<FINAL>);
    if (e != cudaSuccess) return (int)e;
    regs = a.numRegs;
  }
  return regs * THREADS >= 128 * F_PRODUCER_REGS + 256 * F_CONSUMER_REGS
             ? 0
             : REGS_ERROR + regs;
}

template <bool FINAL>
int launch_gemm_f32(const CUtensorMap& ma, const CUtensorMap& mwh,
                    const CUtensorMap& mwl, const void* c2,
                    const void* skip_src, void* out, int M, int K, int N,
                    int smem, cudaStream_t s) {
  const int e = gemm_f32_regs_ok<FINAL>();
  if (e) return e;
  static int smem_set = 0;  // above 48 KB only after this attribute
  if (smem > smem_set) {
    const cudaError_t r = cudaFuncSetAttribute(
        gemm_f32_kernel<FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (r != cudaSuccess) return (int)r;
    smem_set = smem;
  }
  const dim3 grid((N + GBN - 1) / GBN, (M + FBM - 1) / FBM);
  gemm_f32_kernel<FINAL><<<grid, THREADS, smem, s>>>(
      ma, mwh, mwl, (const float*)c2, (const float*)skip_src, (float*)out, M,
      K, N);
  return (int)cudaGetLastError();
}

// The stencil's grid (ops/middle_flow.py dw_stencil_plan), or false when
// the shape is out of the kernel's range.
bool stencil_grid(int B, int H, int W, int C, int d, int rows, dim3* grid) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || d <= 0 || rows <= 0 ||
      (long long)B * H * W * C >= (1LL << 31) || B > 65535)
    return false;
  const int ctiles = (C / 8 + ST_CX - 1) / ST_CX;
  const int segs = ((H + d - 1) / d + rows - 1) / rows;
  *grid = dim3(ctiles * ((W + ST_WY - 1) / ST_WY), d * segs, B);
  return true;
}

// The f32 stencil's channel quads per block: the largest odd divisor of
// C / 4 up to SQ_MAX.
int stencil_f32_quads(int C) {
  int sq = 1;
  for (int q = 3; q <= SQ_MAX; q += 2)
    if ((C / 4) % q == 0) sq = q;
  return sq;
}

// The f32 stencil's grid and shared-memory bytes (ops/middle_flow.py
// dw_stencil_f32_plan), or false when the shape is out of its range.
bool stencil_f32_grid(int B, int H, int W, int C, int d, int rows, int sq,
                      dim3* grid, int* smem) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || d <= 0 || rows <= 0 ||
      SW + 2 * d > 256 || B > 65535)
    return false;
  const int segs = ((H + d - 1) / d + rows - 1) / rows;
  if ((long long)d * segs > 65535) return false;
  *grid = dim3(C / (4 * sq) * ((W + SW - 1) / SW), d * segs, B);
  *smem = StencilSmem(sq, d, rows).bytes;
  return *smem <= 232448;
}

}  // namespace

// The stencil: z (B, H, W, C) f32 or bf16 -> zb (B, H, W, C) bf16.  rows:
// the plan's output rows per thread (ops/middle_flow.py dw_stencil_plan).
extern "C" int mf_dw_stencil(const void* z, int z_is_f32, const void* wdw,
                             const void* s1, const void* c1, void* zb, int B,
                             int H, int W, int C, int d, int rows,
                             void* stream) {
  dim3 grid;
  if (!stencil_grid(B, H, W, C, d, rows, &grid))
    return (int)cudaErrorInvalidValue;
  const dim3 block(ST_CX, ST_WY);
  cudaStream_t s = (cudaStream_t)stream;
  if (z_is_f32)
    dw_stencil_kernel<float, bf16><<<grid, block, 0, s>>>(
        (const float*)z, (const bf16*)wdw, (const float*)s1, (const float*)c1,
        (bf16*)zb, H, W, C, d, rows);
  else
    dw_stencil_kernel<bf16, bf16><<<grid, block, 0, s>>>(
        (const bf16*)z, (const bf16*)wdw, (const float*)s1, (const float*)c1,
        (bf16*)zb, H, W, C, d, rows);
  return (int)cudaGetLastError();
}

// The stencil in f32: z (B, H, W, C) f32, f32 taps -> zb (B, H, W, C) f32.
// rows: the plan's output rows per block (dw_stencil_f32_plan).
extern "C" int mf_dw_stencil_f32(const void* z, const void* wdw,
                                 const void* s1, const void* c1, void* zb,
                                 int B, int H, int W, int C, int d, int rows,
                                 void* stream) {
  const int sq = stencil_f32_quads(C);
  dim3 grid;
  int smem;
  if (!stencil_f32_grid(B, H, W, C, d, rows, sq, &grid, &smem))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mz, mzb;
  int e = make_map_nhwc(&mz, z, B, H, W, C, 4 * sq, SW + 2 * d);
  if (!e) e = make_map_nhwc(&mzb, zb, B, H, W, C, 4 * sq, SW);
  if (e) return e;
  static int smem_set = 0;  // above 48 KB only after this attribute
  if (smem > smem_set) {
    const cudaError_t r = cudaFuncSetAttribute(
        dw_stencil_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (r != cudaSuccess) return (int)r;
    smem_set = smem;
  }
  dw_stencil_f32_kernel<<<grid, dim3(SW, sq), smem, (cudaStream_t)stream>>>(
      mz, mzb, (const float*)wdw, (const float*)s1, (const float*)c1, H, W, C,
      d, rows, sq);
  return (int)cudaGetLastError();
}

// The pointwise product: a (M, K) bf16 @ wt (N, K)^T + c2 -> f32, or bf16
// with relu(skip_src) added when skip_src (M, N) is given.  smem: the plan's
// shared-memory bytes.
extern "C" int mf_pw_gemm(const void* a, const void* wt, const void* c2,
                          const void* skip_src, void* out, int M, int K, int N,
                          int smem, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      smem < 1024 + GSTAGES * G_STAGE + 16 * GSTAGES)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  int e = make_map(&ma, a, M, K, GBM);
  if (!e) e = make_map(&mw, wt, N, K, GBN);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (skip_src)
    return launch_gemm<true>(ma, mw, c2, skip_src, out, M, K, N, smem, s);
  return launch_gemm<false>(ma, mw, c2, nullptr, out, M, K, N, smem, s);
}

// The pointwise product in f32: a (M, K) @ W + c2 -> f32 (M, N), with
// relu(skip_src) (M, N) f32 added when it is given; w_split (2, N, K): W^T's
// TF32 high and low parts (ops/middle_flow.py tf32_split).  smem: the plan's
// shared-memory bytes (pw_gemm_f32_plan).
extern "C" int mf_pw_gemm_f32(const void* a, const void* w_split,
                              const void* c2, const void* skip_src, void* out,
                              int M, int K, int N, int smem, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      (M + FBM - 1) / FBM > 65535 || smem < F_SMEM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mwh, mwl;
  int e = make_map_f32(&ma, a, M, K, FBM);
  if (!e) e = make_map_f32(&mwh, w_split, N, K, GBN);
  if (!e)
    e = make_map_f32(&mwl, (const float*)w_split + (size_t)N * K, N, K, GBN);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  if (skip_src)
    return launch_gemm_f32<true>(ma, mwh, mwl, c2, skip_src, out, M, K, N,
                                 smem, s);
  return launch_gemm_f32<false>(ma, mwh, mwl, c2, nullptr, out, M, K, N, smem,
                                s);
}

// The GEMM's split of x[0:n] f32 into hi and lo (as f32 bit patterns).
extern "C" int mf_tf32_split(const void* x, void* hi, void* lo, int n,
                             void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  tf32_split_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint32_t*)hi, (uint32_t*)lo, n);
  return (int)cudaGetLastError();
}

// Registers per thread ptxas gave the GEMM (final: the FINAL variant), or
// minus a CUDA error.
extern "C" int mf_pw_gemm_regs(int final) {
  cudaFuncAttributes a;
  const cudaError_t e = final
      ? cudaFuncGetAttributes(&a, gemm_kernel<true>)
      : cudaFuncGetAttributes(&a, gemm_kernel<false>);
  return e == cudaSuccess ? a.numRegs : -(int)e;
}

// The same for the f32 GEMM.
extern "C" int mf_pw_gemm_f32_regs(int final) {
  cudaFuncAttributes a;
  const cudaError_t e = final
      ? cudaFuncGetAttributes(&a, gemm_f32_kernel<true>)
      : cudaFuncGetAttributes(&a, gemm_f32_kernel<false>);
  return e == cudaSuccess ? a.numRegs : -(int)e;
}
