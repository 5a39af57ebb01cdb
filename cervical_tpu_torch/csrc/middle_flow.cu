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
// by operations.
//
// What the design does about it.  The TPU kernel keeps one image's
// (32, 32, 728) activation in VMEM across all 16 blocks on a sequential
// (batch, block) grid.  On Hopper that activation is 1.49 MB in bf16 against
// 227 KB of shared memory per block, and CUDA blocks run in no order, so the
// block axis becomes a host loop and each separable conv is two launches:
//   * mf_dw_stencil: ReLU + 9 zero-padded taps in f32 + BN1 affine, writing
//     zb in bf16 as [M, C] rows (memory-bound; eight channels per thread,
//     16-byte loads and stores);
//   * mf_pw_gemm: zb @ wpw on the tensor cores (WMMA bf16, f32 accumulate),
//     128x128x32 tiles, cp.async double buffering.  The epilogue adds the
//     BN2 shift and, at a block's third conv, relu(block input) recomputed in
//     f32, then rounds to bf16.
// Between the three convs of a block z stays f32 (the GEMM writes f32); only
// zb and the block output are rounded to bf16, as in the TPU kernel.  The
// activation crosses device memory between launches; at batch 8 it mostly
// stays in the 50 MB L2.  C = 728 is not a multiple of the 16-wide MMA
// tiles: cp.async zero-fills the ragged K and N chunks (C must be a multiple
// of 8, so a 16-byte chunk is either wholly inside or wholly outside), and
// the epilogue masks rows and columns.  Every pointer is 16-byte aligned
// (checked by the wrappers).  Layout is NHWC ([M, C] row-major);
// the model runs channels_last so blocks 4-19 see it without a copy.
//
// Both entry points take a plain C interface (pointers and the stream as
// void*), launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

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

// zb[n,h,w,c] = bf16((sum_t relu(z[n, h+dy*d, w+dx*d, c]) * wdw[t, c]) * s1[c] + c1[c])
// with t = (dy+1)*3 + (dx+1), taps summed in the order of the reference and
// no fused multiply-add, so it matches the plain version bit for bit.  One
// thread computes eight consecutive channels of one pixel.
template <typename T>
__global__ void dw_stencil_kernel(const T* __restrict__ z,
                                  const bf16* __restrict__ wdw,
                                  const float* __restrict__ s1,
                                  const float* __restrict__ c1,
                                  bf16* __restrict__ zb, int B, int H, int W,
                                  int C, int d) {
  const int C8 = C / 8;
  const long long total = (long long)B * H * W * C8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C8) * 8;
  const long long p = idx / C8;
  const int w = (int)(p % W);
  const long long q = p / W;
  const int h = (int)(q % H);
  const long long n = q / H;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int hh = h + dy * d, ww = w + dx * d;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        load8(z + ((n * H + hh) * W + ww) * C + c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j], 0.f);
      }
      float wt[8];
      load8(wdw + ((dy + 1) * 3 + (dx + 1)) * C + c, wt);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wt[j]));
    }
  }
  float sc[8], sh[8];
  load8(s1 + c, sc);
  load8(c1 + c, sh);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(acc[2 * j], sc[2 * j]), sh[2 * j]),
        __fadd_rn(__fmul_rn(acc[2 * j + 1], sc[2 * j + 1]), sh[2 * j + 1]));
  *reinterpret_cast<uint4*>(zb + p * C + c) = out;
}

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;   // padded smem row (bf16): conflict-free ldmatrix
constexpr int LDB = BN + 8;
constexpr int LDS = 16 + 4;   // per-warp f32 epilogue tile row
constexpr int THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64x32 outputs each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_size = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[m, n] = sum_k A[m, k] * Wt[k, n] + c2[n]            (FINAL = false, f32)
// out[m, n] = bf16(that + relu(skip_src[m, n]))           (FINAL = true)
template <bool FINAL>
__global__ void __launch_bounds__(THREADS)
    pw_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                   const float* __restrict__ c2,
                   const bf16* __restrict__ skip_src, float* __restrict__ out_f32,
                   bf16* __restrict__ out_bf16, int M, int K, int N) {
  __shared__ __align__(128) bf16 sA[2][BM * LDA];
  __shared__ __align__(128) bf16 sB[2][BK * LDB];
  __shared__ __align__(128) float sC[THREADS / 32][16 * LDS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int stage, int k0) {
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), ch = i % (BK / 8);
      const int gm = m0 + r, gk = k0 + ch * 8;
      const bool ok = gm < M && gk < K;
      cp_async16(&sA[stage][r * LDA + ch * 8],
                 ok ? A + (long long)gm * K + gk : A, ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), ch = i % (BN / 8);
      const int gk = k0 + r, gn = n0 + ch * 8;
      const bool ok = gk < K && gn < N;
      cp_async16(&sB[stage][r * LDB + ch * 8],
                 ok ? Wt + (long long)gk * N + gn : Wt, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = sA[kt & 1];
    const bf16* b = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = sC[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], LDS, wmma::mem_row_major);
      __syncwarp();
      const int rb = m0 + wm * 64 + i * 16, cb = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, cc = e % 16;
        const int gm = rb + r, gn = cb + cc;
        if (gm < M && gn < N) {
          const long long o = (long long)gm * N + gn;
          float v = __fadd_rn(st[r * LDS + cc], c2[gn]);
          if (FINAL) {
            v = __fadd_rn(v, fmaxf(__bfloat162float(skip_src[o]), 0.f));
            out_bf16[o] = __float2bfloat16_rn(v);
          } else {
            out_f32[o] = v;
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int mf_dw_stencil(const void* z, int z_is_f32, const void* wdw,
                             const void* s1, const void* c1, void* zb, int B,
                             int H, int W, int C, int d, void* stream) {
  const long long total = (long long)B * H * W * (C / 8);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (z_is_f32)
    dw_stencil_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)z, (const bf16*)wdw, (const float*)s1, (const float*)c1,
        (bf16*)zb, B, H, W, C, d);
  else
    dw_stencil_kernel<bf16><<<blocks, threads, 0, s>>>(
        (const bf16*)z, (const bf16*)wdw, (const float*)s1, (const float*)c1,
        (bf16*)zb, B, H, W, C, d);
  return (int)cudaGetLastError();
}

// skip_src == NULL: out is f32 [M, N]; otherwise out is bf16 [M, N] and
// skip_src the bf16 block input [M, N].
extern "C" int mf_pw_gemm(const void* a, const void* w, const void* c2,
                          const void* skip_src, void* out, int M, int K, int N,
                          void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (skip_src)
    pw_gemm_kernel<true><<<grid, THREADS, 0, s>>>(
        (const bf16*)a, (const bf16*)w, (const float*)c2,
        (const bf16*)skip_src, nullptr, (bf16*)out, M, K, N);
  else
    pw_gemm_kernel<false><<<grid, THREADS, 0, s>>>(
        (const bf16*)a, (const bf16*)w, (const float*)c2, nullptr,
        (float*)out, nullptr, M, K, N);
  return (int)cudaGetLastError();
}
