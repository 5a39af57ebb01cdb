// A timing variant of mf_dw_stencil_f32 for scripts/torch_k4_variants.py:
// the earlier f32 stencil, csrc/middle_flow.cu's rolling-row kernel
// instantiated for f32 (a thread: 8 channels of one column, `rows` output
// rows of one residue of h mod d, three running sums), with two changes
// against its measured leads (PERF.md): __launch_bounds__(256, 2) in
// place of (256, 3), so ptxas may use 128 registers where the (256, 3)
// instance spilled 16 bytes at its cap of 85, and the next
// input row loaded into registers before the current row's taps, so each
// thread has two rows in flight.  Same operations in the same order
// without FMA: bit-identical to dw_stencil_reference.  Same C interface
// as csrc/middle_flow.cu's mf_dw_stencil_f32 (rows: per thread); built
// with the package's nvcc flags (ops/_build.NVCC_FLAGS).

#include <cuda_runtime.h>

namespace {

constexpr int ST_CX = 8;
constexpr int ST_WY = 32;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_tap(const float* p, float v[8]) {
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "l"(p));
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
               : "l"(p + 4));
}

// raw z[n, h, w + (dx - 1) d, c:c+8] for dx = 0, 1, 2 (not yet relu'd);
// zeros outside the image
__device__ __forceinline__ void fetch_row(const float* __restrict__ z,
                                          float v[3][8], int n, int h, int w,
                                          int H, int W, int C, int c, int d) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int ww = w + (dx - 1) * d;
    if (h >= 0 && h < H && ww >= 0 && ww < W) {
      load8(z + ((n * H + h) * W + ww) * C + c, v[dx]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[dx][j] = 0.f;
    }
  }
}

__device__ __forceinline__ void take_row(float v[3][8], const float nx[3][8]) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int j = 0; j < 8; ++j) v[dx][j] = fmaxf(nx[dx][j], 0.f);
}

__device__ __forceinline__ void add_taps(float acc[8], const float v[3][8],
                                         const float* __restrict__ wdw,
                                         int ky, int C, int c) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float wt[8];
    load_tap(wdw + (ky * 3 + dx) * C + c, wt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(v[dx][j], wt[j]));
  }
}

__global__ void __launch_bounds__(ST_CX * ST_WY, 2)
    rolling_kernel(const float* __restrict__ z, const float* __restrict__ wdw,
                   const float* __restrict__ s1, const float* __restrict__ c1,
                   float* __restrict__ zb, int H, int W, int C, int d,
                   int rows) {
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
  float v[3][8], nx[3][8], close[8], cont[8];
  const int h0 = r + t0 * d;
#pragma unroll
  for (int j = 0; j < 8; ++j) close[j] = 0.f;
  fetch_row(z, nx, n, h0 - d, w, H, W, C, c, d);
  take_row(v, nx);
  fetch_row(z, nx, n, h0, w, H, W, C, c, d);
  add_taps(close, v, wdw, 0, C, c);
  take_row(v, nx);
  fetch_row(z, nx, n, h0 + d, w, H, W, C, c, d);  // in flight
  add_taps(close, v, wdw, 1, C, c);
#pragma unroll
  for (int j = 0; j < 8; ++j) cont[j] = 0.f;
  add_taps(cont, v, wdw, 0, C, c);
  for (int t = t0; t < t1; ++t) {
    const int h = r + t * d;
    take_row(v, nx);
    if (t + 1 < t1) fetch_row(z, nx, n, h + 2 * d, w, H, W, C, c, d);
    add_taps(close, v, wdw, 2, C, c);
    float sc[8], sh[8], o[8];
    load8(s1 + c, sc);
    load8(c1 + c, sh);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = __fadd_rn(__fmul_rn(close[j], sc[j]), sh[j]);
    float* p = zb + ((n * H + h) * W + w) * C + c;
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
    if (t + 1 == t1) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) close[j] = cont[j];
    add_taps(close, v, wdw, 1, C, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) cont[j] = 0.f;
    add_taps(cont, v, wdw, 0, C, c);
  }
}

}  // namespace

extern "C" int mf_dw_stencil_f32(const void* z, const void* wdw,
                                 const void* s1, const void* c1, void* zb,
                                 int B, int H, int W, int C, int d, int rows,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || d <= 0 || rows <= 0 ||
      (long long)B * H * W * C >= (1LL << 31) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int ctiles = (C / 8 + ST_CX - 1) / ST_CX;
  const int segs = ((H + d - 1) / d + rows - 1) / rows;
  const dim3 grid(ctiles * ((W + ST_WY - 1) / ST_WY), d * segs, B);
  rolling_kernel<<<grid, dim3(ST_CX, ST_WY), 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)wdw, (const float*)s1, (const float*)c1,
      (float*)zb, H, W, C, d, rows);
  return (int)cudaGetLastError();
}
