// Kernel B: fused 1x1 convolution + pixel shuffle, NHWC.
//
// Replaces vcm_ts_tpu/ops/subpel_pallas.py::_conv1x1_kernel (via
// _conv1x1_impl / subpel_conv1x1): out = pixel_shuffle(conv1x1(x, w, b), r)
// in torch channel order, with f32 accumulation, and the conv output never
// written to device memory.
//
// Inputs: x (M = N*H*W pixels, K = Cin) row-major (NHWC); weights k-major
// (r*r, Cin, C), bias (r*r, C); column j = (dy*r + dx)*C + c of the GEMM
// lands at out[n, h*r + dy, w*r + dx, c].
//
// What bounds it on H100: at the main path's widths (Cin 64-288, r*r*C up
// to 1152) a GEMM of M x K x 4C does 2*M*K*4C flops on (K + 4C) elements
// per pixel: 2*K*4C/(4*(K+4C)) flops per byte in f32, e.g. 25 for
// 64 -> 32 and 86 for 192 -> 192, so the small ones sit on the memory side
// of the f32 roofline and the wide ones near the f32 FMA rate (67 TFLOP/s
// without tensor cores).
//
// Design (simple first version): a 64-pixel x 64-column output tile per
// block of 256 threads, each thread a 4x4 register tile; Cin is read in
// 16-deep shared-memory tiles of x and of the weights; plain f32 FMA (no
// tensor cores: TF32 would break f32 parity, and bf16 data is widened to
// f32 on load). The epilogue adds the bias and stores every element
// straight to its shuffled NHWC position, so the pre-shuffle tensor never
// exists. Outputs narrower than the tile (C = 2 gives 8 columns) are
// masked. wgmma/TMA versions are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    subpel_conv1x1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ out, int M,
                          int K, int C, int r, int H, int W) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int ncol = r * r * C;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int l = tid; l < BM * BK; l += kThreads) {
      const int row = l / BK;
      const int kk = l - row * BK;
      const int m = m0 + row;
      const int k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? to_f(x[(long long)m * K + k]) : 0.0f;
    }
    for (int l = tid; l < BK * BN; l += kThreads) {
      const int kk = l / BN;
      const int col = l - kk * BN;
      const int j = n0 + col;
      const int k = k0 + kk;
      float v = 0.0f;
      if (j < ncol && k < K) {
        const int plane = j / C;
        const int c = j - plane * C;
        v = to_f(w[((long long)plane * K + k) * C + c]);
      }
      Bs[kk][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int hw = H * W;
  const long long Ho = (long long)H * r;
  const long long Wo = (long long)W * r;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int n = m / hw;
    const int rem = m - n * hw;
    const int h = rem / W;
    const int wv = rem - h * W;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= ncol) continue;
      const int plane = col / C;
      const int c = col - plane * C;
      const int dy = plane / r;
      const int dx = plane - dy * r;
      const long long o =
          (((long long)n * Ho + (long long)h * r + dy) * Wo +
           (long long)wv * r + dx) * C + c;
      out[o] = from_f<T>(__fadd_rn(acc[i][j], to_f(b[col])));
    }
  }
}

}  // namespace

// x: (N, H, W, K) NHWC; w: (r*r, K, C); b: (r*r, C); out: (N, H*r, W*r, C)
// NHWC; all one dtype (0: float32, 1: bfloat16). Returns the cudaError_t of
// the launch.
extern "C" int vcm_subpel_conv1x1(const void* x, const void* w, const void* b,
                                  void* out, int N, int H, int W, int K, int C,
                                  int r, int dtype, void* stream) {
  const long long M = (long long)N * H * W;
  if ((dtype != 0 && dtype != 1) || M >= (1LL << 31) || K < 1 || C < 1 ||
      r < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  const int ncol = r * r * C;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((ncol + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    subpel_conv1x1_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), (int)M, K, C,
        r, H, W);
  } else {
    subpel_conv1x1_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), (int)M, K, C, r, H, W);
  }
  return (int)cudaGetLastError();
}
