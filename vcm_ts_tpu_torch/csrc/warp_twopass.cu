// Kernel D: two-pass separable bilinear backward warp over NHWC tensors,
// displacement clamped to +-D (the DMC's opt-in fast_warp).
//
// Replaces vcm_ts_tpu/ops/warp_pallas.py:35 (_warp_kernel, reached through
// flow_warp_pallas:88). The TPU kernel sums one-hot shifted copies of a
// VMEM row band, because Mosaic cannot gather; a GPU gathers natively, so
// here each output pixel reads its four taps directly.
//
// Semantics (warp_pallas.py:50-83), all in f32 whatever the data type, for
// output pixel (y, x):
//   px = clip(x + fx(y,x), 0, W-1), x0 = floor(px), wx = px - x0,
//   dx = clip(x0 - x, -D, D), xa = x + dx, xb = xa + 1;
//   for each column c in {xa, xb}, with the flow AT THAT COLUMN:
//   py = clip(y + fy(y,c), 0, H-1), y0 = floor(py), wy = py - y0,
//   dy = clip(y0 - y, -D, D), v(c) = lo + wy (hi - lo), lo/hi the rows
//   y+dy and y+dy+1 at column c;
//   out = v(xa) + wx (v(xb) - v(xa)).
// xa and y+dy always lie inside the image. Column xb can be W, and row
// y+dy+1 can be H, only where the weight that multiplies them is 0; the
// kernel clamps those indices into the image, which (weight 0, finite
// data) leaves the result equal to v(xa) or lo, as the TPU kernel's zero
// padding does.
//
// Row window (spatial sharding, parallel/spatial.py), as kernel A's: the
// flow and the output hold Hl rows, rows [row0, row0 + Hl) of a frame
// whose image holds all H rows; y above is the image row row0 + (the
// window's row), and the window's output is bit for bit those rows of the
// whole warp. row0 = 0 and Hl = H is the whole warp.
//
// What bounds it on H100: bytes. Per output element it does 9 flops on 4
// neighbour reads, and the neighbours of neighbouring pixels overlap in
// L1/L2, so device memory sees about one read of the source, one read of
// the flow and one write of the output (2 x 535 MB + 16.7 MB for 64
// channels f32 at 1088x1920), far below the f32 rate; the same traffic as
// kernel A (csrc/warp.cu).
//
// Design, as kernel A's: a block owns 64 consecutive pixels. First, one
// thread per pixel computes both columns' clamped coordinates and the
// three weights once and keeps four tap offsets and three weights in
// shared memory. Then all 256 threads walk the block's (pixel,
// channel-chunk) items, so adjacent threads read adjacent 16-byte chunks
// of one neighbour pixel (coalesced). Chunks are 16-byte vectors where the
// channel count and the pointers allow, single elements otherwise (the
// 3-channel frame). The lerps use __fmul_rn / __fadd_rn / __fsub_rn so
// that nvcc cannot contract them into FMAs: every op rounds as in the
// plain PyTorch version (ops/warp_twopass.py), and the two agree bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPix = 64;
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

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// a + w (b - a), each op rounded
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(w, __fsub_rn(b, a)));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

template <typename T, int V>
__device__ __forceinline__ void warp_item(const T* __restrict__ src,
                                          T* __restrict__ dst, int c, int k,
                                          const int* q, long long p,
                                          const float* w) {
  using VT = Vec<T, V>;
  const long long off = (long long)k * V;
  const VT a0 = *reinterpret_cast<const VT*>(src + (long long)q[0] * c + off);
  const VT a1 = *reinterpret_cast<const VT*>(src + (long long)q[1] * c + off);
  const VT b0 = *reinterpret_cast<const VT*>(src + (long long)q[2] * c + off);
  const VT b1 = *reinterpret_cast<const VT*>(src + (long long)q[3] * c + off);
  VT o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float va = lerp(to_f(a0.v[i]), to_f(a1.v[i]), w[0]);
    const float vb = lerp(to_f(b0.v[i]), to_f(b1.v[i]), w[1]);
    o.v[i] = from_f<T>(lerp(va, vb, w[2]));
  }
  *reinterpret_cast<VT*>(dst + p * c + off) = o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_twopass_kernel(const T* __restrict__ src, T* __restrict__ dst,
                        const float* __restrict__ flow, int c, int vec,
                        int Hl, int H, int W, int row0, int D,
                        long long npix) {
  __shared__ int s_q[kPix][4];
  __shared__ float s_w[kPix][3];
  const long long p0 = (long long)blockIdx.x * kPix;
  const int t = threadIdx.x;
  if (t < kPix && p0 + t < npix) {
    const long long p = p0 + t;  // output and flow pixel
    const long long hw = (long long)Hl * W;
    const long long n = p / hw;
    const int rem = (int)(p - n * hw);
    const int yl = rem / W;
    const int x = rem - yl * W;
    const int y = row0 + yl;  // the image row
    const float fd = (float)D;
    const float px =
        clampf(__fadd_rn((float)x, flow[2 * p]), 0.0f, (float)(W - 1));
    const float fx0 = floorf(px);
    const int xa = x + (int)clampf(fx0 - (float)x, -fd, fd);
    const int xb = min(xa + 1, W - 1);
    const int base = (int)(n * H * W);
    const int cols[2] = {xa, xb};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long pc = n * hw + (long long)yl * W + cols[j];
      const float py = clampf(__fadd_rn((float)y, flow[2 * pc + 1]), 0.0f,
                              (float)(H - 1));
      const float fy0 = floorf(py);
      const int r = y + (int)clampf(fy0 - (float)y, -fd, fd);
      s_q[t][2 * j] = base + r * W + cols[j];
      s_q[t][2 * j + 1] = base + min(r + 1, H - 1) * W + cols[j];
      s_w[t][j] = __fsub_rn(py, fy0);
    }
    s_w[t][2] = __fsub_rn(px, fx0);
  }
  __syncthreads();
  const long long left = npix - p0;
  const int npb = left < kPix ? (int)left : kPix;
  const int items = c / vec;
  const int work = npb * items;
  for (int i = t; i < work; i += kThreads) {
    const int lp = i / items;
    const int k = i - lp * items;
    if (vec == 1) {
      warp_item<T, 1>(src, dst, c, k, s_q[lp], p0 + lp, s_w[lp]);
    } else {
      warp_item<T, 16 / sizeof(T)>(src, dst, c, k, s_q[lp], p0 + lp,
                                   s_w[lp]);
    }
  }
}

}  // namespace

// src: NHWC (N, H, W, C), one dtype with dst (0: float32, 1: bfloat16);
// flow: float32 (N, Hl, W, 2), x then y, and dst (N, Hl, W, C): rows
// [row0, row0 + Hl) of the warp (row0 = 0, Hl = H: the whole warp); D >= 0
// the displacement bound. Returns the cudaError_t of the launch.
extern "C" int vcm_warp_twopass(const void* src, void* dst, int C,
                                const float* flow, int N, int H, int W,
                                int Hl, int row0, int D, int dtype,
                                void* stream) {
  if ((dtype != 0 && dtype != 1) || C < 1 || D < 0 || Hl < 0 || row0 < 0 ||
      row0 + Hl > H || (long long)N * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long npix = (long long)N * Hl * W;
  if (npix == 0) return 0;
  const int vmax = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const bool aligned =
      ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  const int vec = (C % vmax == 0 && aligned) ? vmax : 1;
  const unsigned blocks = (unsigned)((npix + kPix - 1) / kPix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    warp_twopass_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), flow, C, vec,
        Hl, H, W, row0, D, npix);
  } else {
    warp_twopass_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src),
        static_cast<__nv_bfloat16*>(dst), flow, C, vec, Hl, H, W, row0, D,
        npix);
  }
  return (int)cudaGetLastError();
}
