// Kernel A: exact bilinear backward warp over NHWC tensors.
//
// Replaces vcm_ts_tpu/ops/warp.py::_warp_one_gather (flow_warp and
// flow_warp_packed). On the TPU that stayed an XLA gather, because Mosaic
// has no gather; a GPU gathers natively.
//
// Semantics (warp.py:31-46, 75-76): coordinates x + u, y + v in f32 (even
// for bf16 data: bf16 cannot hold pixel indices above 256), clamped to
// [0, W-1] x [0, H-1] BEFORE the floor, edge-padded taps, and the lerp
// ((v00(1-wx) + v01 wx)(1-wy) + (v10(1-wx) + v11 wx) wy) in f32.
//
// What bounds it on H100: bytes. Per output element it does 8 flops on 4
// neighbour reads; the neighbours of neighbouring pixels overlap and stay in
// L1/L2, so device memory sees about one read of the source and one write of
// the output (2 x 560 MB for the 67-channel f32 call at 1088x1920), far
// below the f32 rate.
//
// Design: a block owns 64 consecutive pixels. First, one thread per pixel
// computes the clamped coordinates and weights once and keeps the four tap
// offsets and the two weights in shared memory. Then all 256 threads walk
// the (pixel, channel-chunk) items of every tensor in the list, so adjacent
// threads read adjacent 16-byte chunks of the same neighbour pixel
// (coalesced) whatever the channel count, and several tensors that share a
// flow (the packed call) share the coordinate pass without being
// concatenated. Chunks are 16-byte vectors where the channel count and the
// pointers allow, single elements otherwise (the 3-channel frame). The lerp
// uses __fmul_rn / __fadd_rn so that nvcc cannot contract it into FMAs: every
// op rounds as in the plain PyTorch version, which makes the two agree bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 4;
constexpr int kPix = 64;
constexpr int kThreads = 256;

struct WarpList {
  const void* src[kMaxTensors];
  void* dst[kMaxTensors];
  int c[kMaxTensors];      // channels of tensor j
  int vec[kMaxTensors];    // elements per item: a 16-byte vector or 1
  int items[kMaxTensors];  // items per pixel: c / vec
  int n;
  int items_total;
};

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

__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float wx, float wy) {
  const float ox = __fsub_rn(1.0f, wx);
  const float oy = __fsub_rn(1.0f, wy);
  const float top = __fadd_rn(__fmul_rn(v00, ox), __fmul_rn(v01, wx));
  const float bot = __fadd_rn(__fmul_rn(v10, ox), __fmul_rn(v11, wx));
  return __fadd_rn(__fmul_rn(top, oy), __fmul_rn(bot, wy));
}

template <typename T, int V>
__device__ __forceinline__ void warp_item(const T* __restrict__ src,
                                          T* __restrict__ dst, int c, int k,
                                          const int* q, long long p,
                                          float wx, float wy) {
  using VT = Vec<T, V>;
  const long long off = (long long)k * V;
  const VT a = *reinterpret_cast<const VT*>(src + (long long)q[0] * c + off);
  const VT b = *reinterpret_cast<const VT*>(src + (long long)q[1] * c + off);
  const VT d = *reinterpret_cast<const VT*>(src + (long long)q[2] * c + off);
  const VT e = *reinterpret_cast<const VT*>(src + (long long)q[3] * c + off);
  VT o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    o.v[i] = from_f<T>(lerp4(to_f(a.v[i]), to_f(b.v[i]), to_f(d.v[i]),
                             to_f(e.v[i]), wx, wy));
  }
  *reinterpret_cast<VT*>(dst + p * c + off) = o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(WarpList L, const float* __restrict__ flow, int H, int W,
                long long npix) {
  __shared__ int s_q[kPix][4];
  __shared__ float s_w[kPix][2];
  const long long p0 = (long long)blockIdx.x * kPix;
  const int t = threadIdx.x;
  if (t < kPix && p0 + t < npix) {
    const long long p = p0 + t;
    const long long hw = (long long)H * W;
    const long long n = p / hw;
    const int rem = (int)(p - n * hw);
    const int y = rem / W;
    const int x = rem - y * W;
    const float px =
        fminf(fmaxf(__fadd_rn((float)x, flow[2 * p]), 0.0f), (float)(W - 1));
    const float py = fminf(fmaxf(__fadd_rn((float)y, flow[2 * p + 1]), 0.0f),
                           (float)(H - 1));
    const float fx0 = floorf(px);
    const float fy0 = floorf(py);
    const int x0 = (int)fx0;
    const int y0 = (int)fy0;
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    const int base = (int)(n * hw);
    s_q[t][0] = base + y0 * W + x0;
    s_q[t][1] = base + y0 * W + x1;
    s_q[t][2] = base + y1 * W + x0;
    s_q[t][3] = base + y1 * W + x1;
    s_w[t][0] = __fsub_rn(px, fx0);
    s_w[t][1] = __fsub_rn(py, fy0);
  }
  __syncthreads();
  const long long left = npix - p0;
  const int npb = left < kPix ? (int)left : kPix;
  const int work = npb * L.items_total;
  for (int i = t; i < work; i += kThreads) {
    const int lp = i / L.items_total;
    int k = i - lp * L.items_total;
    int j = 0;
    while (k >= L.items[j]) {
      k -= L.items[j];
      ++j;
    }
    const T* src = static_cast<const T*>(L.src[j]);
    T* dst = static_cast<T*>(L.dst[j]);
    if (L.vec[j] == 1) {
      warp_item<T, 1>(src, dst, L.c[j], k, s_q[lp], p0 + lp, s_w[lp][0],
                      s_w[lp][1]);
    } else {
      warp_item<T, 16 / sizeof(T)>(src, dst, L.c[j], k, s_q[lp], p0 + lp,
                                   s_w[lp][0], s_w[lp][1]);
    }
  }
}

}  // namespace

// src/dst: n_tensors NHWC tensors of shape (N, H, W, c[j]), one dtype
// (0: float32, 1: bfloat16); flow: float32 (N, H, W, 2), x then y.
// Returns the cudaError_t of the launch.
extern "C" int vcm_warp(const void* const* src, void* const* dst,
                        const int* c, int n_tensors, const float* flow, int N,
                        int H, int W, int dtype, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || (dtype != 0 && dtype != 1) ||
      (long long)N * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  WarpList L = {};
  const int vmax = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  L.n = n_tensors;
  for (int j = 0; j < n_tensors; ++j) {
    L.src[j] = src[j];
    L.dst[j] = dst[j];
    L.c[j] = c[j];
    const bool aligned = ((uintptr_t)src[j] % 16 == 0) &&
                         ((uintptr_t)dst[j] % 16 == 0);
    L.vec[j] = (c[j] % vmax == 0 && aligned) ? vmax : 1;
    L.items[j] = c[j] / L.vec[j];
    L.items_total += L.items[j];
  }
  const long long npix = (long long)N * H * W;
  if (npix == 0) return 0;
  const unsigned blocks = (unsigned)((npix + kPix - 1) / kPix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    warp_kernel<float><<<blocks, kThreads, 0, s>>>(L, flow, H, W, npix);
  } else {
    warp_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(L, flow, H, W,
                                                          npix);
  }
  return (int)cudaGetLastError();
}
