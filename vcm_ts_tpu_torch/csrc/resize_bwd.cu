// Kernel E': the backward of the bilinear resize (half-pixel centers,
// align_corners=False, no antialias), NHWC, deterministic.
//
// Replaces no TPU kernel. The JAX package resizes with jax.image.resize,
// a dense einsum of the input with one weight matrix per axis; its VJP is
// the transposed einsum, d x = Ry^T . g . Rx, a fixed order. PyTorch's
// CUDA backward of F.interpolate adds each output's four shares into the
// input with atomics, in an order that changes from run to run, so a
// train step through SpyNet's flow upsampling (ops/resize.py bilinear_up2),
// the DMC's 0.5x resize (bilinear_down2) and the perceptual loss's resize
// to 224 did not repeat bit for bit. This kernel is that VJP as a gather:
// the resize is separable and each output row (column) takes its two taps
// from input rows i0 = floor(s), i1 = min(i0 + 1, in - 1), s = max(scale
// (o + 0.5) - 0.5, 0), scale = in / out (PyTorch's
// area_pixel_compute_source_index), so the output rows that take input
// row i form one short window around (i + 0.5) out / in. One thread owns
// one input element (n, i, j, c), tests each output row of its window for
// a tap on i, and sums, in f32 and in this fixed order, over the output
// rows o ascending: wy(o) x (the sum over the output columns p ascending
// of wx(p) g[o, p]); it writes the element once, in the data's dtype. The
// weights are rounded as the forward's (__fmul_rn etc., no FMA), and a
// tap that lands on i twice (i0 == i1 at the last row) takes l0 + l1.
// float64 data (the perceptual losses' float64 gradient checks) sums and
// computes its taps in f64, as its forward does.
//
// What bounds it on H100: bytes (g read once, d x written once); the
// window tests are a few dozen flops an element. Threads run along the
// channels (NHWC), so a warp's reads of g are contiguous for C >= 32 and
// gather a few pixels' channels for the 2- and 3-channel tensors it
// meets in training (flows, frames).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the sums' type: f32, f64 for f64 data (the float64 gradient checks of
// the perceptual losses), whose forward computes its taps in f64 too
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double to_acc(double v) { return v; }
template <typename T, typename A>
__device__ __forceinline__ T from_acc(A v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16(v);
}

// the weight of input index i in output o's two taps; false: no tap on i
template <typename A>
__device__ __forceinline__ bool tap(A scale, int o, int i, int n_in, A& w) {
  A s = sub(mul(scale, add((A)o, (A)0.5)), (A)0.5);
  s = s > (A)0 ? s : (A)0;
  const int i0 = (int)s;
  const int i1 = i0 < n_in - 1 ? i0 + 1 : i0;
  const A l1 = sub(s, (A)i0);
  const A l0 = sub((A)1, l1);
  if (i0 == i) {
    w = i1 == i ? add(l0, l1) : l0;
    return true;
  }
  if (i1 == i) {
    w = l1;
    return true;
  }
  return false;
}

// the output indices [lo, hi] that may take input index i (a slack of one
// each side around the exact window; tap() decides)
__device__ __forceinline__ void window(double scale, int i, int n_out,
                                       int& lo, int& hi) {
  lo = max(0, (int)floor((i - 0.5) / scale - 0.5) - 1);
  hi = min(n_out - 1, (int)ceil((i + 1.5) / scale - 0.5) + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    resize_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int N,
                      int C, int h_in, int w_in, int h_out, int w_out) {
  using A = typename Acc<T>::type;
  const long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long total = (long long)N * h_in * w_in * C;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  long long t = idx / C;
  const int j = (int)(t % w_in);
  t /= w_in;
  const int i = (int)(t % h_in);
  const int n = (int)(t / h_in);
  // PyTorch's scale: in / out in the forward's accumulation type
  const A sh = (A)h_in / (A)h_out, sw = (A)w_in / (A)w_out;
  int ylo, yhi, xlo, xhi;
  window(sh, i, h_out, ylo, yhi);
  window(sw, j, w_out, xlo, xhi);
  A acc = 0;
  for (int o = ylo; o <= yhi; ++o) {
    A wy;
    if (!tap(sh, o, i, h_in, wy)) continue;
    const T* row = g + ((long long)n * h_out + o) * w_out * C + c;
    A sum = 0;
    for (int p = xlo; p <= xhi; ++p) {
      A wx;
      if (!tap(sw, p, j, w_in, wx)) continue;
      sum = add(sum, mul(wx, to_acc(row[(long long)p * C])));
    }
    acc = add(acc, mul(wy, sum));
  }
  dx[idx] = from_acc<T>(acc);
}

}  // namespace

// g: (N, h_out, w_out, C) NHWC-dense; dx: (N, h_in, w_in, C), every element
// written. dtype: 0 float32, 1 bfloat16, 2 float64. Returns the launch's
// cudaError_t.
extern "C" int vcm_resize_bwd(const void* g, void* dx, int N, int C, int h_in,
                              int w_in, int h_out, int w_out, int dtype,
                              void* stream) {
  if (dtype < 0 || dtype > 2 || N < 0 || C < 1 || h_in < 1 || w_in < 1 ||
      h_out < 1 || w_out < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)N * h_in * w_in * C;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    resize_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<float*>(dx), N, C, h_in,
        w_in, h_out, w_out);
  } else if (dtype == 1) {
    resize_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), N, C, h_in, w_in, h_out, w_out);
  } else {
    resize_bwd_kernel<double><<<blocks, kThreads, 0, s>>>(
        static_cast<const double*>(g), static_cast<double*>(dx), N, C, h_in,
        w_in, h_out, w_out);
  }
  return (int)cudaGetLastError();
}
