// Kernel A': the backward of the exact bilinear warp (kernel A), NHWC.
//
// Replaces what XLA's autodiff makes of vcm_ts_tpu/ops/warp.py
// (_clamped_coords + _warp_one_gather, :31-79), the gradient of
// flow_warp / flow_warp_packed in every training step. Given the output
// gradients g_j of the packed tensors im_j and their shared flow:
//   d im_j: g x each of the four bilinear tap weights, scatter-added into
//           the four taps (the edge pad's adjoint lands on the border
//           pixel itself, since x1 = min(x0 + 1, W - 1));
//   d flow: per pixel, sum over every channel of every tensor of
//           g . d out / d(px, py), times the gradient of jnp.clip, which is
//           max-then-min: 1 inside, 0 outside, 0.5 from a bound that
//           x + u (or y + v) equals exactly; floor passes no gradient.
// Coordinates are f32 for bf16 data too, as in the forward.
//
// What bounds it on H100: bytes. Per pixel it reads g and the four taps
// of every channel (the taps mostly from L1/L2, as in the forward) and
// adds four values per channel into d im. The adds are f32 atomics
// (red.global.add): neighbouring pixels share taps, and a gather's adjoint
// has no owner per output. Their order changes from run to run, so d im
// is NOT deterministic: it agrees with the plain version (a sequential
// index_add_) to f32 rounding of the sums. For bf16 data d im accumulates
// in an f32 buffer that the wrapper casts once. d flow is deterministic:
// each lane sums its channels in order, then a fixed shuffle tree.
//
// Design: a group of G lanes (a power of two <= 32, inside one warp) per
// pixel; lane l takes channels l, l+G, ... of each tensor, so loads and
// atomics of a group touch consecutive addresses. Every product is rounded
// as in the plain version (__fmul_rn etc., no FMA contraction), so each
// single contribution to d im equals the plain one bit for bit and only
// the order of the sums differs. When no tensor needs d im the atomics
// are skipped (need_im = 0): the SpyNet warps of a reference frame that
// takes no gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 4;  // as csrc/warp.cu
constexpr int kThreads = 256;

struct BwdList {
  const void* src[kMaxTensors];
  const void* grad[kMaxTensors];
  float* dsrc[kMaxTensors];  // f32 accumulators (null when need_im == 0)
  int c[kMaxTensors];
  int n;
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

// d clip(v, 0, hi) / dv, jnp.clip's rule: maximum(v, 0) then minimum(., hi),
// each giving 0.5 at a tie.
__device__ __forceinline__ float clip_grad(float v, float hi) {
  const float lo = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  const float u = fmaxf(v, 0.0f);
  return lo * (u < hi ? 1.0f : (u == hi ? 0.5f : 0.0f));
}

template <typename T, typename TF, int G>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_kernel(BwdList L, const TF* __restrict__ flow,
                    TF* __restrict__ dflow, int npix, int H, int W,
                    int need_im) {
  const int lane = threadIdx.x % G;
  const int p0 = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool ok = p0 < npix;
  // out-of-range groups run on pixel npix-1 and store nothing, so that
  // every lane of the warp reaches the shuffles
  const int p = ok ? p0 : npix - 1;
  const int hw = H * W;
  const int plane = (p / hw) * hw;
  const int y = (p - plane) / W;
  const int x = p - plane - y * W;
  const TF* f = flow + 2 * (long long)p;
  const float vx = __fadd_rn((float)x, to_f(f[0]));
  const float vy = __fadd_rn((float)y, to_f(f[1]));
  const float px = fminf(fmaxf(vx, 0.0f), (float)(W - 1));
  const float py = fminf(fmaxf(vy, 0.0f), (float)(H - 1));
  const float fx0 = floorf(px);
  const float fy0 = floorf(py);
  const int x0 = (int)fx0;
  const int y0 = (int)fy0;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const long long t00 = plane + y0 * W + x0;
  const long long t01 = plane + y0 * W + x1;
  const long long t10 = plane + y1 * W + x0;
  const long long t11 = plane + y1 * W + x1;
  const float wx = __fsub_rn(px, fx0);
  const float wy = __fsub_rn(py, fy0);
  const float ox = __fsub_rn(1.0f, wx);
  const float oy = __fsub_rn(1.0f, wy);

  float dwx = 0.0f, dwy = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxTensors; ++j) {
    if (j >= L.n) break;
    const T* src = static_cast<const T*>(L.src[j]);
    const T* grad = static_cast<const T*>(L.grad[j]);
    float* dsrc = L.dsrc[j];
    const int c = L.c[j];
    for (int k = lane; k < c; k += G) {
      const float g = to_f(grad[(long long)p * c + k]);
      const float v00 = to_f(src[t00 * c + k]);
      const float v01 = to_f(src[t01 * c + k]);
      const float v10 = to_f(src[t10 * c + k]);
      const float v11 = to_f(src[t11 * c + k]);
      const float dtop = __fmul_rn(g, oy);
      const float dbot = __fmul_rn(g, wy);
      const float top = __fadd_rn(__fmul_rn(v00, ox), __fmul_rn(v01, wx));
      const float bot = __fadd_rn(__fmul_rn(v10, ox), __fmul_rn(v11, wx));
      dwx = __fadd_rn(dwx, __fadd_rn(__fmul_rn(dtop, __fsub_rn(v01, v00)),
                                     __fmul_rn(dbot, __fsub_rn(v11, v10))));
      dwy = __fadd_rn(dwy, __fmul_rn(g, __fsub_rn(bot, top)));
      if (need_im && ok) {
        atomicAdd(dsrc + t00 * c + k, __fmul_rn(dtop, ox));
        atomicAdd(dsrc + t01 * c + k, __fmul_rn(dtop, wx));
        atomicAdd(dsrc + t10 * c + k, __fmul_rn(dbot, ox));
        atomicAdd(dsrc + t11 * c + k, __fmul_rn(dbot, wx));
      }
    }
  }
#pragma unroll
  for (int o = G / 2; o >= 1; o /= 2) {
    dwx += __shfl_xor_sync(0xffffffffu, dwx, o);
    dwy += __shfl_xor_sync(0xffffffffu, dwy, o);
  }
  if (ok && lane == 0) {
    dflow[2 * (long long)p] =
        from_f<TF>(__fmul_rn(dwx, clip_grad(vx, (float)(W - 1))));
    dflow[2 * (long long)p + 1] =
        from_f<TF>(__fmul_rn(dwy, clip_grad(vy, (float)(H - 1))));
  }
}

template <typename T, typename TF, int G>
void launch_g(const BwdList& L, const void* flow, void* dflow, int npix,
              int H, int W, int need_im, cudaStream_t s) {
  constexpr int kPix = kThreads / G;
  const unsigned blocks = (unsigned)((npix + kPix - 1) / kPix);
  warp_bwd_kernel<T, TF, G><<<blocks, kThreads, 0, s>>>(
      L, static_cast<const TF*>(flow), static_cast<TF*>(dflow), npix, H, W,
      need_im);
}

template <typename T, typename TF>
cudaError_t launch(const BwdList& L, const void* flow, void* dflow, int npix,
                   int H, int W, int g, int need_im, cudaStream_t s) {
  switch (g) {
    case 1: launch_g<T, TF, 1>(L, flow, dflow, npix, H, W, need_im, s); break;
    case 2: launch_g<T, TF, 2>(L, flow, dflow, npix, H, W, need_im, s); break;
    case 4: launch_g<T, TF, 4>(L, flow, dflow, npix, H, W, need_im, s); break;
    case 8: launch_g<T, TF, 8>(L, flow, dflow, npix, H, W, need_im, s); break;
    case 16: launch_g<T, TF, 16>(L, flow, dflow, npix, H, W, need_im, s); break;
    default: launch_g<T, TF, 32>(L, flow, dflow, npix, H, W, need_im, s);
  }
  return cudaGetLastError();
}

}  // namespace

// src/grad: n_tensors NHWC tensors (N, H, W, c[j]) of one dtype; dsrc:
// f32 NHWC accumulators of the same shapes, zeroed by the caller (ignored
// when need_im == 0); flow / dflow: (N, H, W, 2) in flow_dtype. dtype /
// flow_dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int vcm_warp_bwd(const void* const* src, const void* const* grad,
                            void* const* dsrc, const int* c, int n_tensors,
                            const void* flow, void* dflow, int N, int H,
                            int W, int dtype, int flow_dtype, int need_im,
                            void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || (dtype != 0 && dtype != 1) ||
      (flow_dtype != 0 && flow_dtype != 1) ||
      (long long)N * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int npix = N * H * W;
  if (npix == 0) return 0;
  BwdList L = {};
  L.n = n_tensors;
  int widest = 1;
  for (int j = 0; j < n_tensors; ++j) {
    if (c[j] < 1 || (need_im && dsrc[j] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    L.src[j] = src[j];
    L.grad[j] = grad[j];
    L.dsrc[j] = need_im ? static_cast<float*>(dsrc[j]) : nullptr;
    L.c[j] = c[j];
    widest = c[j] > widest ? c[j] : widest;
  }
  int g = 1;
  while (g < widest && g < 32) g *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(flow_dtype == 0
                     ? launch<float, float>(L, flow, dflow, npix, H, W, g,
                                            need_im, s)
                     : launch<float, __nv_bfloat16>(L, flow, dflow, npix, H,
                                                    W, g, need_im, s));
  }
  return (int)(flow_dtype == 0
                   ? launch<__nv_bfloat16, float>(L, flow, dflow, npix, H, W,
                                                  g, need_im, s)
                   : launch<__nv_bfloat16, __nv_bfloat16>(
                         L, flow, dflow, npix, H, W, g, need_im, s));
}
