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
// What bounds it on H100: bytes in principle (g and the four taps of every
// channel read, the taps mostly from L1/L2 as in the forward; four values
// per channel added into d im), but the loads' instructions and latency in
// practice: with one 4-byte load per lane and channel, the d flow sums
// alone (need_im = 0) took most of the kernel's time. So a lane reads 16
// bytes at a time: a tensor whose pixel row is a whole number of 16-byte
// units (4 f32 or 8 bf16 channels) and whose pointers are 16-byte aligned
// is read in those units, and its d im is added with float4 atomicAdd
// (sm_90) into the f32 buffer; any other tensor (the 3-channel frame) goes
// channel by channel. A group of G lanes (a power of two <= 32, inside one
// warp) serves one pixel, G the widest tensor's count of units, so the
// 64-channel feature of a packed call takes 16 lanes in f32 and 8 in
// bf16, and the frame's three channels run on three of them. Once the
// loads are wide, the atomics bound the kernel (the d flow pass alone
// takes about half of its time at 1088x1920 on an H100), and of the
// layouts tried the fastest adds were float4 atomics whose warp
// instruction covers whole 16-byte slots of pixel rows side by side. In
// f32 a lane's float4 is its own unit's; a bf16 unit holds two float4 of
// d im per tap, which a per-warp stage in shared memory re-deals before
// the adds (straight from the units they lie 32 bytes apart, and the bf16
// call ran 1.3x slower than with scalar adds of one channel a lane).
// Scalar atomics over 32 channels a pixel, staged the same way, were no
// faster than one channel a lane.
//
// The adds into d im are f32 atomics: neighbouring pixels share taps, and
// a gather's adjoint has no owner per output. Their order changes from run
// to run, so d im is NOT deterministic: it agrees with the plain version
// (a sequential index_add_) to f32 rounding of the sums. For bf16 data d
// im accumulates in an f32 buffer that the wrapper casts once. d flow is
// deterministic: each lane sums its channels in order, then a fixed
// shuffle tree. Every product is rounded as in the plain version
// (__fmul_rn etc., no FMA contraction), so each single contribution to d
// im equals the plain one bit for bit and only the order of the sums
// differs. When no tensor needs d im the atomics are skipped (need_im =
// 0): the SpyNet warps of a reference frame that takes no gradient.

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
  int vec[kMaxTensors];  // 1: channel by channel; else 16-byte units
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

// channels in a 16-byte unit
template <typename T>
struct Unit;
template <>
struct Unit<float> {
  static constexpr int n = 4;
};
template <>
struct Unit<__nv_bfloat16> {
  static constexpr int n = 8;
};

// one 16-byte unit, read-only path, widened to f32 (bf16 -> f32 is exact)
__device__ __forceinline__ void load_unit(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p,
                                          float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// d clip(v, 0, hi) / dv, jnp.clip's rule: maximum(v, 0) then minimum(., hi),
// each giving 0.5 at a tie.
__device__ __forceinline__ float clip_grad(float v, float hi) {
  const float lo = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  const float u = fmaxf(v, 0.0f);
  return lo * (u < hi ? 1.0f : (u == hi ? 0.5f : 0.0f));
}

struct Taps {
  float ox, wx, oy, wy;
};

// one channel: adds its share of d flow to (dwx, dwy) and returns its four
// d im contributions, rounded as in the plain version
__device__ __forceinline__ void channel(const Taps& t, float g, float v00,
                                        float v01, float v10, float v11,
                                        float& dwx, float& dwy, float& d00,
                                        float& d01, float& d10, float& d11) {
  const float dtop = __fmul_rn(g, t.oy);
  const float dbot = __fmul_rn(g, t.wy);
  const float top = __fadd_rn(__fmul_rn(v00, t.ox), __fmul_rn(v01, t.wx));
  const float bot = __fadd_rn(__fmul_rn(v10, t.ox), __fmul_rn(v11, t.wx));
  dwx = __fadd_rn(dwx, __fadd_rn(__fmul_rn(dtop, __fsub_rn(v01, v00)),
                                 __fmul_rn(dbot, __fsub_rn(v11, v10))));
  dwy = __fadd_rn(dwy, __fmul_rn(g, __fsub_rn(bot, top)));
  d00 = __fmul_rn(dtop, t.ox);
  d01 = __fmul_rn(dtop, t.wx);
  d10 = __fmul_rn(dbot, t.ox);
  d11 = __fmul_rn(dbot, t.wx);
}

// kUnits: some tensor is read in 16-byte units; without, the unit paths
// are compiled out, so that channel-by-channel calls (SpyNet's 3-channel
// levels) keep the registers and speed of a kernel without them
template <typename T, typename TF, int G, bool kUnits>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_kernel(BwdList L, const TF* __restrict__ flow,
                    TF* __restrict__ dflow, int npix, int H, int W,
                    int need_im) {
  constexpr int V = Unit<T>::n;
  const int lane = threadIdx.x % G;
  const int p0 = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool ok = p0 < npix;
  // out-of-range groups run on pixel npix-1 and store nothing, so that
  // every lane of the warp reaches the shuffles
  const int p = ok ? p0 : npix - 1;
  const bool add = need_im && ok;
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
  const long long taps[4] = {t00, t01, t10, t11};
  Taps t;
  t.wx = __fsub_rn(px, fx0);
  t.wy = __fsub_rn(py, fy0);
  t.ox = __fsub_rn(1.0f, t.wx);
  t.oy = __fsub_rn(1.0f, t.wy);

  float dwx = 0.0f, dwy = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxTensors; ++j) {
    if (j >= L.n) break;
    const int c = L.c[j];
    const T* src = static_cast<const T*>(L.src[j]);
    const T* gp = static_cast<const T*>(L.grad[j]) + (long long)p * c;
    const T* s00 = src + t00 * c;
    const T* s01 = src + t01 * c;
    const T* s10 = src + t10 * c;
    const T* s11 = src + t11 * c;
    float* dsrc = L.dsrc[j];
    if (!kUnits || L.vec[j] == 1) {
      for (int k = lane; k < c; k += G) {
        float d00, d01, d10, d11;
        channel(t, to_f(gp[k]), to_f(s00[k]), to_f(s01[k]), to_f(s10[k]),
                to_f(s11[k]), dwx, dwy, d00, d01, d10, d11);
        if (add) {
          atomicAdd(dsrc + t00 * c + k, d00);
          atomicAdd(dsrc + t01 * c + k, d01);
          atomicAdd(dsrc + t10 * c + k, d10);
          atomicAdd(dsrc + t11 * c + k, d11);
        }
      }
      continue;
    }
    if constexpr (kUnits && V == 4) {
      // f32: a lane's unit is one float4 of d im per tap, and the lanes of
      // a pixel cover its row contiguously
      for (int k = lane * V; k < c; k += G * V) {
        float g[V], v00[V], v01[V], v10[V], v11[V];
        load_unit(gp + k, g);
        load_unit(s00 + k, v00);
        load_unit(s01 + k, v01);
        load_unit(s10 + k, v10);
        load_unit(s11 + k, v11);
        float d[4][V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          channel(t, g[i], v00[i], v01[i], v10[i], v11[i], dwx, dwy,
                  d[0][i], d[1][i], d[2][i], d[3][i]);
        }
        if (add) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            atomicAdd(reinterpret_cast<float4*>(dsrc + taps[q] * c + k),
                      make_float4(d[q][0], d[q][1], d[q][2], d[q][3]));
          }
        }
      }
    } else if constexpr (kUnits) {
      // bf16: a lane's unit is two float4 of d im per tap, 32 bytes apart
      // from the next lane's; a per-warp stage re-deals them so that each
      // atomic instruction covers whole pixel rows contiguously
      __shared__ __align__(16) float stage[kThreads / 32][32 * V];
      float* buf = stage[threadIdx.x / 32];
      const int wl = threadIdx.x % 32;
      constexpr int kSlots = G * V / 4;  // float4 slots of a pixel a round
      // every lane of the warp runs every round (the stage is the warp's)
      for (int base = 0; base < c; base += G * V) {
        const int k = base + lane * V;
        float d[4][V] = {};
        if (k < c) {
          float g[V], v00[V], v01[V], v10[V], v11[V];
          load_unit(gp + k, g);
          load_unit(s00 + k, v00);
          load_unit(s01 + k, v01);
          load_unit(s10 + k, v10);
          load_unit(s11 + k, v11);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            channel(t, g[i], v00[i], v01[i], v10[i], v11[i], dwx, dwy,
                    d[0][i], d[1][i], d[2][i], d[3][i]);
          }
        }
        if (!need_im) continue;
        const int m = min(G * V, c - base);  // channels of this round
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int i = 0; i < V; i += 4) {
            *reinterpret_cast<float4*>(buf + wl * V + i) =
                make_float4(d[q][i], d[q][i + 1], d[q][i + 2], d[q][i + 3]);
          }
          __syncwarp();
#pragma unroll
          for (int r = 0; r < V / 4; ++r) {
            const int slot = r * 32 + wl;
            const int o = slot / kSlots;  // the warp's pixel it belongs to
            const int u = slot % kSlots;
            const long long tap = __shfl_sync(0xffffffffu, taps[q], o * G);
            const int add_o = __shfl_sync(0xffffffffu, (int)add, o * G);
            if (add_o && 4 * u < m) {
              atomicAdd(reinterpret_cast<float4*>(dsrc + tap * c + base +
                                                  4 * u),
                        *reinterpret_cast<const float4*>(buf + 4 * slot));
            }
          }
          __syncwarp();
        }
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
  bool units = false;
  for (int j = 0; j < L.n; ++j) units = units || L.vec[j] != 1;
  if (units) {
    warp_bwd_kernel<T, TF, G, true><<<blocks, kThreads, 0, s>>>(
        L, static_cast<const TF*>(flow), static_cast<TF*>(dflow), npix, H,
        W, need_im);
  } else {
    warp_bwd_kernel<T, TF, G, false><<<blocks, kThreads, 0, s>>>(
        L, static_cast<const TF*>(flow), static_cast<TF*>(dflow), npix, H,
        W, need_im);
  }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
  const int per_unit = dtype == 0 ? 4 : 8;
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
    const bool units = c[j] % per_unit == 0 && aligned16(src[j]) &&
                       aligned16(grad[j]) &&
                       (!need_im || aligned16(dsrc[j]));
    L.vec[j] = units ? per_unit : 1;
    const int lanes = c[j] / L.vec[j];
    widest = lanes > widest ? lanes : widest;
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
