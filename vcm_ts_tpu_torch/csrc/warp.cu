// Kernel A: exact bilinear backward warp over NHWC tensors.
//
// Replaces vcm_ts_tpu/ops/warp.py::_warp_one_gather (flow_warp and
// flow_warp_packed). On the TPU that stayed an XLA gather, because Mosaic
// has no gather; a GPU gathers natively.
//
// Semantics (warp.py:31-46, 75-76): coordinates x + u, y + v in f32 (even
// for bf16 data and a bf16 flow: bf16 cannot hold pixel indices above 256,
// and widening the flow is exact, as _clamped_coords does), clamped to
// [0, W-1] x [0, H-1] BEFORE the floor, edge-padded taps, and the lerp
// ((v00(1-wx) + v01 wx)(1-wy) + (v10(1-wx) + v11 wx) wy) in f32.
//
// Row window (spatial sharding, parallel/spatial.py): the flow and the
// output hold Hl rows, rows [row0, row0 + Hl) of a frame whose image
// holds all H rows. Output row y samples at row0 + y + v, clamped to the
// image's H - 1, so the window's output is bit for bit those rows of the
// whole warp. row0 = 0 and Hl = H is the whole warp.
//
// What bounds it on H100: bytes. Per output element it does 8 flops on 4
// neighbour reads; the neighbours of neighbouring pixels overlap and stay in
// L1/L2, so device memory sees about one read of the source and one write of
// the output (2 x 560 MB for the 67-channel f32 call at 1088x1920), far
// below the f32 rate.
//
// Design: no shared memory, no barrier and no division per item. A pixel
// belongs to a group of G lanes (G a power of two fixed per launch by the
// widest tensor: 16 lanes for 64 f32 channels, 8 for 64 bf16 channels),
// and each thread takes kBatch = 2 pixels at a time, whose tap loads all
// go out before the first lerp, so every thread keeps 8 loads in flight.
// Every lane computes its pixels' coordinates itself from the flow (read
// in its own dtype, f32 or bf16, and widened in registers). Lane l of a
// group takes the 16-byte chunks l, l+G, ... of each tensor whose channel
// count and pointers allow 16-byte vectors, and the channels l, l+G, ...
// of the others: the frame of the packed call (3 + 64) rides with the
// feature's group at no extra coordinate pass. A block owns a 2-D tile of
// 32 x 8 pixels, so that its taps fall in a compact region that L1 serves.
// One narrow tensor alone (at most 16 bytes a pixel: the 3-channel frame
// at every SpyNet level) has its own kernel: one thread per pixel, its
// channel count a template argument, so all 4 x C tap loads of both of its
// pixels are unrolled and in flight together. The lerp uses __fmul_rn /
// __fadd_rn / __fsub_rn so that nvcc cannot contract it into FMAs: every
// op rounds as in the plain PyTorch version, which makes the two agree bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 4;
constexpr int kThreads = 256;
constexpr int kBatch = 2;     // pixels per thread whose loads go out together
constexpr int kTileRows = 8;  // a block's tile: 32 x kTileRows pixels

struct WarpList {
  const void* src[kMaxTensors];
  void* dst[kMaxTensors];
  int c[kMaxTensors];      // channels of tensor j
  int vec[kMaxTensors];    // 1: 16-byte chunks, 0: single channels
  int units[kMaxTensors];  // chunks (vec) or channels per pixel
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

// One output pixel: its index, its four taps' pixel indices, its weights.
// Pixel indices fit 31 bits (the launcher checks N*H*W); element offsets
// are formed in 64 bits.
struct Pix {
  int p;
  int tap[4];
  float wx, wy;
  bool ok;  // inside the image (else clamped in, loaded, not stored)
};

// Output (and flow) pixel (x, y) of image n in a window of Hl rows
// starting at image row row0; the taps index the image's H rows.
template <typename TF>
__device__ __forceinline__ Pix coords(const TF* __restrict__ flow, int n,
                                      int x, int y, int Hl, int H, int W,
                                      int row0) {
  Pix P;
  P.ok = x < W && y < Hl;
  x = min(x, W - 1);
  y = min(y, Hl - 1);
  P.p = n * Hl * W + y * W + x;
  const int plane = n * H * W;
  const TF* f = flow + 2 * (long long)P.p;
  const float px =
      fminf(fmaxf(__fadd_rn((float)x, to_f(f[0])), 0.0f), (float)(W - 1));
  const float py = fminf(
      fmaxf(__fadd_rn((float)(row0 + y), to_f(f[1])), 0.0f), (float)(H - 1));
  const float fx0 = floorf(px);
  const float fy0 = floorf(py);
  const int x0 = (int)fx0;
  const int y0 = (int)fy0;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  P.tap[0] = plane + y0 * W + x0;
  P.tap[1] = plane + y0 * W + x1;
  P.tap[2] = plane + y1 * W + x0;
  P.tap[3] = plane + y1 * W + x1;
  P.wx = __fsub_rn(px, fx0);
  P.wy = __fsub_rn(py, fy0);
  return P;
}

// Items lane, lane + G, ... of one tensor (c channels; an item is V
// elements: a 16-byte chunk, or one channel when V = 1) at the thread's
// B pixels; the loads of all of them go out before any lerp.
template <typename T, int V, int G, int B>
__device__ __forceinline__ void warp_items(const T* __restrict__ src,
                                           T* __restrict__ dst, int c,
                                           int units, int lane,
                                           const Pix* P) {
  using VT = Vec<T, V>;
  for (int k = lane; k < units; k += G) {
    const int off = k * V;
    VT t[B][4];
#pragma unroll
    for (int u = 0; u < B; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        t[u][q] = *reinterpret_cast<const VT*>(
            src + (long long)P[u].tap[q] * c + off);
#pragma unroll
    for (int u = 0; u < B; ++u) {
      VT r;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        r.v[i] = from_f<T>(lerp4(to_f(t[u][0].v[i]), to_f(t[u][1].v[i]),
                                 to_f(t[u][2].v[i]), to_f(t[u][3].v[i]),
                                 P[u].wx, P[u].wy));
      }
      if (P[u].ok) {
        *reinterpret_cast<VT*>(dst + (long long)P[u].p * c + off) = r;
      }
    }
  }
}

// General kernel: a block owns a tile of 32 x kTileRows pixels (twice as
// many rows when G = 1, so that each thread has kBatch pixels); groups of
// G lanes per pixel walk it kBatch pixels per thread at a time.
template <int G>
struct Tile {
  static constexpr int kGroups = kThreads / G;
  static constexpr int kRows = kGroups * kBatch > 32 * kTileRows
                                   ? kGroups * kBatch / 32
                                   : kTileRows;
};

template <typename T, typename TF, int G>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(WarpList L, const TF* __restrict__ flow, int Hl, int H,
                int W, int row0) {
  constexpr int kGroups = Tile<G>::kGroups;
  constexpr int kTile = 32 * Tile<G>::kRows;
  const int lane = threadIdx.x % G;
  for (int i0 = threadIdx.x / G; i0 < kTile; i0 += kGroups * kBatch) {
    Pix P[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kGroups;
      P[u] = coords(flow, blockIdx.z, blockIdx.x * 32 + i % 32,
                    blockIdx.y * Tile<G>::kRows + i / 32, Hl, H, W, row0);
    }
    // unrolled, so that the parameter block is indexed by constants (a
    // runtime index copies it to local memory)
#pragma unroll
    for (int j = 0; j < kMaxTensors; ++j) {
      if (j >= L.n) break;
      const T* src = static_cast<const T*>(L.src[j]);
      T* dst = static_cast<T*>(L.dst[j]);
      if (L.vec[j]) {
        warp_items<T, 16 / sizeof(T), G, kBatch>(src, dst, L.c[j],
                                                 L.units[j], lane, P);
      } else {
        warp_items<T, 1, G, kBatch>(src, dst, L.c[j], L.units[j], lane, P);
      }
    }
  }
}

// One narrow tensor (NC channels, at most 16 bytes a pixel, e.g. the
// 3-channel frame): one thread per pixel, all its tap loads unrolled.
template <typename T, typename TF, int NC>
__global__ void __launch_bounds__(kThreads)
    warp_narrow_kernel(const T* __restrict__ src, T* __restrict__ dst,
                       const TF* __restrict__ flow, int Hl, int H, int W,
                       int row0) {
  constexpr int kTX = 32;
  constexpr int kTY = kThreads * kBatch / kTX;
  Pix P[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int i = threadIdx.x + u * kThreads;
    P[u] = coords(flow, blockIdx.z, blockIdx.x * kTX + i % kTX,
                  blockIdx.y * kTY + i / kTX, Hl, H, W, row0);
  }
  T t[kBatch][4][NC];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        t[u][q][ch] = src[(long long)P[u].tap[q] * NC + ch];
      }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (!P[u].ok) continue;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      dst[(long long)P[u].p * NC + ch] = from_f<T>(
          lerp4(to_f(t[u][0][ch]), to_f(t[u][1][ch]), to_f(t[u][2][ch]),
                to_f(t[u][3][ch]), P[u].wx, P[u].wy));
    }
  }
}

// The rows of the window: image height H, Hl output rows from row0.
struct Rows {
  int H, Hl, row0;
};

template <typename T, typename TF, int G>
void launch_g(const WarpList& L, const TF* f, int N, Rows R, int W,
              cudaStream_t s) {
  constexpr int kRows = Tile<G>::kRows;
  const dim3 grid((unsigned)((W + 31) / 32),
                  (unsigned)((R.Hl + kRows - 1) / kRows), (unsigned)N);
  warp_kernel<T, TF, G><<<grid, kThreads, 0, s>>>(L, f, R.Hl, R.H, W,
                                                  R.row0);
}

template <typename T, typename TF, int NC>
void launch_narrow(const WarpList& L, const TF* f, int N, Rows R, int W,
                   cudaStream_t s) {
  constexpr int kTY = kThreads * kBatch / 32;
  const dim3 grid((unsigned)((W + 31) / 32),
                  (unsigned)((R.Hl + kTY - 1) / kTY), (unsigned)N);
  warp_narrow_kernel<T, TF, NC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(L.src[0]), static_cast<T*>(L.dst[0]), f, R.Hl,
      R.H, W, R.row0);
}

template <typename T, typename TF>
cudaError_t launch(const WarpList& L, const void* flow, int N, Rows R, int W,
                   int g, cudaStream_t s) {
  const TF* f = static_cast<const TF*>(flow);
  if (g == 0) {  // one narrow tensor
    switch (L.c[0]) {
      case 1: launch_narrow<T, TF, 1>(L, f, N, R, W, s); break;
      case 2: launch_narrow<T, TF, 2>(L, f, N, R, W, s); break;
      case 3: launch_narrow<T, TF, 3>(L, f, N, R, W, s); break;
      case 4: launch_narrow<T, TF, 4>(L, f, N, R, W, s); break;
      case 5: launch_narrow<T, TF, 5>(L, f, N, R, W, s); break;
      case 6: launch_narrow<T, TF, 6>(L, f, N, R, W, s); break;
      case 7: launch_narrow<T, TF, 7>(L, f, N, R, W, s); break;
      default: launch_narrow<T, TF, 8>(L, f, N, R, W, s);
    }
    return cudaGetLastError();
  }
  switch (g) {
    case 1: launch_g<T, TF, 1>(L, f, N, R, W, s); break;
    case 2: launch_g<T, TF, 2>(L, f, N, R, W, s); break;
    case 4: launch_g<T, TF, 4>(L, f, N, R, W, s); break;
    case 8: launch_g<T, TF, 8>(L, f, N, R, W, s); break;
    case 16: launch_g<T, TF, 16>(L, f, N, R, W, s); break;
    default: launch_g<T, TF, 32>(L, f, N, R, W, s);
  }
  return cudaGetLastError();
}

}  // namespace

// src: n_tensors NHWC tensors of shape (N, H, W, c[j]), one dtype; flow
// and dst: (N, Hl, W, 2), x then y, and (N, Hl, W, c[j]): rows [row0,
// row0 + Hl) of the warp (row0 = 0, Hl = H: the whole warp). dtype /
// flow_dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int vcm_warp(const void* const* src, void* const* dst,
                        const int* c, int n_tensors, const void* flow, int N,
                        int H, int W, int Hl, int row0, int dtype,
                        int flow_dtype, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || (dtype != 0 && dtype != 1) ||
      (flow_dtype != 0 && flow_dtype != 1) || N > 65535 || Hl < 0 ||
      row0 < 0 || row0 + Hl > H || (long long)N * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)N * Hl * W == 0) return 0;
  const Rows R = {H, Hl, row0};
  WarpList L = {};
  const int esize = dtype == 0 ? 4 : 2;
  const int vmax = 16 / esize;  // elements in 16 bytes
  int widest = 1;  // work units of the widest tensor: sets the group size
  L.n = n_tensors;
  for (int j = 0; j < n_tensors; ++j) {
    L.src[j] = src[j];
    L.dst[j] = dst[j];
    L.c[j] = c[j];
    const bool aligned = ((uintptr_t)src[j] % 16 == 0) &&
                         ((uintptr_t)dst[j] % 16 == 0);
    L.vec[j] = c[j] % vmax == 0 && aligned;
    L.units[j] = L.vec[j] ? c[j] / vmax : c[j];
    // a tensor of at most 16 bytes a pixel is one lane's work
    const int w = (!L.vec[j] && c[j] * esize <= 16) ? 1 : L.units[j];
    widest = w > widest ? w : widest;
  }
  // 0: one narrow tensor (its own kernel); else lanes per pixel
  int g = n_tensors == 1 && !L.vec[0] && c[0] * esize <= 16 ? 0 : 1;
  while (g && g < widest && g < 32) g *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = flow_dtype == 0 ? launch<float, float>(L, flow, N, R, W, g, s)
                        : launch<float, __nv_bfloat16>(L, flow, N, R, W, g, s);
  } else {
    e = flow_dtype == 0
            ? launch<__nv_bfloat16, float>(L, flow, N, R, W, g, s)
            : launch<__nv_bfloat16, __nv_bfloat16>(L, flow, N, R, W, g, s);
  }
  return (int)e;
}
