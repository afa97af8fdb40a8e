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
// to 224 did not repeat bit for bit. This kernel is that VJP as a gather.
// Each output row (column) o takes its two taps from input rows i0 =
// floor(s), i1 = min(i0 + 1, in - 1), s = max(scale (o + 0.5) - 0.5, 0),
// scale = in / out (PyTorch's area_pixel_compute_source_index); s grows
// with o, so the output rows that take input row i are one contiguous
// run. Every input element (n, i, j, c) is, in f32 and in this fixed
// order, the sum over those output rows o ascending of wy(o) x T[o, j],
// where T[o, j] is the sum over the output columns p that take j,
// ascending, of wx(p) g[o, p]; it is written once, in the data's dtype.
// The weights are rounded as the forward's (__fmul_rn etc., no FMA), and
// a tap that lands on i twice (i0 == i1 at the last row) takes l0 + l1.
// float64 data (the perceptual losses' float64 gradient checks) sums and
// computes its taps in f64, as its forward does.
//
// What bounds it on H100: bytes (g read once, d x written once), but at
// the train step's shapes those take at most 1.7 us, under a launch: the
// work is latency-bound. So one block owns a tile of TH input rows x TW
// input columns (x a chunk of channels) and keeps each thread's chain of
// dependent steps short:
//  1. tap tables: one thread per output row and per output column of the
//     tile's window computes that output's taps (i0, i1, and the weights
//     of each) into shared memory, once per block instead of once per
//     element; one thread per input row and per input column then finds
//     its run of outputs [first, last] in those tables;
//  2. column sums once: T[o, j] for the output rows the tile's rows take,
//     staged in shared memory, each read by every input row that o taps
//     (up to 4 at a 2x upsample) instead of being summed again by each;
//  3. row sums: each thread sums its pixel's run of T rows and writes it.
// Threads go along pixels for narrow tensors (C <= 4: the 2-channel flows
// and 3-channel frames of training), one pixel and all of its channels a
// thread, read with the widest aligned load the pixel allows; wide
// tensors go along channels in 16-byte units. Each thread issues a run's
// loads four at a time before it sums them, so they are in flight
// together. Tiles shrink with the shape until the grid holds two blocks
// an SM, so that SpyNet's 16x16 level still spreads over the card, and
// grow until it holds at most four, so that it runs in one wave. The
// sums are the same operations in the same order as a thread-per-element
// loop over the same taps: the bits do not follow the tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // a run's loads in flight at once
constexpr int kSmemBytes = 48 * 1024;  // without the opt-in
constexpr int kSmemMax = 227 * 1024;    // with it (the largest upscales)

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

// one output index's two taps: input indices i0, i1 and their weights w0
// (l0, or l0 + l1 where i0 == i1) and w1 (l1)
template <typename A>
struct Tap {
  int i0, i1;
  A w0, w1;
};

template <typename A>
__device__ __forceinline__ Tap<A> make_tap(A scale, int o, int n_in) {
  A s = sub(mul(scale, add((A)o, (A)0.5)), (A)0.5);
  s = s > (A)0 ? s : (A)0;
  const int i0 = (int)s;
  const int i1 = i0 < n_in - 1 ? i0 + 1 : i0;
  const A l1 = sub(s, (A)i0);
  const A l0 = sub((A)1, l1);
  return {i0, i1, i1 == i0 ? add(l0, l1) : l0, l1};
}

// the weight of input index i in a tap that takes it
template <typename A>
__device__ __forceinline__ A weight(const Tap<A>& t, int i) {
  return t.i0 == i ? t.w0 : t.w1;
}

// the output indices [lo, hi] that may take input index i (a slack of one
// each side around the exact window; the taps decide)
__device__ __forceinline__ void window(double scale, int i, int n_out,
                                       int& lo, int& hi) {
  lo = max(0, (int)floor((i - 0.5) / scale - 0.5) - 1);
  hi = min(n_out - 1, (int)ceil((i + 1.5) / scale - 0.5) + 1);
}

// CV channels from p into v: one 4-, 8- or 16-byte load where the pixel
// (narrow) or unit (wide) is that wide and aligned (vec), else one by one
template <typename T, int CV, typename A>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, bool vec,
                                          A (&v)[CV]) {
  constexpr int kBytes = CV * (int)sizeof(T);
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    if (vec) {
      using U = typename std::conditional<
          kBytes == 16, uint4,
          typename std::conditional<kBytes == 8, uint2,
                                    unsigned>::type>::type;
      const U u = __ldg(reinterpret_cast<const U*>(p));
      T t[CV];
      memcpy(t, &u, kBytes);
#pragma unroll
      for (int c = 0; c < CV; ++c) v[c] = to_acc(t[c]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) v[c] = to_acc(p[c]);
}

template <typename T, int CV, typename A>
__device__ __forceinline__ void store_vals(T* __restrict__ p, bool vec,
                                           const A (&v)[CV]) {
  constexpr int kBytes = CV * (int)sizeof(T);
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    if (vec) {
      using U = typename std::conditional<
          kBytes == 16, uint4,
          typename std::conditional<kBytes == 8, uint2,
                                    unsigned>::type>::type;
      T t[CV];
#pragma unroll
      for (int c = 0; c < CV; ++c) t[c] = from_acc<T>(v[c]);
      U u;
      memcpy(&u, t, kBytes);
      *reinterpret_cast<U*>(p) = u;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) p[c] = from_acc<T>(v[c]);
}

// The launch's shape and tiling (see plan() below).
struct Plan {
  int N, C, h_in, w_in, h_out, w_out;
  int TH, TW;    // input rows and columns of a tile
  int CV, Cb;    // channels a thread handles; channels of a block
  int chunks;    // channel chunks: ceil(C / Cb)
  int tiles_x, tiles_y;
  int ny_cap, nx_cap;  // window sizes the tap tables hold
  int vec;       // 1: load and store CV channels as one aligned unit
  int threads;
};

// shared memory: the two tap tables, each input row's and column's run
// [first, last] (indices into the tables), then T
template <typename A>
struct Layout {
  size_t ytab, xtab, yrun, xrun, t, bytes;
  __host__ __device__ Layout(const Plan& p) {
    ytab = 0;
    xtab = ytab + (size_t)p.ny_cap * sizeof(Tap<A>);
    yrun = xtab + (size_t)p.nx_cap * sizeof(Tap<A>);
    xrun = yrun + (size_t)p.TH * sizeof(int2);
    t = (xrun + (size_t)p.TW * sizeof(int2) + 15) & ~(size_t)15;
    bytes = t + (size_t)p.ny_cap * p.TW * p.Cb * sizeof(A);
  }
};

template <typename T, int CV>
__global__ void __launch_bounds__(kMaxThreads)
    resize_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx,
                      const Plan p) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<A> lay(p);
  Tap<A>* ytab = reinterpret_cast<Tap<A>*>(smem + lay.ytab);
  Tap<A>* xtab = reinterpret_cast<Tap<A>*>(smem + lay.xtab);
  int2* yrun = reinterpret_cast<int2*>(smem + lay.yrun);
  int2* xrun = reinterpret_cast<int2*>(smem + lay.xrun);
  A* ts = reinterpret_cast<A*>(smem + lay.t);

  // the tile: input rows [i_s, i_s + th), columns [j_s, j_s + tw),
  // channels [c0, c0 + cb) of plane n
  int b = blockIdx.x;
  const int tx = b % p.tiles_x;
  b /= p.tiles_x;
  const int ty = b % p.tiles_y;
  b /= p.tiles_y;
  const int chunk = b % p.chunks;
  const int n = b / p.chunks;
  const int i_s = ty * p.TH, j_s = tx * p.TW, c0 = chunk * p.Cb;
  const int th = min(p.TH, p.h_in - i_s), tw = min(p.TW, p.w_in - j_s);
  const int groups = min(p.Cb, p.C - c0) / CV;
  const bool vec = p.vec != 0;
  const int tid = threadIdx.x, nt = blockDim.x;

  // PyTorch's scale: in / out in the forward's accumulation type
  const A sh = (A)p.h_in / (A)p.h_out, sw = (A)p.w_in / (A)p.w_out;
  int ylo, yhi, xlo, xhi, dummy;
  window(sh, i_s, p.h_out, ylo, dummy);
  window(sh, i_s + th - 1, p.h_out, dummy, yhi);
  window(sw, j_s, p.w_out, xlo, dummy);
  window(sw, j_s + tw - 1, p.w_out, dummy, xhi);
  const int ny = yhi - ylo + 1, nx = xhi - xlo + 1;

  // 1. the taps of the tile's window of output rows and columns
  for (int t = tid; t < ny + nx; t += nt) {
    if (t < ny) {
      ytab[t] = make_tap(sh, ylo + t, p.h_in);
    } else {
      xtab[t - ny] = make_tap(sw, xlo + t - ny, p.w_in);
    }
  }
  __syncthreads();
  // each input row's and column's run of outputs that take it
  for (int t = tid; t < th + tw; t += nt) {
    const bool is_row = t < th;
    const int i = is_row ? i_s + t : j_s + t - th;
    const Tap<A>* tab = is_row ? ytab : xtab;
    const int base = is_row ? ylo : xlo;
    int lo, hi;
    window(is_row ? sh : sw, i, is_row ? p.h_out : p.w_out, lo, hi);
    int first = 1, last = 0;  // empty
    for (int o = lo - base; o <= hi - base; ++o) {
      const Tap<A> tp = tab[o];
      if (tp.i0 == i || tp.i1 == i) {
        if (first > last) first = o;
        last = o;
      }
    }
    (is_row ? yrun[t] : xrun[t - th]) = make_int2(first, last);
  }
  __syncthreads();

  // the output rows T holds: the union of the rows' runs
  int tlo = ny, thi = -1;
  for (int il = 0; il < th; ++il) {
    const int2 r = yrun[il];
    if (r.x <= r.y) {
      tlo = min(tlo, r.x);
      thi = max(thi, r.y);
    }
  }

  // 2. T[o, j] = sum over the run of j, ascending, of wx(p) g[n, o, p]
  const int items1 = (thi - tlo + 1) * tw * groups;
  for (int t = tid; t < items1; t += nt) {
    const int gi = t % groups;
    const int r = t / groups;
    const int jl = r % tw, ol = r / tw;
    const int j = j_s + jl;
    const int2 run = xrun[jl];
    const T* row = g + ((long long)n * p.h_out + ylo + tlo + ol) * p.w_out *
                           p.C + c0 + gi * CV;
    A sum[CV];
#pragma unroll
    for (int c = 0; c < CV; ++c) sum[c] = (A)0;
    for (int q = run.x; q <= run.y; q += kUnroll) {
      A w[kUnroll], v[kUnroll][CV];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (q + k <= run.y) {
          w[k] = weight(xtab[q + k], j);
          load_vals<T, CV>(row + (long long)(xlo + q + k) * p.C, vec, v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (q + k <= run.y) {
#pragma unroll
          for (int c = 0; c < CV; ++c) sum[c] = add(sum[c], mul(w[k], v[k][c]));
        }
      }
    }
    A* dst = ts + ((long long)ol * p.TW + jl) * p.Cb + gi * CV;
#pragma unroll
    for (int c = 0; c < CV; ++c) dst[c] = sum[c];
  }
  __syncthreads();

  // 3. d x[n, i, j] = sum over the run of i, ascending, of wy(o) T[o, j]
  const int items2 = th * tw * groups;
  for (int t = tid; t < items2; t += nt) {
    const int gi = t % groups;
    const int r = t / groups;
    const int jl = r % tw, il = r / tw;
    const int i = i_s + il;
    const int2 run = yrun[il];
    A acc[CV];
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[c] = (A)0;
    for (int q = run.x; q <= run.y; q += kUnroll) {
      A w[kUnroll], v[kUnroll][CV];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (q + k <= run.y) {
          w[k] = weight(ytab[q + k], i);
          const A* src =
              ts + ((long long)(q + k - tlo) * p.TW + jl) * p.Cb + gi * CV;
#pragma unroll
          for (int c = 0; c < CV; ++c) v[k][c] = src[c];
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (q + k <= run.y) {
#pragma unroll
          for (int c = 0; c < CV; ++c) acc[c] = add(acc[c], mul(w[k], v[k][c]));
        }
      }
    }
    store_vals<T, CV>(dx + (((long long)n * p.h_in + i) * p.w_in + j_s + jl) *
                               p.C + c0 + gi * CV,
                      vec, acc);
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// the most output indices the window of `tile` consecutive input indices
// spans: (tile + 1) out / in + 5 (window()'s floor, ceil and slack), with
// room for the scale's rounding
int window_cap(int tile, int n_in, int n_out) {
  const long long cap = (long long)((tile + 1) * (double)n_out / n_in) + 7;
  return (int)(cap < n_out ? cap : n_out);
}

// The tiling of a launch: CV and Cb from C and the dtype; a tile about
// 256 threads' work, a warp along a row of the tile; smaller tiles until
// the grid holds two blocks an SM or the tile is one row of 8 pixels,
// taller ones while it holds more than four an SM (up to 1024 items);
// smaller again until 48 KB of shared memory hold it (a one-pixel tile
// of a large upscale may take up to 227 KB). `sms` is the device's SM
// count. Returns false where no tiling fits: a one-pixel tile's tap
// tables and column sums over 227 KB, an upscale of one axis past about
// 2400x to 5800x by channels and dtype, or twice that where the axis has
// one input pixel (1x1 -> 8299x3 is the largest C = 3 f32 / bf16 upscale
// that fits, 1x1 -> 7261x3 in float64).
template <typename T>
bool plan(Plan& p, const void* g, const void* dx, int sms) {
  using A = typename Acc<T>::type;
  const long long fill = 2LL * sms;  // two blocks an SM
  const int size = (int)sizeof(T);
  const int unit = 16 / size;  // channels of a 16-byte unit
  const bool narrow = p.C <= 4 && size < 8;
  if (narrow) {
    p.CV = p.C;
  } else if (p.C % unit == 0 && size < 8) {
    p.CV = unit;
  } else {
    p.CV = 1;  // float64 (its checks, not speed) and ragged widths
  }
  p.Cb = narrow ? p.C : (p.C < 32 * p.CV ? p.C : 32 * p.CV);
  const int bytes = p.CV * size;
  const uintptr_t mask = (uintptr_t)bytes - 1;
  p.vec = (bytes == 4 || bytes == 8 || bytes == 16) &&
          ((uintptr_t)g & mask) == 0 && ((uintptr_t)dx & mask) == 0 &&
          (narrow || (p.C * size) % bytes == 0);
  int groups = p.Cb / p.CV;
  p.TW = p.w_in < 32 / groups ? p.w_in : (32 / groups > 0 ? 32 / groups : 1);
  p.TH = kMaxThreads / (p.TW * groups);
  p.TH = p.TH < 1 ? 1 : (p.TH > p.h_in ? p.h_in : p.TH);
  auto blocks = [&]() {
    return (long long)p.N * ceil_div(p.C, p.Cb) * ceil_div(p.h_in, p.TH) *
           ceil_div(p.w_in, p.TW);
  };
  while (blocks() < fill && p.TH > 1) p.TH = (p.TH + 1) / 2;
  while (blocks() < fill && p.TW > 8) p.TW = (p.TW + 1) / 2;
  // and taller (more than one item a thread) while it holds more than
  // four blocks an SM: a second wave of blocks costs more than a thread's
  // second item
  while (blocks() > 2 * fill && p.TH * 2 <= p.h_in &&
         p.TH * p.TW * groups < 1024) {
    p.TH *= 2;
  }
  for (;;) {
    p.ny_cap = window_cap(p.TH, p.h_in, p.h_out);
    p.nx_cap = window_cap(p.TW, p.w_in, p.w_out);
    const size_t smem = Layout<A>(p).bytes;
    if (smem <= (size_t)kSmemBytes) break;
    if (p.TH > 1) {
      p.TH = (p.TH + 1) / 2;
    } else if (p.TW > 1) {
      p.TW = (p.TW + 1) / 2;
    } else if (p.Cb > p.CV) {
      p.Cb = (p.Cb / 2 / p.CV) * p.CV;
      if (p.Cb < p.CV) p.Cb = p.CV;
    } else if (smem <= (size_t)kSmemMax) {
      break;
    } else {
      return false;
    }
  }
  groups = p.Cb / p.CV;
  p.chunks = ceil_div(p.C, p.Cb);
  p.tiles_x = ceil_div(p.w_in, p.TW);
  p.tiles_y = ceil_div(p.h_in, p.TH);
  // threads: the larger of the two sums' item counts, at most 256
  const int rows = (int)(p.TH * (double)p.h_out / p.h_in) + 2;
  const int rows_t = rows < p.ny_cap ? rows : p.ny_cap;
  int items = (rows_t > p.TH ? rows_t : p.TH) * p.TW * groups;
  items = (items + 31) / 32 * 32;
  p.threads = items < kMaxThreads ? items : kMaxThreads;
  return true;
}

template <typename T, int CV>
int launch_cv(const T* g, T* dx, const Plan& p, unsigned blocks,
              size_t smem, cudaStream_t s) {
  if (smem > (size_t)kSmemBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        resize_bwd_kernel<T, CV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  resize_bwd_kernel<T, CV><<<blocks, p.threads, smem, s>>>(g, dx, p);
  return (int)cudaGetLastError();
}

// the current device's SM count, read at the first launch and kept (the
// port runs on one kind of card); 0 where it cannot be read
int sm_count() {
  static std::atomic<int> cached{0};
  int n = cached.load(std::memory_order_relaxed);
  if (n > 0) return n;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  cached.store(n, std::memory_order_relaxed);
  return n;
}

template <typename T>
int launch(const void* gv, void* dxv, Plan p, cudaStream_t s) {
  using A = typename Acc<T>::type;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  if (!plan<T>(p, gv, dxv, sms)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)p.N * p.chunks * p.tiles_y * p.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<A>(p).bytes;
  const T* g = static_cast<const T*>(gv);
  T* dx = static_cast<T*>(dxv);
  const unsigned nb = (unsigned)blocks;
  if (p.CV == 1) return launch_cv<T, 1>(g, dx, p, nb, smem, s);
  if constexpr (sizeof(T) < 8) {  // float64 takes CV = 1 only
    switch (p.CV) {
      case 2:
        return launch_cv<T, 2>(g, dx, p, nb, smem, s);
      case 3:
        return launch_cv<T, 3>(g, dx, p, nb, smem, s);
      case 4:
        return launch_cv<T, 4>(g, dx, p, nb, smem, s);
      case 8:
        if constexpr (sizeof(T) == 2) {
          return launch_cv<T, 8>(g, dx, p, nb, smem, s);
        }
    }
  }
  return (int)cudaErrorInvalidValue;
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
  if (N == 0) return 0;
  Plan p{};
  p.N = N;
  p.C = C;
  p.h_in = h_in;
  p.w_in = w_in;
  p.h_out = h_out;
  p.w_out = w_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, dx, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, dx, p, s);
  return launch<double>(g, dx, p, s);
}
