// Kernel A': the backward of the exact bilinear warp (kernel A), NHWC,
// deterministic.
//
// Replaces what XLA's autodiff makes of vcm_ts_tpu/ops/warp.py
// (_clamped_coords + _warp_one_gather, :31-79), the gradient of
// flow_warp / flow_warp_packed in every training step. Given the output
// gradients g_j of the packed tensors im_j and their shared flow:
//   d im_j: g x each of the four bilinear tap weights, added into the four
//           taps (the edge pad's adjoint lands on the border pixel itself,
//           since x1 = min(x0 + 1, W - 1));
//   d flow: per pixel, sum over every channel of every tensor of
//           g . d out / d(px, py), times the gradient of jnp.clip, which is
//           max-then-min: 1 inside, 0 outside, 0.5 from a bound that
//           x + u (or y + v) equals exactly; floor passes no gradient.
// Coordinates are f32 for bf16 data too, as in the forward.
//
// d im is a gather's adjoint: no output owns a source pixel, and adding
// into d im with atomics (this kernel's earlier design) gives sums whose
// order, and so whose last bits, change from run to run. Here every sum
// has an order fixed by the flow alone, so d im and d flow repeat bit for
// bit, and d im is written once, in the data's dtype (no f32 buffer, no
// zero fill, no cast):
//
// 1. Bucket (warp_bwd_hist / warp_bwd_scan / warp_bwd_scatter): each
//    output pixel is keyed by the 16x16 source tile of its plane that holds
//    its top-left tap (y0, x0), and by two edge bits: whether its right
//    taps fall in the next tile (x0 is the tile's last column and x0 + 1 <
//    W) and whether its lower taps do. A stable LSD radix sort over 8-bit
//    digits (per-block digit counts, one scan, a stable scatter whose ranks
//    come from warp match masks) lists the outputs by key, each key's
//    outputs in ascending index. One sort serves every tensor of a packed
//    call. Tiles x 4 keys take one pass up to 256 keys (SpyNet's coarse
//    levels), two up to 65536.
// 2. Accumulate (warp_bwd_bounds and warp_bwd_plan find each tile's key
//    ranges; warp_bwd_accumulate): a source tile's list is, in this order,
//    the upper-left tile's outputs with both edge bits, the upper tile's
//    with the lower bit, the left tile's with the right bit, and its own.
//    One block takes the list (or one part of it, step 4) and reads it in
//    chunks of kChunk entries, recomputes each entry's coordinates from
//    the flow, and sorts the chunk stably by its top-left tap within the
//    tile's (17 x 17) window, so each tap position has a run of outputs in
//    ascending index. Each source pixel's d im is then summed in f32 in
//    this fixed order:
//    chunk by chunk, the runs of the top-left positions (y-1, x-1),
//    (y-1, x), (y, x-1), (y, x), each run's outputs in ascending index,
//    each output's taps that land on the pixel in the order 00, 01, 10,
//    11; and written once. For a list of one chunk (nearly every tile of
//    a smooth flow) the lanes of a warp share a pixel, one 16-byte unit
//    (4 f32 or 8 bf16 channels, or one channel of a tensor not read in
//    units) each, so an output's g is one contiguous read for them, and a
//    lane needs few registers (tile_dim_lanes); a thread takes all the
//    channels of a small tensor not read in units (the frame's 3,
//    tile_dim_small). A longer list is read chunk after chunk, so a thread
//    owns a pixel and holds kAcc of its channels' sums across the chunks
//    (tile_dim, in a second kernel whose 64 registers a thread the other's
//    blocks do not pay). No two threads
//    add into one address, so there are no atomics. Each tap share is
//    rounded as in the plain version (g (1 - wy)(1 - wx) etc.,
//    __fmul_rn, no FMA), so only the order of the sums differs from it.
// 3. d flow, in the same block before the sums, for the block's own
//    outputs: G lanes (a power of two <= 32) per output, each lane summing
//    its channels in order, then a fixed shuffle tree (the earlier
//    design's arithmetic, so d flow has the same bits as before). A call
//    that needs no d im (SpyNet's warps of a frame that takes no gradient)
//    is that pass alone, over the outputs in index order: one launch.
// 4. Skew: a converging flow piles outputs into one tile. A list longer
//    than kChunk is summed chunk after chunk by its block, the sums held in
//    registers across the chunks (the block re-reads the list for every
//    kAcc channels). A list longer than kSub is cut into parts of kSub
//    entries, one block each, whose f32 sums go to scratch slots; a short
//    second pass (warp_bwd_finalize) adds each pixel's parts in part order
//    and writes d im once. The order stays fixed by the flow; nothing falls
//    back to atomics.
//
// What bounds it on H100: bytes in principle (g, the images and d im once,
// the flow a few times; the sort's keys and indices are 16-24 bytes an
// output), but latency in practice: the d im sums walk short runs of
// outputs whose g is read again, once per tap that lands in the tile, from
// L1 or L2, and the d flow step reads the images' four taps as the earlier
// design's d flow pass did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 4;  // as csrc/warp.cu
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 16, kTileW = 16;  // kTileH * kTileW == kThreads
constexpr int kWin = kTileW + 1;         // a tile's top-left window width
constexpr int kLocalKeys = (kTileH + 1) * kWin;
constexpr int kChunk = 1024;        // list entries an accumulate block holds
constexpr int kSub = 16 * kChunk;   // list entries of one part of a long list
constexpr int kSortItems = 4096;    // outputs per block of a sort pass
constexpr int kDigits = 256;        // 8-bit radix digits
constexpr int kScanThreads = 1024;
constexpr int kAcc = 16;            // d im sums (channels) a thread holds
constexpr int kAccBlocks = 4;       // accumulate blocks an SM holds (wide)
constexpr int kLaneBlocks = 5;      // and of one chunk (tile_dim_lanes)
constexpr int kSmall = 4;           // channels a thread takes of a small
                                    // tensor not read in units

struct BwdList {
  const void* src[kMaxTensors];
  const void* grad[kMaxTensors];
  void* dsrc[kMaxTensors];  // d im, the data's dtype (null: need_im == 0)
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

// one 16-byte unit stored from f32 sums (bf16: round to nearest even)
__device__ __forceinline__ void store_unit(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_unit(__nv_bfloat16* p,
                                           const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat16 lo = __float2bfloat16(v[2 * i]);
    const __nv_bfloat16 hi = __float2bfloat16(v[2 * i + 1]);
    w[i] = (unsigned)__bfloat16_as_ushort(lo) |
           ((unsigned)__bfloat16_as_ushort(hi) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// d clip(v, 0, hi) / dv, jnp.clip's rule: maximum(v, 0) then minimum(., hi),
// each giving 0.5 at a tie.
__device__ __forceinline__ float clip_grad(float v, float hi) {
  const float lo = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  const float u = fmaxf(v, 0.0f);
  return lo * (u < hi ? 1.0f : (u == hi ? 0.5f : 0.0f));
}

// an output pixel's unclamped coordinate, top-left tap and weights, as the
// forward computes them (csrc/warp.cu)
struct Coord {
  float vx, vy;  // x + u, y + v before the clamp
  int n, x0, y0;
  float ox, wx, oy, wy;  // 1 - wx, wx, 1 - wy, wy
};

template <typename TF>
__device__ __forceinline__ Coord coord(const TF* flow, int p, int H, int W) {
  Coord k;
  const int hw = H * W;
  k.n = p / hw;
  const int r = p - k.n * hw;
  const int y = r / W;
  const int x = r - y * W;
  const TF* f = flow + 2 * (long long)p;
  k.vx = __fadd_rn((float)x, to_f(f[0]));
  k.vy = __fadd_rn((float)y, to_f(f[1]));
  const float px = fminf(fmaxf(k.vx, 0.0f), (float)(W - 1));
  const float py = fminf(fmaxf(k.vy, 0.0f), (float)(H - 1));
  const float fx0 = floorf(px);
  const float fy0 = floorf(py);
  k.x0 = (int)fx0;
  k.y0 = (int)fy0;
  k.wx = __fsub_rn(px, fx0);
  k.wy = __fsub_rn(py, fy0);
  k.ox = __fsub_rn(1.0f, k.wx);
  k.oy = __fsub_rn(1.0f, k.wy);
  return k;
}

// the bucket of output p: (plane, tile) x 4 edge classes, ordered so that a
// neighbour's entries a tile needs are one contiguous key range:
// 0 none, 1 right only, 2 right and lower, 3 lower only
template <typename TF>
__device__ __forceinline__ unsigned bucket_key(const TF* flow, int p, int H,
                                               int W, int tiles_x,
                                               int tiles_y) {
  const Coord k = coord(flow, p, H, W);
  const int tx = k.x0 / kTileW;
  const int ty = k.y0 / kTileH;
  const bool right = k.x0 % kTileW == kTileW - 1 && k.x0 + 1 < W;
  const bool lower = k.y0 % kTileH == kTileH - 1 && k.y0 + 1 < H;
  const unsigned cls = right ? (lower ? 2u : 1u) : (lower ? 3u : 0u);
  return (((unsigned)k.n * tiles_y + ty) * tiles_x + tx) * 4u + cls;
}

// the share of d flow of one channel, rounded as the plain version
__device__ __forceinline__ void dflow_channel(const Coord& t, float g,
                                              float v00, float v01, float v10,
                                              float v11, float& dwx,
                                              float& dwy) {
  const float dtop = __fmul_rn(g, t.oy);
  const float dbot = __fmul_rn(g, t.wy);
  const float top = __fadd_rn(__fmul_rn(v00, t.ox), __fmul_rn(v01, t.wx));
  const float bot = __fadd_rn(__fmul_rn(v10, t.ox), __fmul_rn(v11, t.wx));
  dwx = __fadd_rn(dwx, __fadd_rn(__fmul_rn(dtop, __fsub_rn(v01, v00)),
                                 __fmul_rn(dbot, __fsub_rn(v11, v10))));
  dwy = __fadd_rn(dwy, __fmul_rn(g, __fsub_rn(bot, top)));
}

// d flow of output p by G lanes of one warp (lane = this lane's index in
// the group). Every lane of the warp must call it (the shuffles); a group
// with ok == false computes on a valid p and stores nothing. kUnits: some
// tensor is read in 16-byte units; without, the unit paths are compiled
// out, so that channel-by-channel calls (SpyNet's 3-channel levels) keep
// the registers and speed of a kernel without them.
template <typename T, typename TF, bool kUnits>
__device__ __forceinline__ void dflow_output(const BwdList& L,
                                             const TF* __restrict__ flow,
                                             TF* __restrict__ dflow, int p,
                                             bool ok, int G, int lane, int H,
                                             int W) {
  constexpr int V = Unit<T>::n;
  const Coord t = coord(flow, p, H, W);
  const int x1 = min(t.x0 + 1, W - 1);
  const int y1 = min(t.y0 + 1, H - 1);
  const long long plane = (long long)t.n * H * W;
  const long long t00 = plane + t.y0 * W + t.x0;
  const long long t01 = plane + t.y0 * W + x1;
  const long long t10 = plane + y1 * W + t.x0;
  const long long t11 = plane + y1 * W + x1;
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
    if (!kUnits || L.vec[j] == 1) {
      for (int k = lane; k < c; k += G) {
        dflow_channel(t, to_f(gp[k]), to_f(s00[k]), to_f(s01[k]),
                      to_f(s10[k]), to_f(s11[k]), dwx, dwy);
      }
      continue;
    }
    if constexpr (kUnits) {
      for (int k = lane * V; k < c; k += G * V) {
        float g[V], v00[V], v01[V], v10[V], v11[V];
        load_unit(gp + k, g);
        load_unit(s00 + k, v00);
        load_unit(s01 + k, v01);
        load_unit(s10 + k, v10);
        load_unit(s11 + k, v11);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dflow_channel(t, g[i], v00[i], v01[i], v10[i], v11[i], dwx, dwy);
        }
      }
    }
  }
  for (int o = G / 2; o >= 1; o /= 2) {
    dwx += __shfl_xor_sync(0xffffffffu, dwx, o);
    dwy += __shfl_xor_sync(0xffffffffu, dwy, o);
  }
  if (ok && lane == 0) {
    dflow[2 * (long long)p] =
        from_f<TF>(__fmul_rn(dwx, clip_grad(t.vx, (float)(W - 1))));
    dflow[2 * (long long)p + 1] =
        from_f<TF>(__fmul_rn(dwy, clip_grad(t.vy, (float)(H - 1))));
  }
}

// need_im == 0: d flow alone, one output per group of G lanes, in index
// order
template <typename T, typename TF, bool kUnits>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_kernel(BwdList L, const TF* __restrict__ flow,
                    TF* __restrict__ dflow, int npix, int H, int W, int G) {
  const int p0 = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool ok = p0 < npix;
  // out-of-range groups run on pixel npix-1 and store nothing, so that
  // every lane of the warp reaches the shuffles
  dflow_output<T, TF, kUnits>(L, flow, dflow, ok ? p0 : npix - 1, ok, G,
                              threadIdx.x % G, H, W);
}

// Stable ranks within a block: rank[i] = the number of items i' < i of the
// m items whose digit equals item i's. Warp w takes the items [w seg,
// (w+1) seg) in rounds of 32 in order; lanes with one digit find each
// other with __match_any_sync and count in the warp's histogram; then each
// digit's counts are prefixed over the warps. whist holds kWarps x nk
// counters; count (nk, or null) receives each digit's total. Every thread
// of the block calls it.
template <class Digit>
__device__ void block_rank(int m, int nk, Digit digit, uint16_t* rank,
                           uint16_t* whist, int* count) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kWarps * nk; i += kThreads) whist[i] = 0;
  __syncthreads();
  const int w = tid / 32, lane = tid % 32;
  const int seg = (m + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int lo = w * seg;
  const int hi = min(lo + seg, m);
  uint16_t* wh = whist + w * nk;
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const bool valid = i < hi;
    const unsigned mask = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const int d = digit(i);
      const unsigned peers = __match_any_sync(mask, d);
      const int before = __popc(peers & ((1u << lane) - 1u));
      const int prev = wh[d];
      rank[i] = (uint16_t)(prev + before);
      __syncwarp(mask);
      if (before == 0) wh[d] = (uint16_t)(prev + __popc(peers));
    }
    __syncwarp();
  }
  __syncthreads();
  for (int d = tid; d < nk; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int t = whist[v * nk + d];
      whist[v * nk + d] = (uint16_t)run;
      run += t;
    }
    if (count) count[d] = run;
  }
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    rank[i] = (uint16_t)(rank[i] + whist[(i / seg) * nk + digit(i)]);
  }
  __syncthreads();
}

// sort pass, 1 of 3: each block's digit counts, digit-major
// (hist[d * nblk + block]). keys_in null: the first pass, keys from the
// flow.
template <typename TF>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_hist(const TF* __restrict__ flow,
                  const unsigned* __restrict__ keys_in, int npix, int H,
                  int W, int tiles_x, int tiles_y, int shift, int nblk,
                  int* __restrict__ hist) {
  __shared__ int cnt[kDigits];
  for (int i = threadIdx.x; i < kDigits; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortItems;
  const int end = min(base + kSortItems, npix);
  for (int i = base + threadIdx.x; i < end; i += kThreads) {
    const unsigned key = keys_in ? keys_in[i]
                                 : bucket_key(flow, i, H, W, tiles_x, tiles_y);
    atomicAdd(&cnt[(key >> shift) & (kDigits - 1)], 1);  // a count: exact
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += kThreads) {
    hist[d * nblk + blockIdx.x] = cnt[d];
  }
}

// sort pass, 2 of 3: exclusive prefix sum in place, one block; warp w
// walks the w-th slice twice in coalesced rounds of 32 (a sum, then the
// scan with the slices before it as a carry)
__global__ void __launch_bounds__(kScanThreads)
    warp_bwd_scan(int* __restrict__ a, int n) {
  constexpr int kScanWarps = kScanThreads / 32;
  __shared__ int warp_sum[kScanWarps];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int per = (n + kScanThreads - 1) / kScanThreads * 32;
  const int lo = min(w * per, n);
  const int hi = min(lo + per, n);
  int s = 0;
#pragma unroll 4
  for (int i = lo + lane; i < hi; i += 32) s += a[i];
#pragma unroll
  for (int o = 16; o >= 1; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) warp_sum[w] = s;
  __syncthreads();
  if (w == 0) {
    const int v = warp_sum[lane];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    warp_sum[lane] = incl - v;  // exclusive over the warps' slices
  }
  __syncthreads();
  int carry = warp_sum[w];
#pragma unroll 4
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const int v = i < hi ? a[i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (i < hi) a[i] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// sort pass, 3 of 3: every output to offs[digit][block] + its stable rank
// among the block's outputs of that digit
template <typename TF>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_scatter(const TF* __restrict__ flow,
                     const unsigned* __restrict__ keys_in,
                     const int* __restrict__ vals_in,
                     unsigned* __restrict__ keys_out,
                     int* __restrict__ vals_out, int npix, int H, int W,
                     int tiles_x, int tiles_y, int shift, int nblk,
                     const int* __restrict__ offs) {
  __shared__ unsigned s_key[kSortItems];
  __shared__ uint16_t s_rank[kSortItems];
  __shared__ uint16_t whist[kWarps * kDigits];
  const int base = blockIdx.x * kSortItems;
  const int m = min(kSortItems, npix - base);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    s_key[i] = keys_in ? keys_in[base + i]
                       : bucket_key(flow, base + i, H, W, tiles_x, tiles_y);
  }
  __syncthreads();
  auto digit = [&](int i) { return (int)((s_key[i] >> shift) & (kDigits - 1)); };
  block_rank(m, kDigits, digit, s_rank, whist, nullptr);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int pos = offs[digit(i) * nblk + blockIdx.x] + s_rank[i];
    keys_out[pos] = s_key[i];
    vals_out[pos] = keys_in ? vals_in[base + i] : base + i;
  }
}

// a chunk of a tile's list in shared memory, sorted by top-left tap
struct Chunk {
  int p[kChunk];          // output index
  float4 w[kChunk];       // (1 - wx, wx, 1 - wy, wy)
  uint16_t key[kChunk];   // top-left tap in the tile's window
  uint16_t rank[kChunk];
  uint16_t perm[kChunk];  // sorted position -> chunk entry
  uint16_t whist[kWarps * kLocalKeys];
  int start[kLocalKeys + 1];  // each window position's run
};

// entries [first, first + m) of the tile's list (ranges r = 0..3 of the
// sorted outputs, rng[2r] .. rng[2r+1]) into ck, sorted stably by top-left
// tap; ends with a barrier
template <typename TF>
__device__ void load_chunk(Chunk& ck, const int* rng, const int* vals,
                           const TF* flow, int first, int m, int H, int W,
                           int row0, int col0) {
  for (int i = threadIdx.x; i < m; i += kThreads) {
    int q = first + i, r = 0;
    while (q >= rng[2 * r + 1] - rng[2 * r]) {
      q -= rng[2 * r + 1] - rng[2 * r];
      ++r;
    }
    const int p = vals[rng[2 * r] + q];
    const Coord k = coord(flow, p, H, W);
    ck.p[i] = p;
    ck.w[i] = make_float4(k.ox, k.wx, k.oy, k.wy);
    ck.key[i] = (uint16_t)((k.y0 - row0) * kWin + (k.x0 - col0));
  }
  __syncthreads();
  auto digit = [&](int i) { return (int)ck.key[i]; };
  block_rank(m, kLocalKeys, digit, ck.rank, ck.whist, ck.start);
  if (threadIdx.x < 32) {  // exclusive scan of the counts, one warp
    constexpr int per = (kLocalKeys + 31) / 32;
    const int lane = threadIdx.x;
    int s = 0;
    for (int k = lane * per; k < min((lane + 1) * per, kLocalKeys); ++k) {
      s += ck.start[k];
    }
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - s;
    for (int k = lane * per; k < min((lane + 1) * per, kLocalKeys); ++k) {
      const int v = ck.start[k];
      ck.start[k] = run;
      run += v;
    }
    if (lane == 31) ck.start[kLocalKeys] = incl;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    ck.perm[ck.start[ck.key[i]] + ck.rank[i]] = (uint16_t)i;
  }
  __syncthreads();
}

// adds into acc the chunk's contributions to pixel (sy, sx) (window
// position (py + 1, px + 1)) for units u0 .. u0 + nu - 1, in the fixed
// order of the note; the units' loads of one output are independent, so
// they are in flight together
template <typename T, int V, int UG, bool kScalar = false>
__device__ __forceinline__ void add_pixel(const Chunk& ck, const T* gp,
                                          int c, int u0, int nu, int py,
                                          int px, bool xe, bool ye,
                                          float (&acc)[UG][V]) {
  const int k0 = py * kWin + px;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + (q >> 1) * kWin + (q & 1);
    const int e_end = ck.start[k + 1];
    for (int s = ck.start[k]; s < e_end; ++s) {
      const int e = ck.perm[s];
      const float4 t = ck.w[e];  // (ox, wx, oy, wy)
      const T* row = gp + (long long)ck.p[e] * c + u0 * V;
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        if (u >= nu) break;
        float g[V];
        if constexpr (kScalar) {  // the c < V channels of a small tensor
#pragma unroll
          for (int v = 0; v < V; ++v) g[v] = v < c ? to_f(row[v]) : 0.0f;
        } else if constexpr (V == 1) {
          g[0] = to_f(row[u]);
        } else {
          load_unit(row + u * V, g);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float dtop = __fmul_rn(g[v], t.z);
          const float dbot = __fmul_rn(g[v], t.w);
          float a = acc[u][v];
          if (q == 0) {  // top-left at (y-1, x-1): tap 11
            a = __fadd_rn(a, __fmul_rn(dbot, t.y));
          } else if (q == 1) {  // (y-1, x): tap 10, and 11 at the last column
            a = __fadd_rn(a, __fmul_rn(dbot, t.x));
            if (xe) a = __fadd_rn(a, __fmul_rn(dbot, t.y));
          } else if (q == 2) {  // (y, x-1): tap 01, and 11 at the last row
            a = __fadd_rn(a, __fmul_rn(dtop, t.y));
            if (ye) a = __fadd_rn(a, __fmul_rn(dbot, t.y));
          } else {  // (y, x): tap 00, and those the edge pad folds onto it
            a = __fadd_rn(a, __fmul_rn(dtop, t.x));
            if (xe) a = __fadd_rn(a, __fmul_rn(dtop, t.y));
            if (ye) a = __fadd_rn(a, __fmul_rn(dbot, t.x));
            if (xe && ye) a = __fadd_rn(a, __fmul_rn(dbot, t.y));
          }
          acc[u][v] = a;
        }
      }
    }
  }
}

// d im of tensor j for the list positions [first, first + len) of the
// tile, longer than one chunk: thread i owns pixel i of the tile and sums
// kAcc channels at a time
// (UG units of V channels; V == 1: channel by channel), chunk after chunk,
// then writes them once: into d im in the data's dtype, or, with part
// (one part of a split list), as f32 into part (the tile's 256 pixels x
// csum channels; tensor j from channel choff)
template <typename T, typename TF, int V>
__device__ void tile_dim(Chunk& ck, const BwdList& L, int j, const int* rng,
                         const int* vals, const TF* flow, int first, int len,
                         int H, int W, int n, int ty, int tx, float* part,
                         int csum, int choff) {
  constexpr int UG = kAcc / V;
  const int c = L.c[j];
  const int units = c / V;
  const T* gp = static_cast<const T*>(L.grad[j]);
  T* dst = static_cast<T*>(L.dsrc[j]);
  const int nchunks = (len + kChunk - 1) / kChunk;
  const int py = threadIdx.x / kTileW, px = threadIdx.x % kTileW;
  const int sy = ty * kTileH + py, sx = tx * kTileW + px;
  const bool inside = sy < H && sx < W;
  T* out = dst + (((long long)n * H + sy) * W + sx) * c;
  float* pout = part ? part + threadIdx.x * csum + choff : nullptr;
  for (int u0 = 0; u0 < units; u0 += UG) {
    const int nu = min(UG, units - u0);
    float acc[UG][V];
#pragma unroll
    for (int u = 0; u < UG; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[u][v] = 0.0f;
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      __syncthreads();
      load_chunk(ck, rng, vals, flow, first + ch * kChunk,
                 min(kChunk, len - ch * kChunk), H, W, ty * kTileH - 1,
                 tx * kTileW - 1);
      if (inside) {
        add_pixel<T, V, UG>(ck, gp, c, u0, nu, py, px, sx == W - 1,
                            sy == H - 1, acc);
      }
    }
#pragma unroll
    for (int u = 0; u < UG; ++u) {
      if (u >= nu) break;
      if (part) {
#pragma unroll
        for (int v = 0; v < V; ++v) pout[(u0 + u) * V + v] = acc[u][v];
      } else if (inside) {
        if constexpr (V == 1) {
          out[u0 + u] = from_f<T>(acc[u][0]);
        } else {
          store_unit(out + (u0 + u) * V, acc[u]);
        }
      }
    }
  }
}

// d im of tensor j for the tile, its list in one chunk: P lanes (a power
// of two, up to 32) take the units of V channels of one pixel (V == 1:
// its channels), so a pixel's loads of an output's g are one contiguous
// read, and each lane sums its unit in the fixed order of add_pixel
template <typename T, int V>
__device__ void tile_dim_lanes(const Chunk& ck, const BwdList& L, int j,
                               int H, int W, int n, int ty, int tx,
                               float* part, int csum, int choff) {
  const int c = L.c[j];
  const int units = c / V;
  int P = 1;
  while (P < units && P < 32) P *= 2;
  const int lane = threadIdx.x % P;
  const T* gp = static_cast<const T*>(L.grad[j]);
  T* dst = static_cast<T*>(L.dsrc[j]);
  for (int u0 = 0; u0 < units; u0 += P) {
    const int u = u0 + lane;
    for (int p0 = 0; p0 < kThreads; p0 += kThreads / P) {
      const int pix = p0 + threadIdx.x / P;
      const int py = pix / kTileW, px = pix % kTileW;
      const int sy = ty * kTileH + py, sx = tx * kTileW + px;
      if (u >= units || sy >= H || sx >= W) continue;
      float acc[1][V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[0][v] = 0.0f;
      add_pixel<T, V, 1>(ck, gp, c, u, 1, py, px, sx == W - 1, sy == H - 1,
                         acc);
      if (part) {
        float* q = part + pix * csum + choff + u * V;
#pragma unroll
        for (int v = 0; v < V; ++v) q[v] = acc[0][v];
      } else {
        T* q = dst + (((long long)n * H + sy) * W + sx) * c + u * V;
        if constexpr (V == 1) {
          *q = from_f<T>(acc[0][0]);
        } else {
          store_unit(q, acc[0]);
        }
      }
    }
  }
}

// d im of a tensor of c <= kSmall channels not read in units (the 3
// channels of a frame), its list in one chunk: a thread takes all the
// channels of one pixel, so the tile's runs are walked once
template <typename T>
__device__ void tile_dim_small(const Chunk& ck, const BwdList& L, int j,
                               int H, int W, int n, int ty, int tx,
                               float* part, int csum, int choff) {
  const int c = L.c[j];
  const int py = threadIdx.x / kTileW, px = threadIdx.x % kTileW;
  const int sy = ty * kTileH + py, sx = tx * kTileW + px;
  if (sy >= H || sx >= W) return;
  float acc[1][kSmall];
#pragma unroll
  for (int v = 0; v < kSmall; ++v) acc[0][v] = 0.0f;
  add_pixel<T, kSmall, 1, true>(ck, static_cast<const T*>(L.grad[j]), c, 0,
                                1, py, px, sx == W - 1, sy == H - 1, acc);
  T* q = static_cast<T*>(L.dsrc[j]) + (((long long)n * H + sy) * W + sx) * c;
  float* pq = part ? part + threadIdx.x * csum + choff : nullptr;
#pragma unroll
  for (int v = 0; v < kSmall; ++v) {
    if (v >= c) break;
    if (pq) {
      pq[v] = acc[0][v];
    } else {
      q[v] = from_f<T>(acc[0][v]);
    }
  }
}

// one thread per sorted position i (and i == npix): the keys k in
// (keys[i-1], keys[i]] start at i, so kstart[k] is the first position of
// key k or of the next key present (kstart[nkeys] = npix)
__global__ void __launch_bounds__(kThreads)
    warp_bwd_bounds(const unsigned* __restrict__ keys, int npix,
                    unsigned nkeys, int* __restrict__ kstart) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > npix) return;
  const unsigned hi = i < npix ? keys[i] : nkeys;
  for (unsigned k = i > 0 ? keys[i - 1] + 1 : 0; k <= hi; ++k) kstart[k] = i;
}

// one thread per tile: its list's four ranges of the sorted outputs (in
// list order: the upper-left tile's class 2, the upper tile's classes 2-3,
// the left tile's 1-2, the tile's own 0-3) into plan[8 tile ..], and its
// count of parts (kSub list entries each) into parts[tile] and, where the
// list is split, into split[tile] (else 0)
__global__ void __launch_bounds__(kThreads)
    warp_bwd_plan(const int* __restrict__ kstart, int tiles_x, int tiles_y,
                  int n_tiles, int* __restrict__ plan,
                  int* __restrict__ parts, int* __restrict__ split) {
  const int tile = blockIdx.x * kThreads + threadIdx.x;
  if (tile >= n_tiles) return;
  const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
  const bool has[4] = {tx > 0 && ty > 0, ty > 0, tx > 0, true};
  const unsigned t[4] = {(unsigned)(tile - tiles_x - 1),
                         (unsigned)(tile - tiles_x), (unsigned)(tile - 1),
                         (unsigned)tile};
  const unsigned lo_cls[4] = {2, 2, 1, 0}, hi_cls[4] = {3, 4, 3, 4};
  int len = 0;
  for (int r = 0; r < 4; ++r) {
    const int lo = has[r] ? kstart[4u * t[r] + lo_cls[r]] : 0;
    const int hi = has[r] ? kstart[4u * t[r] + hi_cls[r]] : 0;
    plan[8 * tile + 2 * r] = lo;
    plan[8 * tile + 2 * r + 1] = hi;
    len += hi - lo;
  }
  const int n = max(1, (len + kSub - 1) / kSub);
  parts[tile] = n;
  split[tile] = n > 1 ? n : 0;
}

// one block per (tile, part): the part's list positions [part kSub, ..);
// d flow of the tile's own outputs among them, then d im of the tile's
// source pixels for every tensor, into d im or, for a split list, into the
// part's f32 slot (partial + (split_base[tile] + part) 256 csum). kWide:
// the blocks whose part is longer than one chunk (tile_dim, 16 sums a
// thread held across the chunks, kAccBlocks blocks an SM); else those of
// one chunk (tile_dim_lanes, a few registers a thread, more blocks an SM).
// Both kernels run over every block, each taking its own.
template <typename T, typename TF, bool kUnits, bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? kAccBlocks : kLaneBlocks)
    warp_bwd_accumulate(BwdList L, const TF* __restrict__ flow,
                        TF* __restrict__ dflow, const int* __restrict__ vals,
                        const int* __restrict__ plan,
                        const int* __restrict__ part_base,
                        const int* __restrict__ split_base,
                        float* __restrict__ partial, int n_tiles, int H,
                        int W, int tiles_x, int tiles_y, int G, int csum) {
  __shared__ Chunk ck;
  __shared__ int rng[8];
  // the tile whose parts hold this block: the last with part_base <= b
  int lo = 0, hi = n_tiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (part_base[mid] <= (int)blockIdx.x) lo = mid;
    else hi = mid;
  }
  const int tile = lo;
  const int part = blockIdx.x - part_base[tile];
  if (threadIdx.x < 8) rng[threadIdx.x] = plan[8 * tile + threadIdx.x];
  __syncthreads();
  const int own_start = (rng[1] - rng[0]) + (rng[3] - rng[2]) +
                        (rng[5] - rng[4]);
  const int list_len = own_start + rng[7] - rng[6];
  const int nparts = max(1, (list_len + kSub - 1) / kSub);
  if (part >= nparts) return;  // past the last tile's parts
  const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
  const int n = tile / (tiles_x * tiles_y);
  const int first = part * kSub;
  const int len = min(kSub, list_len - first);
  const bool loaded = len <= kChunk;
  if (loaded == kWide) return;  // the other kernel's block
  // d flow of the own outputs at list positions [first, first + len)
  const int a0 = max(first, own_start), a1 = first + len;
  const int groups = kThreads / G;
  for (int b = a0; b < a1; b += groups) {
    const int e = b + threadIdx.x / G;
    const bool ok = e < a1;
    dflow_output<T, TF, kUnits>(L, flow, dflow,
                                vals[rng[6] + (ok ? e : a0) - own_start], ok,
                                G, threadIdx.x % G, H, W);
  }
  if (loaded) {
    load_chunk(ck, rng, vals, flow, first, len, H, W, ty * kTileH - 1,
               tx * kTileW - 1);
  }
  float* out = nparts > 1
                   ? partial + (long long)(split_base[tile] + part) *
                                   kThreads * csum
                   : nullptr;
  int choff = 0;
  for (int j = 0; j < L.n; ++j) {
    const bool units = kUnits && L.vec[j] != 1;
    if constexpr (kWide) {
      if (units) {
        if constexpr (kUnits) {
          tile_dim<T, TF, Unit<T>::n>(ck, L, j, rng, vals, flow, first, len,
                                      H, W, n, ty, tx, out, csum, choff);
        }
      } else {
        tile_dim<T, TF, 1>(ck, L, j, rng, vals, flow, first, len, H, W, n,
                           ty, tx, out, csum, choff);
      }
    } else {
      if (units) {
        if constexpr (kUnits) {
          tile_dim_lanes<T, Unit<T>::n>(ck, L, j, H, W, n, ty, tx, out, csum,
                                        choff);
        }
      } else if (L.c[j] <= kSmall) {
        tile_dim_small<T>(ck, L, j, H, W, n, ty, tx, out, csum, choff);
      } else {
        tile_dim_lanes<T, 1>(ck, L, j, H, W, n, ty, tx, out, csum, choff);
      }
    }
    choff += L.c[j];
  }
}

// one block per tile whose list was split: each pixel's channels, the sum
// of its parts' f32 slots in part order, written once in the data's dtype
template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_finalize(BwdList L, const int* __restrict__ plan,
                      const int* __restrict__ split_base,
                      const float* __restrict__ partial, int H, int W,
                      int tiles_x, int tiles_y, int csum) {
  const int tile = blockIdx.x;
  const int* rng = plan + 8 * tile;
  const int list_len = (rng[1] - rng[0]) + (rng[3] - rng[2]) +
                       (rng[5] - rng[4]) + (rng[7] - rng[6]);
  const int nparts = (list_len + kSub - 1) / kSub;
  if (nparts <= 1) return;
  const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
  const int n = tile / (tiles_x * tiles_y);
  const int sy = ty * kTileH + threadIdx.x / kTileW;
  const int sx = tx * kTileW + threadIdx.x % kTileW;
  if (sy >= H || sx >= W) return;
  const float* p0 = partial + ((long long)split_base[tile] * kThreads +
                               threadIdx.x) * csum;
  const long long pix = ((long long)n * H + sy) * W + sx;
  int choff = 0;
  for (int j = 0; j < L.n; ++j) {
    T* out = static_cast<T*>(L.dsrc[j]) + pix * L.c[j];
    for (int k = 0; k < L.c[j]; ++k) {
      float a = p0[choff + k];
      for (int q = 1; q < nparts; ++q) {
        a = __fadd_rn(a, p0[(long long)q * kThreads * csum + choff + k]);
      }
      out[k] = from_f<T>(a);
    }
    choff += L.c[j];
  }
}

// The scratch of a call with d im (the wrapper allocates it), in int32
// units: two key and two index arrays of N*H*W, 256 digit counts per block
// of 4096 outputs, each key's first position (4 a tile, and one), the
// tiles' plans (8 each) and part counts (2 each), then the f32 slots of
// split lists, 16-byte aligned: a list of len > kSub
// entries has ceil(len / kSub) < 2 len / kSub parts and the lists hold at
// most 4 N*H*W entries, so there are under 8 N*H*W / kSub slots of 256
// pixels x csum channels. ops/warp.py:warp_bwd_scratch_bytes mirrors it.
struct Layout {
  long long vals, hist, kstart, plan, part_base, split_base, partial, bytes;
};

Layout layout(int N, int H, int W, int csum) {
  const long long npix = (long long)N * H * W;
  const long long nblk = (npix + kSortItems - 1) / kSortItems;
  const long long n_tiles = (long long)N * ((H + kTileH - 1) / kTileH) *
                            ((W + kTileW - 1) / kTileW);
  Layout o;
  o.vals = 2 * npix;
  o.hist = 4 * npix;
  o.kstart = o.hist + kDigits * nblk;
  o.plan = o.kstart + 4 * n_tiles + 1;
  o.part_base = o.plan + 8 * n_tiles;
  o.split_base = o.part_base + n_tiles;
  o.partial = (o.split_base + n_tiles + 3) / 4 * 4;
  o.bytes = 4 * (o.partial + (8 * npix / kSub + 1) * kThreads * csum);
  return o;
}

struct Scratch {
  unsigned* keys;
  int *vals, *hist, *kstart, *plan, *part_base, *split_base;
  float* partial;
};

Scratch carve(char* base, int N, int H, int W, int csum) {
  const Layout o = layout(N, H, W, csum);
  int* p = reinterpret_cast<int*>(base);
  return {reinterpret_cast<unsigned*>(p), p + o.vals, p + o.hist,
          p + o.kstart, p + o.plan, p + o.part_base, p + o.split_base,
          reinterpret_cast<float*>(p + o.partial)};
}

int csum_of(const BwdList& L) {
  int c = 0;
  for (int j = 0; j < L.n; ++j) c += L.c[j];
  return c;
}

template <typename T, typename TF>
cudaError_t launch(const BwdList& L, const void* flow_v, void* dflow_v,
                   int N, int H, int W, int G, int need_im, char* scratch,
                   cudaStream_t s) {
  const TF* flow = static_cast<const TF*>(flow_v);
  TF* dflow = static_cast<TF*>(dflow_v);
  const int npix = N * H * W;
  bool units = false;
  for (int j = 0; j < L.n; ++j) units = units || L.vec[j] != 1;
  if (!need_im) {
    const int pix = kThreads / G;
    const unsigned blocks = (unsigned)((npix + pix - 1) / pix);
    if (units) {
      warp_bwd_kernel<T, TF, true>
          <<<blocks, kThreads, 0, s>>>(L, flow, dflow, npix, H, W, G);
    } else {
      warp_bwd_kernel<T, TF, false>
          <<<blocks, kThreads, 0, s>>>(L, flow, dflow, npix, H, W, G);
    }
    return cudaGetLastError();
  }
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const long long nkeys = 4LL * N * tiles_x * tiles_y;
  int passes = 1;
  while ((1LL << (8 * passes)) < nkeys) ++passes;
  const int nblk = (npix + kSortItems - 1) / kSortItems;
  const int csum = csum_of(L);
  const Scratch sc = carve(scratch, N, H, W, csum);
  unsigned* keys[2] = {sc.keys, sc.keys + npix};
  int* vals[2] = {sc.vals, sc.vals + npix};
  int* hist = sc.hist;
  const unsigned* kin = nullptr;
  const int* vin = nullptr;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 8 * pass;
    unsigned* kout = keys[pass % 2];
    int* vout = vals[pass % 2];
    warp_bwd_hist<TF><<<nblk, kThreads, 0, s>>>(flow, kin, npix, H, W,
                                                 tiles_x, tiles_y, shift,
                                                 nblk, hist);
    warp_bwd_scan<<<1, kScanThreads, 0, s>>>(hist, kDigits * nblk);
    warp_bwd_scatter<TF><<<nblk, kThreads, 0, s>>>(
        flow, kin, vin, kout, vout, npix, H, W, tiles_x, tiles_y, shift,
        nblk, hist);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    kin = kout;
    vin = vout;
  }
  const int n_tiles = N * tiles_x * tiles_y;
  warp_bwd_bounds<<<npix / kThreads + 1, kThreads, 0, s>>>(
      kin, npix, (unsigned)nkeys, sc.kstart);
  warp_bwd_plan<<<(n_tiles + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      sc.kstart, tiles_x, tiles_y, n_tiles, sc.plan, sc.part_base,
      sc.split_base);
  warp_bwd_scan<<<1, kScanThreads, 0, s>>>(sc.part_base, n_tiles);
  warp_bwd_scan<<<1, kScanThreads, 0, s>>>(sc.split_base, n_tiles);
  // at most one block per tile, plus one per kSub entries of the lists
  // (an output is in at most four lists)
  const long long blocks = n_tiles + 4LL * npix / kSub + 1;
  using Kernel = decltype(&warp_bwd_accumulate<T, TF, true, false>);
  const Kernel kernels[2] = {
      units ? warp_bwd_accumulate<T, TF, true, false>
            : warp_bwd_accumulate<T, TF, false, false>,
      units ? warp_bwd_accumulate<T, TF, true, true>
            : warp_bwd_accumulate<T, TF, false, true>};
  for (const Kernel kernel : kernels) {
    kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        L, flow, dflow, vin, sc.plan, sc.part_base, sc.split_base,
        sc.partial, n_tiles, H, W, tiles_x, tiles_y, G, csum);
  }
  warp_bwd_finalize<T><<<n_tiles, kThreads, 0, s>>>(
      L, sc.plan, sc.split_base, sc.partial, H, W, tiles_x, tiles_y, csum);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// src/grad: n_tensors NHWC tensors (N, H, W, c[j]) of one dtype; dsrc: d im
// of the same shapes and dtype, every element written (ignored when
// need_im == 0); flow / dflow: (N, H, W, 2) in flow_dtype. dtype /
// flow_dtype: 0 float32, 1 bfloat16. scratch: layout()'s bytes
// (ignored when need_im == 0). Returns the first launch's cudaError_t that
// is not cudaSuccess.
extern "C" int vcm_warp_bwd(const void* const* src, const void* const* grad,
                            void* const* dsrc, const int* c, int n_tensors,
                            const void* flow, void* dflow, int N, int H,
                            int W, int dtype, int flow_dtype, int need_im,
                            void* scratch, long long scratch_bytes,
                            void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || (dtype != 0 && dtype != 1) ||
      (flow_dtype != 0 && flow_dtype != 1) ||
      4LL * N * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int npix = N * H * W;
  if (npix == 0) return 0;
  int csum = 0;
  for (int j = 0; j < n_tensors; ++j) csum += c[j];
  if (need_im && (scratch == nullptr || !aligned16(scratch) ||
                  scratch_bytes < layout(N, H, W, csum).bytes)) {
    return (int)cudaErrorInvalidValue;
  }
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
    L.dsrc[j] = need_im ? dsrc[j] : nullptr;
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
  char* scr = static_cast<char*>(scratch);
  if (dtype == 0) {
    return (int)(flow_dtype == 0
                     ? launch<float, float>(L, flow, dflow, N, H, W, g,
                                            need_im, scr, s)
                     : launch<float, __nv_bfloat16>(L, flow, dflow, N, H, W,
                                                    g, need_im, scr, s));
  }
  return (int)(flow_dtype == 0
                   ? launch<__nv_bfloat16, float>(L, flow, dflow, N, H, W, g,
                                                  need_im, scr, s)
                   : launch<__nv_bfloat16, __nv_bfloat16>(
                         L, flow, dflow, N, H, W, g, need_im, scr, s));
}
