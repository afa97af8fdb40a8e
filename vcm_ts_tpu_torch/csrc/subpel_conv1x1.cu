// Kernel B: fused 1x1 convolution + pixel shuffle, NHWC.
//
// Replaces vcm_ts_tpu/ops/subpel_pallas.py::_conv1x1_kernel (via
// _conv1x1_impl / subpel_conv1x1): out = pixel_shuffle(conv1x1(x, w, b), r)
// in torch channel order; sums in f32, the bias added in f32, one rounding
// to the output dtype, and the conv output never written to device memory.
//
// Inputs: x (M = N*H*W pixels, K = Cin) row-major (NHWC); weights k-major
// (r*r, Cin, C), bias (r*r, C); column j = (dy*r + dx)*C + c of the GEMM
// lands at out[n, h*r + dy, w*r + dx, c]. For a fixed pixel and dy, the
// r*C columns [dy*r*C, (dy+1)*r*C) land on one contiguous run of the
// output row h*r + dy, and the runs of neighbouring pixels of one image
// row follow each other (the JAX kernel's dy grid axis).
//
// What bounds it on H100: in bf16, bytes everywhere on the main path (43
// flops/byte at 64 -> 32, at most about 230 at 288 -> 288, against the 295
// at which the bf16 tensor cores become the limit). In f32 without tensor
// cores (TF32 would break f32 parity), the FMA rate from about 20 flops per
// byte up, i.e. at every main-path width but the narrow 64 -> 2.
//
// Design. The configuration (path, tile sizes, sum order) is chosen from
// (Cin, C, r, dtype) alone, never from N, H, W or the card, there is no
// split-K and no atomic, so every output element is summed in one fixed
// order and a pixel's bits do not depend on the tensor around it. Only the
// number of tiles one block walks follows the tensor's size, which moves
// no sum.
// - Tiled paths (r*r*C > 16). A block owns a column slice of BN columns
//   that never crosses a dy plane (all of r*C, or a slice of it) and walks
//   up to kMaxTilesPerBlock tiles of BM consecutive pixels (fewer when the
//   tensor is too small to fill the card that way). Its weight slice (K x BN)
//   and bias stay in shared memory; x tiles stream through two buffers of
//   16-byte cp.async copies in k-chunks, so the next chunk (of this tile or
//   the next one) loads while the current one computes. The slice index is
//   the fastest grid axis, so the blocks that read one x tile run together
//   and all but the first find it in L2.
//   * bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32
//     accumulate), operands from shared memory by ldmatrix; 128-pixel tiles,
//     k-chunks of 64 (32 where 64 would cost a block per SM). mma.sync and
//     not wgmma: the kernel is bound by bytes, so it needs a small share of
//     the tensor cores' rate, which 8 warps of mma.sync on 32 x BN/2 tiles
//     give without wgmma's shared-memory descriptors and warpgroup
//     constraints. The epilogue adds the bias in f32, rounds once, stages
//     the tile in shared memory and stores 16-byte vectors along the output
//     rows.
//   * f32: plain FMA with 8 x 8 (4 x 8 at BN <= 64) register tiles read as
//     16-byte vectors from shared memory, k-chunks of 32 (16 at BN = 32);
//     each thread's columns are two runs of 4, stored straight from
//     registers as 16-byte vectors (8 lanes write 128 contiguous bytes of
//     one output run).
// - Narrow path (r*r*C <= 16, e.g. 64 -> 2: 8 columns). Work scales with the
//   columns that exist: a block stages its pixels' x rows in shared memory
//   by coalesced 16-byte copies, then one thread per pixel keeps one f32
//   sum per column; bound by reading x once.
// Where K, C or a pointer does not allow 16-byte vectors, the same tiles
// are filled and stored element by element (same sums, slower copies).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kStages = 2;  // double-buffered x chunks
constexpr int kMaxTilesPerBlock = 8;  // as far as kMinBlocks blocks remain
constexpr int kMinBlocks = 256;
constexpr int kMmaBM = 128;  // pixels of a bf16 tile
constexpr size_t kSmemPerSM = 228 * 1024;  // H100 (1 KB of it per block)
constexpr int kFmaBK = 32;  // k-chunk of the f32 path (16 at BN = 32)

struct Shape {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  int M, K, C, r, H, W;
  int rc;      // r*C: columns of one dy plane row
  int nsl;     // column slices per dy plane
  int ntiles;  // pixel tiles
  int tpb;     // tiles per block (tiled_grid)
  int kp;      // K rounded up to the k-chunk (tiled paths)
  int xvec;    // x rows load as 16-byte vectors
  int wvec;    // weight rows load as 16-byte vectors
  int ovec;    // output runs store as 16-byte vectors
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy global -> shared; zero-fills when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Element offset in out of pixel m's run for plane row dy, column s0.
__device__ __forceinline__ long long out_base(const Shape& S, int m, int dy,
                                              int s0) {
  const int hw = S.H * S.W;
  const int n = m / hw;
  const int rem = m - n * hw;
  const int h = rem / S.W;
  const int w = rem - h * S.W;
  return (((long long)n * S.H + h) * S.r + dy) * (long long)S.W * S.rc +
         (long long)w * S.rc + s0;
}

// x rows m0 .. m0+BM-1, columns k0 .. k0+BK-1 -> xs[row][LDX] (zero beyond
// M and K); asynchronous when vectors apply.
template <typename T, int BM, int BK, int LDX>
__device__ __forceinline__ void load_x(const Shape& S, T* xs, int m0,
                                       int k0) {
  const T* x = static_cast<const T*>(S.x);
  if (S.xvec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = BK / V;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < BM * CPR; i += kThreads) {
      const int row = i / CPR;
      const int part = i - row * CPR;
      const int m = m0 + row;
      const int k = k0 + part * V;
      const bool ok = m < S.M && k < S.K;
      cp_async16(xs + row * LDX + part * V,
                 ok ? x + (long long)m * S.K + k : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int row = i / BK;
      const int kk = i - row * BK;
      const int m = m0 + row;
      const int k = k0 + kk;
      xs[row * LDX + kk] = (m < S.M && k < S.K)
                               ? x[(long long)m * S.K + k]
                               : from_f<T>(0.0f);
    }
  }
}

// The block's weight slice ws[k][LDW] (k < kp, zero beyond K and r*C) and
// bias slice bs[BN] (f32), for plane row dy, columns s0 .. s0+BN-1; the
// weights asynchronously when vectors apply (the caller commits them).
template <typename T, int BN, int LDW>
__device__ __forceinline__ void load_w(const Shape& S, T* ws, float* bs,
                                       int dy, int s0) {
  const T* w = static_cast<const T*>(S.w);
  const T* b = static_cast<const T*>(S.b);
  if (S.wvec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = BN / V;
    for (int i = threadIdx.x; i < S.kp * CPR; i += kThreads) {
      const int k = i / CPR;
      const int n = (i - k * CPR) * V;
      const int sc = s0 + n;
      const bool ok = k < S.K && sc < S.rc;
      const int dx = ok ? sc / S.C : 0;
      const int c = sc - dx * S.C;
      cp_async16(ws + k * LDW + n,
                 ok ? w + ((long long)(dy * S.r + dx) * S.K + k) * S.C + c
                    : w,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < S.kp * BN; i += kThreads) {
      const int k = i / BN;
      const int n = i - k * BN;
      const int sc = s0 + n;
      T v = from_f<T>(0.0f);
      if (k < S.K && sc < S.rc) {
        const int dx = sc / S.C;
        const int c = sc - dx * S.C;
        v = w[((long long)(dy * S.r + dx) * S.K + k) * S.C + c];
      }
      ws[k * LDW + n] = v;
    }
  }
  for (int n = threadIdx.x; n < BN; n += kThreads) {
    const int sc = s0 + n;
    float v = 0.0f;
    if (sc < S.rc) {
      const int dx = sc / S.C;
      v = to_f(b[(dy * S.r + dx) * S.C + sc - dx * S.C]);
    }
    bs[n] = v;
  }
}

// ----------------------------------------------------------- bf16, mma.sync
__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* d, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory of a bf16 tile configuration: the x buffers, the weight
// slice, the output tile, the bias and the pixels' output offsets.
size_t mma_smem(int bn, int bk, int kp) {
  return sizeof(bf16) * ((size_t)kStages * kMmaBM * (bk + 8) +
                         (size_t)kp * (bn + 8) + (size_t)kMmaBM * (bn + 8)) +
         sizeof(float) * bn + sizeof(long long) * kMmaBM;
}

template <int BN, int BK_>
struct MmaCfg {
  static constexpr int BM = kMmaBM, BK = BK_;
  static constexpr int LDX = BK + 8, LDW = BN + 8, LDO = BN + 8;
};

// 8 warps as 4 (pixels) x 2 (columns); a warp owns 32 x BN/2 of the tile.
// BK: the k-chunk, 32 or 64 (two or four mma k-steps).
template <int BN, int BK_>
__global__ void __launch_bounds__(kThreads) conv_mma_bf16(Shape S) {
  using Cfg = MmaCfg<BN, BK_>;
  constexpr int BM = Cfg::BM, BK = Cfg::BK, LDX = Cfg::LDX, LDW = Cfg::LDW,
                LDO = Cfg::LDO;
  constexpr int WN = BN / 2, MT = 2, NT = WN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + kStages * BM * LDX;
  bf16* os = ws + S.kp * LDW;
  float* bs = reinterpret_cast<float*>(os + BM * LDO);
  long long* pb = reinterpret_cast<long long*>(bs + BN);

  const int slice = blockIdx.x % (S.r * S.nsl);  // fastest: see the note
  const int dy = slice / S.nsl;
  const int s0 = (slice - dy * S.nsl) * BN;
  const int t0 = blockIdx.x / (S.r * S.nsl) * S.tpb;
  const int nk = S.kp / BK;
  const int total = min(S.tpb, S.ntiles - t0) * nk;

  // the weight slice's copies join the first x chunk's group
  load_w<bf16, BN, LDW>(S, ws, bs, dy, s0);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      load_x<bf16, BM, BK, LDX>(S, xs + s * BM * LDX, (t0 + s / nk) * BM,
                                (s % nk) * BK);
    }
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < total) {
      load_x<bf16, BM, BK, LDX>(S, xs + (nx % kStages) * BM * LDX,
                                (t0 + nx / nk) * BM, (nx % nk) * BK);
    }
    cp_async_commit();
    const int kc = it % nk;
    const bf16* xa = xs + (it % kStages) * BM * LDX;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldmatrix_x4(a[i], xa + (wm * 32 + i * 16 + lane % 16) * LDX +
                              ks * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, ws + (kc * BK + ks * 16 + lane % 16) * LDW +
                                 wn * WN + j * 16 + (lane / 16) * 8);
        b[2 * j][0] = t[0];
        b[2 * j][1] = t[1];
        b[2 * j + 1][0] = t[2];
        b[2 * j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    if (kc != nk - 1) continue;

    // epilogue: + bias in f32, one rounding, tile -> shared -> 16-byte runs
    const int m0 = (t0 + it / nk) * BM;
    const int g = lane / 4;
    const int t4 = lane % 4;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = wm * 32 + i * 16 + g;
        const int col = wn * WN + j * 8 + 2 * t4;
        const float b0 = bs[col], b1 = bs[col + 1];
        *reinterpret_cast<__nv_bfloat162*>(os + row * LDO + col) =
            __floats2bfloat162_rn(acc[i][j][0] + b0, acc[i][j][1] + b1);
        *reinterpret_cast<__nv_bfloat162*>(os + (row + 8) * LDO + col) =
            __floats2bfloat162_rn(acc[i][j][2] + b0, acc[i][j][3] + b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      }
    }
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const int m = m0 + i;
      pb[i] = m < S.M ? out_base(S, m, dy, s0) : -1;
    }
    __syncthreads();
    bf16* out = static_cast<bf16*>(S.out);
    constexpr int V = 8;
    constexpr int CPR = BN / V;
    for (int i = threadIdx.x; i < BM * CPR; i += kThreads) {
      const int row = i / CPR;
      const int col = (i - row * CPR) * V;
      const long long base = pb[row];
      if (base < 0) continue;
      if (S.ovec && s0 + col + V <= S.rc) {
        *reinterpret_cast<uint4*>(out + base + col) =
            *reinterpret_cast<const uint4*>(os + row * LDO + col);
      } else {
        for (int e = 0; e < V && s0 + col + e < S.rc; ++e) {
          out[base + col + e] = os[row * LDO + col + e];
        }
      }
    }
    // the next epilogue writes os / pb only after the next iteration's
    // barrier, so no barrier is needed here
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ f32, FMA
template <int BN, int TM>
struct FmaCfg {
  static constexpr int BK = BN == 32 ? kFmaBK / 2 : kFmaBK;
  static constexpr int TXN = BN / 8;            // threads along the columns
  static constexpr int TYN = kThreads / TXN;    // threads along the pixels
  static constexpr int BM = TYN * TM;
  static constexpr int LDX = BK + 4, LDW = BN + 4;
  static size_t smem(int kp) {
    return sizeof(float) * ((size_t)kStages * BM * LDX + (size_t)kp * LDW +
                            BN);
  }
};

// Thread (tx, ty) owns pixels ty + i*TYN (i < TM) and columns
// tx*4 .. tx*4+3 and BN/2 + tx*4 .. +3.
template <int BN, int TM>
__global__ void __launch_bounds__(kThreads) conv_fma_f32(Shape S) {
  using Cfg = FmaCfg<BN, TM>;
  constexpr int BM = Cfg::BM, BK = Cfg::BK, LDX = Cfg::LDX, LDW = Cfg::LDW,
                TXN = Cfg::TXN, TYN = Cfg::TYN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + kStages * BM * LDX;
  float* bs = ws + S.kp * LDW;

  const int slice = blockIdx.x % (S.r * S.nsl);  // fastest: see the note
  const int dy = slice / S.nsl;
  const int s0 = (slice - dy * S.nsl) * BN;
  const int t0 = blockIdx.x / (S.r * S.nsl) * S.tpb;
  const int nk = S.kp / BK;
  const int total = min(S.tpb, S.ntiles - t0) * nk;

  // the weight slice's copies join the first x chunk's group
  load_w<float, BN, LDW>(S, ws, bs, dy, s0);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      load_x<float, BM, BK, LDX>(S, xs + s * BM * LDX, (t0 + s / nk) * BM,
                                 (s % nk) * BK);
    }
    cp_async_commit();
  }
  const int tx = threadIdx.x % TXN;
  const int ty = threadIdx.x / TXN;
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < total) {
      load_x<float, BM, BK, LDX>(S, xs + (nx % kStages) * BM * LDX,
                                 (t0 + nx / nk) * BM, (nx % nk) * BK);
    }
    cp_async_commit();
    const int kc = it % nk;
    const float* xa = xs + (it % kStages) * BM * LDX;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(xa + (ty + i * TYN) * LDX +
                                                kk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wr = ws + (kc * BK + kk + q) * LDW;
        const float4 b0 = *reinterpret_cast<const float4*>(wr + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(wr + BN / 2 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                                           : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    if (kc != nk - 1) continue;

    // epilogue: + bias, 16-byte stores of each thread's two 4-column runs
    const int m0 = (t0 + it / nk) * BM;
    float* out = static_cast<float*>(S.out);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * TYN;
      if (m < S.M) {
        const long long base = out_base(S, m, dy, s0);
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int col = hlf * (BN / 2) + tx * 4;
          float4 v;
          v.x = acc[i][hlf * 4 + 0] + bs[col + 0];
          v.y = acc[i][hlf * 4 + 1] + bs[col + 1];
          v.z = acc[i][hlf * 4 + 2] + bs[col + 2];
          v.w = acc[i][hlf * 4 + 3] + bs[col + 3];
          if (S.ovec && s0 + col + 4 <= S.rc) {
            *reinterpret_cast<float4*>(out + base + col) = v;
          } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
            for (int e = 0; e < 4 && s0 + col + e < S.rc; ++e) {
              out[base + col + e] = vv[e];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
  }
  cp_async_wait<0>();
}

// -------------------------------------------------------------- narrow path
constexpr int kNarrowKC = 64;  // k-chunk of x staged in shared memory

template <typename T>
struct NarrowCfg {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int LDX = kNarrowKC + V;  // +16 bytes: no bank conflict
  static size_t smem(int K, int nc) {
    const int kr = (K + kNarrowKC - 1) / kNarrowKC * kNarrowKC;
    return sizeof(float) * ((size_t)kr + 1) * nc +
           sizeof(T) * (size_t)kThreads * LDX;
  }
};

// NC: the GEMM's r*r*C columns rounded up to 4, 8 or 16. A block stages the
// x rows of its kThreads pixels (one contiguous span of x) in shared memory
// by coalesced copies, k-chunk by k-chunk; then each thread sums its own
// pixel's row into NC accumulators, k in order, every lane of a warp
// reading the same weight row (a broadcast).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) conv_narrow(Shape S) {
  using Cfg = NarrowCfg<T>;
  constexpr int V = Cfg::V, LDX = Cfg::LDX;
  const int kr = (S.K + kNarrowKC - 1) / kNarrowKC * kNarrowKC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);  // kr rows of NC
  float* bsm = wsm + kr * NC;                   // NC
  T* xs = reinterpret_cast<T*>(bsm + NC);       // kThreads rows of LDX
  const int ncol = S.r * S.r * S.C;
  const T* w = static_cast<const T*>(S.w);
  const T* b = static_cast<const T*>(S.b);
  for (int i = threadIdx.x; i < kr * NC; i += kThreads) {
    const int k = i / NC;
    const int j = i - k * NC;
    wsm[i] = j < ncol && k < S.K
                 ? to_f(w[((long long)(j / S.C) * S.K + k) * S.C + j % S.C])
                 : 0.0f;
  }
  if (threadIdx.x < NC) {
    bsm[threadIdx.x] = threadIdx.x < ncol ? to_f(b[threadIdx.x]) : 0.0f;
  }

  const T* x = static_cast<const T*>(S.x);
  const int m0 = blockIdx.x * kThreads;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < S.K; k0 += kNarrowKC) {
    __syncthreads();  // the previous chunk is consumed (and wsm is ready)
    load_x<T, kThreads, kNarrowKC, LDX>(S, xs, m0, k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const T* xr = xs + threadIdx.x * LDX;
#pragma unroll 2
    for (int kk = 0; kk < kNarrowKC; kk += V) {
      const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(xr + kk);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xf = to_f(xv.v[e]);
        const float* wr = wsm + (k0 + kk + e) * NC;
#pragma unroll
        for (int j = 0; j < NC; j += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + j);
          acc[j] = fmaf(xf, wv.x, acc[j]);
          acc[j + 1] = fmaf(xf, wv.y, acc[j + 1]);
          acc[j + 2] = fmaf(xf, wv.z, acc[j + 2]);
          acc[j + 3] = fmaf(xf, wv.w, acc[j + 3]);
        }
      }
    }
  }
  // r runs of r*C elements; neighbouring threads write neighbouring runs
  const int m = m0 + threadIdx.x;
  if (m >= S.M) return;
  T* out = static_cast<T*>(S.out);
  const long long base = out_base(S, m, 0, 0);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < ncol) {
      const int dy = j / S.rc;
      out[base + (long long)dy * S.W * S.rc + j - dy * S.rc] =
          from_f<T>(acc[j] + bsm[j]);
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t s,
                   const Shape& S) {
  kernel<<<grid, kThreads, smem, s>>>(S);
  return cudaGetLastError();
}

// Every kernel may take up to the card's 227 KB of dynamic shared memory;
// set once, before the first launch (so never inside a graph capture).
cudaError_t allow_large_smem() {
  const void* kernels[] = {
      (const void*)conv_mma_bf16<128, 32>, (const void*)conv_mma_bf16<64, 32>,
      (const void*)conv_mma_bf16<32, 32>, (const void*)conv_mma_bf16<128, 64>,
      (const void*)conv_mma_bf16<64, 64>, (const void*)conv_mma_bf16<32, 64>,
      (const void*)conv_fma_f32<128, 8>,
      (const void*)conv_fma_f32<64, 4>, (const void*)conv_fma_f32<32, 4>,
      (const void*)conv_narrow<float, 4>, (const void*)conv_narrow<float, 8>,
      (const void*)conv_narrow<float, 16>, (const void*)conv_narrow<bf16, 4>,
      (const void*)conv_narrow<bf16, 8>, (const void*)conv_narrow<bf16, 16>};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Column slice width of the tiled paths: the widest of 128 / 64 / 32 that
// divides r*C and keeps the weight slice within kWeightBytes.
constexpr size_t kWeightBytes = 110 * 1024;
int pick_bn(int kp, int rc, int esize, int pad) {
  for (int bn = 128; bn > 32; bn /= 2) {
    if (rc % bn == 0 && (size_t)kp * (bn + pad) * esize <= kWeightBytes) {
      return bn;
    }
  }
  return 32;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Blocks of a tiled launch; sets S.tpb. A block walks as many tiles (8, 4,
// 2 or 1), its weight slice loaded once, as leave at least kMinBlocks
// blocks: one on the hyper decoders' 17 x 30 inputs. Which block computes
// a tile changes no sum.
unsigned tiled_grid(Shape& S) {
  const long long slices = (long long)S.r * S.nsl;
  S.tpb = kMaxTilesPerBlock;
  while (S.tpb > 1 &&
         slices * ((S.ntiles + S.tpb - 1) / S.tpb) < kMinBlocks) {
    S.tpb /= 2;
  }
  return (unsigned)(slices * ((S.ntiles + S.tpb - 1) / S.tpb));
}

}  // namespace

// x: (N, H, W, K) NHWC; w: (r*r, K, C); b: (r*r, C); out: (N, H*r, W*r, C)
// NHWC; all one dtype (0: float32, 1: bfloat16). Returns the cudaError_t of
// the launch. The weight slice lives in shared memory, which bounds K at
// about 1300 in f32 and 2400 in bf16 (the models use at most 288); a
// larger K fails to launch.
extern "C" int vcm_subpel_conv1x1(const void* x, const void* w, const void* b,
                                  void* out, int N, int H, int W, int K, int C,
                                  int r, int dtype, void* stream) {
  const long long M = (long long)N * H * W;
  if ((dtype != 0 && dtype != 1) || M >= (1LL << 31) || K < 1 || C < 1 ||
      r < 1 || (long long)r * r * C * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  static const cudaError_t smem_ok = allow_large_smem();
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  const int esize = dtype == 0 ? 4 : 2;
  const int V = 16 / esize;
  Shape S = {};
  S.x = x;
  S.w = w;
  S.b = b;
  S.out = out;
  S.M = (int)M;
  S.K = K;
  S.C = C;
  S.r = r;
  S.H = H;
  S.W = W;
  S.rc = r * C;
  S.xvec = K % V == 0 && aligned16(x);
  S.wvec = C % V == 0 && aligned16(w);
  S.ovec = S.rc % V == 0 && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncol = r * r * C;

  if (ncol <= 16) {
    const dim3 grid((unsigned)((M + kThreads - 1) / kThreads));
    const int nc = ncol <= 4 ? 4 : ncol <= 8 ? 8 : 16;
    const size_t smem = dtype == 0 ? NarrowCfg<float>::smem(K, nc)
                                   : NarrowCfg<bf16>::smem(K, nc);
    if (dtype == 0) {
      return (int)(nc == 4    ? launch(conv_narrow<float, 4>, grid, smem, s, S)
                   : nc == 8  ? launch(conv_narrow<float, 8>, grid, smem, s, S)
                              : launch(conv_narrow<float, 16>, grid, smem, s,
                                       S));
    }
    return (int)(nc == 4   ? launch(conv_narrow<bf16, 4>, grid, smem, s, S)
                 : nc == 8 ? launch(conv_narrow<bf16, 8>, grid, smem, s, S)
                           : launch(conv_narrow<bf16, 16>, grid, smem, s, S));
  }

  if (dtype == 1) {
    const int kp32 = (K + 31) / 32 * 32;
    const int kp64 = (K + 63) / 64 * 64;
    const int bn = pick_bn(kp32, S.rc, esize, 8);
    // 64-deep k-chunks (fewer barriers, more bytes in flight) unless they
    // cost a block per SM that 32-deep ones would keep
    const int b32 = (int)(kSmemPerSM / (mma_smem(bn, 32, kp32) + 1024));
    const int b64 = (int)(kSmemPerSM / (mma_smem(bn, 64, kp64) + 1024));
    const int bk = (b64 >= 2 || b64 >= b32) ? 64 : 32;
    S.kp = bk == 64 ? kp64 : kp32;
    S.nsl = (S.rc + bn - 1) / bn;
    S.ntiles = (int)((M + kMmaBM - 1) / kMmaBM);
    const dim3 grid(tiled_grid(S));
    const size_t smem = mma_smem(bn, bk, S.kp);
    if (bk == 64) {
      return (int)(bn == 128  ? launch(conv_mma_bf16<128, 64>, grid, smem, s, S)
                   : bn == 64 ? launch(conv_mma_bf16<64, 64>, grid, smem, s, S)
                              : launch(conv_mma_bf16<32, 64>, grid, smem, s,
                                       S));
    }
    return (int)(bn == 128  ? launch(conv_mma_bf16<128, 32>, grid, smem, s, S)
                 : bn == 64 ? launch(conv_mma_bf16<64, 32>, grid, smem, s, S)
                            : launch(conv_mma_bf16<32, 32>, grid, smem, s, S));
  }

  S.kp = (K + kFmaBK - 1) / kFmaBK * kFmaBK;
  const int bn = pick_bn(S.kp, S.rc, esize, 4);
  S.nsl = (S.rc + bn - 1) / bn;
  size_t smem;
  int bm;
  if (bn == 128) {
    bm = FmaCfg<128, 8>::BM;
    smem = FmaCfg<128, 8>::smem(S.kp);
  } else if (bn == 64) {
    bm = FmaCfg<64, 4>::BM;
    smem = FmaCfg<64, 4>::smem(S.kp);
  } else {
    bm = FmaCfg<32, 4>::BM;
    smem = FmaCfg<32, 4>::smem(S.kp);
  }
  S.ntiles = (int)((M + bm - 1) / bm);
  const dim3 grid(tiled_grid(S));
  if (bn == 128) return (int)launch(conv_fma_f32<128, 8>, grid, smem, s, S);
  if (bn == 64) return (int)launch(conv_fma_f32<64, 4>, grid, smem, s, S);
  return (int)launch(conv_fma_f32<32, 4>, grid, smem, s, S);
}
