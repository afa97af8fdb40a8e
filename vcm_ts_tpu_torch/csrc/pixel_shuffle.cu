// Kernel C: depth-to-space for k-major channel order, NHWC.
//
// Replaces vcm_ts_tpu/ops/subpel_pallas.py::_relayout_kernel (via
// _relayout_impl / pixel_shuffle_relayout) and ::_relayout_full_kernel (via
// _relayout_impl_fulllane): the same function, which the TPU needed in two
// forms because Mosaic lane blocks must be 128-divisible.
//
// In k-major order (input channel (dy*r + dx)*C + c) the output row
// (n, h*r + dy) is, for each input pixel (n, h, w), the contiguous r*C
// segment [dy*r*C, (dy+1)*r*C) of that pixel's channel vector: the whole
// op is a copy of r*C-element segments, no arithmetic.
//
// What bounds it on H100: bytes only: one read and one write of the tensor
// (2 x 267 MB for C=32 f32 at 544x960 -> 1088x1920).
//
// Design: one thread per 16-byte vector of the output, in output order, so
// both the stores and (within a segment) the loads are contiguous across a
// warp; 16-byte loads and stores where r*C fills whole vectors, single
// elements otherwise. One kernel serves every channel count. Index math is
// 32-bit where the tensor allows it. It is a pure copy: bit-identical to
// the plain version by construction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BYTES>
struct alignas(BYTES) Chunk {
  unsigned char b[BYTES];
};

// I: index type; BYTES: bytes moved per thread; ESIZE: element size.
template <typename I, int BYTES, int ESIZE>
__global__ void __launch_bounds__(kThreads)
    relayout_kernel(const unsigned char* __restrict__ in,
                    unsigned char* __restrict__ out, I nchunks, I H, I W, I C,
                    I r) {
  constexpr int V = BYTES / ESIZE;  // elements per chunk
  const I seg = r * C;
  const I Hr = H * r;
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < nchunks;
       i += (I)gridDim.x * kThreads) {
    const I e = i * V;  // output element index
    const I c2 = e % seg;
    I t = e / seg;
    const I w = t % W;
    t /= W;
    const I oh = t % Hr;
    const I n = t / Hr;
    const I h = oh / r;
    const I dy = oh - h * r;
    const I s = ((n * H + h) * W + w) * (seg * r) + dy * seg + c2;
    *reinterpret_cast<Chunk<BYTES>*>(out + (size_t)e * ESIZE) =
        *reinterpret_cast<const Chunk<BYTES>*>(in + (size_t)s * ESIZE);
  }
}

template <typename I>
void launch(const void* in, void* out, long long nelem, int esize, bool vec,
            int H, int W, int C, int r, cudaStream_t s) {
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
  const long long nchunks = vec ? nelem * esize / 16 : nelem;
  long long blocks = (nchunks + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  const unsigned g = (unsigned)blocks;
  if (vec) {
    if (esize == 4) {
      relayout_kernel<I, 16, 4><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
    } else {
      relayout_kernel<I, 16, 2><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
    }
  } else if (esize == 4) {
    relayout_kernel<I, 4, 4><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
  } else {
    relayout_kernel<I, 2, 2><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
  }
}

}  // namespace

// in: (N, H, W, r*r*C) NHWC, k-major channels; out: (N, H*r, W*r, C) NHWC;
// esize: bytes per element (4: float32, 2: bfloat16). Returns the
// cudaError_t of the launch.
extern "C" int vcm_pixel_shuffle_relayout(const void* in, void* out, int N,
                                          int H, int W, int C, int r,
                                          int esize, void* stream) {
  if ((esize != 4 && esize != 2) || r < 1 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nelem = (long long)N * H * W * r * r * C;
  if (nelem == 0) return 0;
  const bool vec = ((long long)r * C * esize) % 16 == 0 &&
                   (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nelem < (1LL << 30)) {  // headroom for the grid-stride increment
    launch<int>(in, out, nelem, esize, vec, H, W, C, r, s);
  } else {
    launch<long long>(in, out, nelem, esize, vec, H, W, C, r, s);
  }
  return (int)cudaGetLastError();
}
