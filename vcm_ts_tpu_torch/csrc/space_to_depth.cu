// Kernel C': space-to-depth into k-major channel order, NHWC.
//
// Replaces vcm_ts_tpu/ops/subpel_pallas.py::_kmajor_space_to_depth (:131),
// which the JAX package runs in two custom VJPs: the backward of the k-major
// depth-to-space (_relayout_bwd, :149; kernel C's backward) and the first
// step of the fused 1x1 subpel conv's backward (_conv1x1_bwd, :221; kernel
// B's), where it turns the output gradient into gk before the two matrix
// products.
//
// It is the inverse permutation of csrc/pixel_shuffle.cu: output channel
// (dy*r + dx)*C + c of pixel (n, h, w) is input pixel (n, h*r + dy,
// w*r + dx), channel c. For a fixed dy the r*C channels (dx, c) of the
// output are the contiguous r*C elements of input row h*r + dy from column
// w*r on, so the whole op is a copy of r*C-element segments.
//
// What bounds it on H100: bytes only, one read and one write of the tensor.
//
// Design: as kernel C, one thread per 16-byte vector of the output, in
// output order (stores contiguous across a warp, loads contiguous within a
// segment); 16-byte moves where r*C fills whole vectors, single elements
// otherwise; 32-bit index math where the tensor allows it. A pure copy:
// bit-identical to the plain version by construction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BYTES>
struct alignas(BYTES) Chunk {
  unsigned char b[BYTES];
};

// I: index type; BYTES: bytes moved per thread; ESIZE: element size.
// H, W: the OUTPUT's (low-resolution) height and width.
template <typename I, int BYTES, int ESIZE>
__global__ void __launch_bounds__(kThreads)
    s2d_kernel(const unsigned char* __restrict__ in,
               unsigned char* __restrict__ out, I nchunks, I H, I W, I C,
               I r) {
  constexpr int V = BYTES / ESIZE;  // elements per chunk
  const I seg = r * C;
  const I depth = seg * r;
  const I Wr = W * r;
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < nchunks;
       i += (I)gridDim.x * kThreads) {
    const I e = i * V;  // output element index
    const I k = e % depth;
    const I pix = e / depth;
    const I w = pix % W;
    const I t = pix / W;
    const I h = t % H;
    const I n = t / H;
    const I dy = k / seg;
    const I c2 = k - dy * seg;  // dx*C + c
    const I s = ((n * H * r + h * r + dy) * Wr + w * r) * C + c2;
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
      s2d_kernel<I, 16, 4><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
    } else {
      s2d_kernel<I, 16, 2><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
    }
  } else if (esize == 4) {
    s2d_kernel<I, 4, 4><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
  } else {
    s2d_kernel<I, 2, 2><<<g, kThreads, 0, s>>>(src, dst, (I)nchunks, H, W, C, r);
  }
}

}  // namespace

// in: (N, H*r, W*r, C) NHWC; out: (N, H, W, r*r*C) NHWC, k-major channels;
// esize: bytes per element (4: float32, 2: bfloat16). Returns the
// cudaError_t of the launch.
extern "C" int vcm_space_to_depth(const void* in, void* out, int N, int H,
                                  int W, int C, int r, int esize,
                                  void* stream) {
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
