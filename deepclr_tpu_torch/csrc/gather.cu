// The backward of the row gather out[b, m] = src[b, idx[b, m]]
// (ops/grouping.py::gather_points, and so group_points), with a sum order
// that is a function of the inputs alone:
//
//   dsrc[b, j, c] = sum over m with idx[b, m] = j, m ascending, of g[b, m, c]
//
// The port's own kernel: the JAX package gathers with XLA and leaves its
// backward to XLA, which sums in a fixed order; on the card torch.gather's
// backward is a scatter_add_ whose float atomics add in a varying order.
// B5's backward scatter (ops/fused_sa.py::_winner_grads) is the same sum.
//
// The wrapper builds a CSR of the index with a stable sort: order[b, e]
// lists the m of cloud b by ascending idx, and equal idx by ascending m;
// offsets[b, j] .. offsets[b, j + 1] is row j's run.  One warp takes one
// source row, lanes over channels (32 at a time), and adds the run's rows
// in order into float32 registers, then writes the row (zeros for a row no
// index names).  So each sum is sequential in m, as the CPU's scatter_add
// is.
//
// What bounds it on H100: bytes.  It reads g and the CSR once and writes
// dsrc once; the reads of a run are scattered rows of g (C floats each,
// whole 128-byte lines at C = 32).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const float* __restrict__ g, const int* __restrict__ order,
                  const int* __restrict__ offsets, float* __restrict__ dsrc, int m, int n, int c) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (j >= n) return;  // warp-uniform
  const int* off = offsets + (size_t)b * (n + 1);
  const int e0 = off[j], e1 = off[j + 1];
  const int* ord = order + (size_t)b * m;
  const float* gb = g + (size_t)b * m * c;
  float* row = dsrc + ((size_t)b * n + j) * c;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + lane;
    float acc = 0.0f;
    if (ch < c) {
      for (int e = e0; e < e1; ++e) acc += gb[(size_t)__ldg(ord + e) * c + ch];
      row[ch] = acc;
    }
  }
}

}  // namespace

// g (B, M, C) float32; order (B, M) int32 and offsets (B, N + 1) int32, the
// CSR of the index (see above); dsrc (B, N, C) float32, every entry written.
extern "C" int deepclr_gather_bwd(const float* g, const int* order, const int* offsets, float* dsrc,
                                  int b, int m, int n, int c, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || m < 0 || n <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  gather_bwd_kernel<<<grid, kThreads, 0, stream>>>(g, order, offsets, dsrc, m, n, c);
  return (int)cudaGetLastError();
}
