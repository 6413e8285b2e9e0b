// Culling pre-pass of the fused set abstraction: for each chunk of `chunk`
// consecutive points and each centre, the min over the chunk of
// (x-c)^2 + (y-c)^2 + (z-c)^2 + BIG*invalid.
//
// Replaces: deepclr_tpu/ops/pallas/fused_sa_kernel.py::_min_d2_kernel (the
// Pallas TPU kernel behind block_min_d2_pallas).
//
// Semantics (exact with ops/fused_sa.py::_block_min_d2_plain): the dx^2 form
// with every product rounded (built with -fmad=false), summed x, y, z, then
// the invalid penalty, in that order; the min is exact.
//
// What bounds it on H100: operations.  It does ~10 float32 operations for
// each (point, centre) pair, B*N*P of them (5.4 G at 32 x 16384 x 1024),
// against ~25 MB of input and output; no tensor-core form exists for a min.
//
// Design: grid (centre blocks of 256, point chunks, clouds).  A block stages
// its chunk's points (x, y, z, BIG*invalid as one float4 each) in shared
// memory; each thread owns one centre, keeps it in registers and streams the
// chunk from shared memory as broadcast reads.  The output row of a chunk is
// written coalesced, one float per centre.  A ragged last chunk takes the min
// over the points it has.
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
min_d2_kernel(const float4* __restrict__ pts, const float* __restrict__ cts,
              float* __restrict__ out, int n, int p, int chunk) {
  extern __shared__ float4 spts[];
  const int b = blockIdx.z, c = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int nc = gridDim.y;
  const int j0 = c * chunk;
  const int cnt = min(chunk, n - j0);
  for (int i = threadIdx.x; i < cnt; i += kThreads) spts[i] = pts[(size_t)b * n + j0 + i];
  __syncthreads();
  if (q >= p) return;
  const float* ct = cts + ((size_t)b * p + q) * 3;
  const float cx = ct[0], cy = ct[1], cz = ct[2];
  float best = INFINITY;
  for (int i = 0; i < cnt; ++i) {
    const float4 s = spts[i];
    const float dx = s.x - cx;
    float d2 = dx * dx;
    const float dy = s.y - cy;
    d2 = d2 + dy * dy;
    const float dz = s.z - cz;
    d2 = d2 + dz * dz;
    d2 = d2 + s.w;
    best = fminf(best, d2);
  }
  out[((size_t)b * nc + c) * p + q] = best;
}

}  // namespace

// pts (B, N, 4) = x, y, z, BIG*invalid; cts (B, P, 3); out (B, ceil(N/chunk), P).
extern "C" int deepclr_min_d2(const float* pts, const float* cts, float* out, int b, int n,
                              int p, int chunk, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || p <= 0 || chunk <= 0 || chunk > 3072) return (int)cudaErrorInvalidValue;
  const int nc = (n + chunk - 1) / chunk;
  const dim3 grid((p + kThreads - 1) / kThreads, nc, b);
  const size_t smem = (size_t)chunk * sizeof(float4);
  min_d2_kernel<<<grid, kThreads, smem, stream>>>(reinterpret_cast<const float4*>(pts), cts, out,
                                                 n, p, chunk);
  return (int)cudaGetLastError();
}
