// Culling pre-pass of the fused set abstraction: for each chunk of 128
// consecutive points and each centre, the min over the chunk of
// (x-c)^2 + (y-c)^2 + (z-c)^2 + BIG*invalid; and, from the same launch, the
// culling bitmap the fused kernels (csrc/fused_sa.cu) read.
//
// Replaces: deepclr_tpu/ops/pallas/fused_sa_kernel.py::_min_d2_kernel (the
// Pallas TPU kernel behind block_min_d2_pallas) and the fold that
// _prologue (fused_sa_kernel.py:320-326) applies to its output.
//
// Semantics (exact with ops/fused_sa.py::_block_min_d2_plain): the dx^2 form
// with every product rounded (built with -fmad=false), summed x, y, z, then
// the invalid penalty, in that order; the min is exact.  The bitmap (exact
// with ops/fused_sa.py::cull_bitmap): a (chunk, 16-centre tile) byte is 1
// when the tile's min, times 0.99 then minus 1e-3 (each rounded), is below
// r2max; centres past P count as +inf.
//
// What bounds it on H100: operations.  Each (point, centre) pair takes 3
// subtractions, 3 multiplies, 2 adds (3 with the penalty) and a min, B*N*P
// pairs (0.54 G at 32 x 16384 x 1024), against ~25 MB of input and output;
// no tensor-core form exists for a min.  The products are rounded, so no
// pair's arithmetic fuses into an FMA: every operation is one instruction
// at the card's float32 issue rate.
//
// Design: grid (centre blocks of 1024, point chunks, clouds), 128 threads.
// A block stages its chunk's points (x, y, z, BIG*invalid as one float4
// each) in shared memory; each thread owns 8 centres (q = tid + 128 k) in
// registers, so one broadcast float4 load of a point serves 8 pairs.  The
// loop runs over a fixed 128 points; the slots of a ragged last chunk hold
// a +inf penalty, so they never win.  A chunk whose points are all valid
// (the common case) skips the penalty add: d2 + 0 is d2.  The output row of
// a chunk is written coalesced; for the bitmap, the 16 lanes that own a
// tile's centres take its min with shuffles and one of them writes the byte.
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;     // points per chunk (the bitmap's chunk)
constexpr int kPerThread = 8;   // centres per thread
constexpr int kCentres = kThreads * kPerThread;
constexpr int kTile = 16;       // centres per bitmap tile
constexpr unsigned kFull = 0xffffffffu;

template <bool kPenalty>
__device__ __forceinline__ void scan_chunk(const float4* spts, const float (&cx)[kPerThread],
                                           const float (&cy)[kPerThread],
                                           const float (&cz)[kPerThread],
                                           float (&best)[kPerThread]) {
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const float4 s = spts[i];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float dx = s.x - cx[k];
      float d2 = dx * dx;
      const float dy = s.y - cy[k];
      d2 = d2 + dy * dy;
      const float dz = s.z - cz[k];
      d2 = d2 + dz * dz;
      if constexpr (kPenalty) d2 = d2 + s.w;
      best[k] = fminf(best[k], d2);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
min_d2_kernel(const float4* __restrict__ pts, const float* __restrict__ cts,
              float* __restrict__ out, uint8_t* __restrict__ active, int n, int p, float r2max) {
  static_assert(kThreads == kChunk, "thread i stages point i of the chunk");
  __shared__ float4 spts[kChunk];
  const int b = blockIdx.z, c = blockIdx.y, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int j = c * kChunk + tid;
  const float4 pt = j < n ? pts[(size_t)b * n + j] : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
  spts[tid] = pt;
  const bool penalty = __syncthreads_or(pt.w != 0.0f);

  const int q0 = blockIdx.x * kCentres + tid;
  float cx[kPerThread], cy[kPerThread], cz[kPerThread], best[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q0 + k * kThreads;
    const float* ct = cts + ((size_t)b * p + min(q, p - 1)) * 3;
    cx[k] = ct[0];
    cy[k] = ct[1];
    cz[k] = ct[2];
    best[k] = INFINITY;
  }
  if (penalty) {  // block-uniform
    scan_chunk<true>(spts, cx, cy, cz, best);
  } else {
    scan_chunk<false>(spts, cx, cy, cz, best);
  }

  float* orow = out + ((size_t)b * nc + c) * p;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q0 + k * kThreads;
    if (q < p) orow[q] = best[k];
  }
  if (active == nullptr) return;
  // lanes 16h .. 16h + 15 own the centres of one tile for each k
  const int ntiles = (p + kTile - 1) / kTile;
  uint8_t* arow = active + ((size_t)b * nc + c) * ntiles;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q0 + k * kThreads;
    float m = q < p ? best[k] : INFINITY;
#pragma unroll
    for (int o = kTile / 2; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
    const int t = q / kTile;
    if ((lane & (kTile - 1)) == 0 && t < ntiles) {
      arow[t] = __fsub_rn(__fmul_rn(m, 0.99f), 1e-3f) < r2max ? 1 : 0;
    }
  }
}

}  // namespace

// pts (B, N, 4) = x, y, z, BIG*invalid; cts (B, P, 3); out (B, ceil(N/chunk), P);
// active (B, ceil(N/chunk), ceil(P/tile)) uint8, or null for the minima alone.
extern "C" int deepclr_min_d2(const float* pts, const float* cts, float* out, uint8_t* active, int b,
                              int n, int p, int chunk, int tile, float r2max, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || p <= 0 || b > 65535 || chunk != kChunk || tile != kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = (n + kChunk - 1) / kChunk;
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((p + kCentres - 1) / kCentres, nc, b);
  min_d2_kernel<<<grid, kThreads, 0, stream>>>(reinterpret_cast<const float4*>(pts), cts, out,
                                              active, n, p, r2max);
  return (int)cudaGetLastError();
}
