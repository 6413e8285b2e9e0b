// Fused set abstraction forward: ball query + shared MLP + max-pool.
//
//   out[p, c] = max over valid j with |x_j - c_p|^2 < r_c^2 of
//               MLP(x_j - c_p || f_j)[c]         (0 for an empty ball)
//
// Replaces: deepclr_tpu/ops/pallas/fused_sa_kernel.py::_make_kernel
// (with_argmax=False), the Pallas TPU kernel behind ball_mlp_max_pallas.
//
// Semantics (as ops/fused_sa.py::_fused_sa_plain): layer 1 is split outside
// the kernel into a per-point term a_j = x_j W1x + f_j W1f + b1 and a
// per-centre term bc_p = -c_p W1x, both float32; per pair the kernel takes
// relu(a_j + bc_p) in float32, rounds it to the compute dtype, and runs the
// two tail layers with float32 accumulation, a float32 bias and ReLU (the
// middle activation rounded to the compute dtype again).  d^2 is the dx^2
// form with rounded products (-fmad=false), so it equals the culling
// pre-pass (csrc/min_d2.cu) bit for bit; the tail's dot products use
// explicit FMAs.
//
// What bounds it on H100: neither bytes nor FLOPs of the function itself.
// The design depends on sparse balls.  On the synthetic KITTI-like clouds
// that chip_smoke.py drives (normal, sigma = 30, 30, 2 m; 16384 points, 1024
// centres) chip_smoke.py counts about 1.2 points per 1 m ball, so the
// in-radius pairs whose MLP the result needs are ~0.01% of the N x P pairs;
// the time goes to the pair tests of the (chunk, tile) blocks the culling
// bitmap keeps, the block synchronisation around them and the launch of
// B * P/16 blocks.  Real scans, denser near the sensor and on the ground,
// have not been measured; with tens of points per ball the MLP over the
// listed pairs would take over.
//
// Design: one block per (centre tile of 16, cloud), 128 threads.  The block
// walks the point chunks (128 points) and skips every chunk whose bit in the
// culling bitmap is 0 (the pre-pass min d^2 over the (chunk, tile) block,
// with a margin, is >= r_max^2).  For a kept chunk it stages the points in
// shared memory, tests all 16 x 128 pairs (point-major, so the lanes of a
// warp cover 16 centres), and compacts the pairs with d^2 < r_max^2 into a
// shared list with warp ballots.  Only listed pairs run the MLP: one thread
// per pair, activations in registers, weights read as shared-memory
// broadcasts.  Each output column's max lives in shared memory as the int
// bit pattern of a non-negative float (ReLU makes every value >= 0, so int
// order is float order) and is updated with shared atomicMax; the rows are
// padded by one word so the lanes' centres fall in distinct banks.  The TPU
// kernel's lane packing, expansion matmul and SMEM bitmap layout are not
// carried over; the dense tail over every tile pair is replaced by the
// compacted pair list.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;    // centres per block
constexpr int kChunk = 128;  // points per culling chunk
constexpr int kPairs = kTile * kChunk;

template <bool BF16>
__device__ __forceinline__ float to_cd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float relu(float x) { return x > 0.0f ? x : 0.0f; }

template <int H1, int H2, int H3, bool BF16>
__global__ void __launch_bounds__(kThreads)
fused_sa_kernel(const float4* __restrict__ pts, const float* __restrict__ a,
                const float* __restrict__ cts, const float* __restrict__ bc,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                const float* __restrict__ r2, const uint8_t* __restrict__ active,
                float* __restrict__ out, int n, int p, float r2max) {
  static_assert(H1 % 4 == 0 && H2 % 4 == 0 && H3 % 4 == 0, "widths must be multiples of 4");
  constexpr int kCols = H3 < 32 ? H3 : 32;  // layer-3 columns per register block
  static_assert(H3 % kCols == 0, "H3 must be a multiple of the column block");

  __shared__ __align__(16) float sw2[H1 * H2];
  __shared__ __align__(16) float sw3[H2 * H3];
  __shared__ float sb2[H2];
  __shared__ float sb3[H3];
  __shared__ float sr2[H3];
  __shared__ float sbc[kTile * (H1 + 1)];
  __shared__ float4 scts[kTile];
  __shared__ float4 spts[kChunk];
  __shared__ int smax[kTile * (H3 + 1)];
  __shared__ int slist[kPairs];
  __shared__ float sd2[kPairs];
  __shared__ int count;

  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = tile * kTile;
  const int nc = (n + kChunk - 1) / kChunk;

  for (int i = tid; i < H1 * H2; i += kThreads) sw2[i] = w2[i];
  for (int i = tid; i < H2 * H3; i += kThreads) sw3[i] = w3[i];
  for (int i = tid; i < H2; i += kThreads) sb2[i] = b2[i];
  for (int i = tid; i < H3; i += kThreads) {
    sb3[i] = b3[i];
    sr2[i] = r2[i];
  }
  for (int i = tid; i < kTile * H1; i += kThreads) {
    const int t = i / H1, k = i % H1, q = p0 + t;
    sbc[t * (H1 + 1) + k] = q < p ? bc[((size_t)b * p + q) * H1 + k] : 0.0f;
  }
  for (int t = tid; t < kTile; t += kThreads) {
    const int q = p0 + t;
    const float* c = cts + ((size_t)b * p + q) * 3;
    // w = 1 marks a slot past the last centre: it never hits
    scts[t] = q < p ? make_float4(c[0], c[1], c[2], 0.0f) : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  }
  for (int i = tid; i < kTile * (H3 + 1); i += kThreads) smax[i] = -1;  // -1: no hit yet

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c = 0; c < nc; ++c) {
    if (!act[(size_t)c * ntiles]) continue;  // same byte for the whole block
    __syncthreads();  // the previous chunk's pairs are consumed
    const int j0 = c * kChunk;
    const int cnt = min(kChunk, n - j0);
    for (int i = tid; i < kChunk; i += kThreads) {
      // w = BIG*invalid for real points; 1 marks a slot past the cloud
      spts[i] = i < cnt ? pts[(size_t)b * n + j0 + i] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    }
    if (tid == 0) count = 0;
    __syncthreads();

    for (int base = 0; base < kPairs; base += kThreads) {
      const int q = base + tid;
      const int t = q % kTile, i = q / kTile;
      const float4 ct = scts[t], pt = spts[i];
      const float dx = pt.x - ct.x;
      float d2 = dx * dx;
      const float dy = pt.y - ct.y;
      d2 = d2 + dy * dy;
      const float dz = pt.z - ct.z;
      d2 = d2 + dz * dz;
      const bool hit = pt.w == 0.0f && ct.w == 0.0f && d2 < r2max;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot) {
        const int leader = __ffs(ballot) - 1;
        int pos = 0;
        if (lane == leader) pos = atomicAdd(&count, __popc(ballot));
        pos = __shfl_sync(0xffffffffu, pos, leader);
        if (hit) {
          pos += __popc(ballot & ((1u << lane) - 1u));
          slist[pos] = q;
          sd2[pos] = d2;
        }
      }
    }
    __syncthreads();

    const int total = count;
    for (int e = tid; e < total; e += kThreads) {
      const int q = slist[e];
      const float d2 = sd2[e];
      const int t = q % kTile, i = q / kTile;
      const float4* arow = reinterpret_cast<const float4*>(a + ((size_t)b * n + j0 + i) * H1);
      const float* bct = sbc + t * (H1 + 1);

      float h1[H1];
#pragma unroll
      for (int k4 = 0; k4 < H1 / 4; ++k4) {
        const float4 av = __ldg(arow + k4);
        h1[4 * k4 + 0] = to_cd<BF16>(relu(av.x + bct[4 * k4 + 0]));
        h1[4 * k4 + 1] = to_cd<BF16>(relu(av.y + bct[4 * k4 + 1]));
        h1[4 * k4 + 2] = to_cd<BF16>(relu(av.z + bct[4 * k4 + 2]));
        h1[4 * k4 + 3] = to_cd<BF16>(relu(av.w + bct[4 * k4 + 3]));
      }

      float h2[H2];
#pragma unroll
      for (int c2 = 0; c2 < H2; ++c2) h2[c2] = 0.0f;
#pragma unroll
      for (int k = 0; k < H1; ++k) {
        const float hk = h1[k];
        const float4* wr = reinterpret_cast<const float4*>(sw2 + k * H2);
#pragma unroll
        for (int c4 = 0; c4 < H2 / 4; ++c4) {
          const float4 w = wr[c4];
          h2[4 * c4 + 0] = __fmaf_rn(hk, w.x, h2[4 * c4 + 0]);
          h2[4 * c4 + 1] = __fmaf_rn(hk, w.y, h2[4 * c4 + 1]);
          h2[4 * c4 + 2] = __fmaf_rn(hk, w.z, h2[4 * c4 + 2]);
          h2[4 * c4 + 3] = __fmaf_rn(hk, w.w, h2[4 * c4 + 3]);
        }
      }
#pragma unroll
      for (int c2 = 0; c2 < H2; ++c2) h2[c2] = to_cd<BF16>(relu(h2[c2] + sb2[c2]));

      int* mrow = smax + t * (H3 + 1);
#pragma unroll
      for (int cb = 0; cb < H3; cb += kCols) {
        float acc[kCols];
#pragma unroll
        for (int c3 = 0; c3 < kCols; ++c3) acc[c3] = 0.0f;
#pragma unroll
        for (int k = 0; k < H2; ++k) {
          const float hk = h2[k];
          const float4* wr = reinterpret_cast<const float4*>(sw3 + k * H3 + cb);
#pragma unroll
          for (int c4 = 0; c4 < kCols / 4; ++c4) {
            const float4 w = wr[c4];
            acc[4 * c4 + 0] = __fmaf_rn(hk, w.x, acc[4 * c4 + 0]);
            acc[4 * c4 + 1] = __fmaf_rn(hk, w.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = __fmaf_rn(hk, w.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = __fmaf_rn(hk, w.w, acc[4 * c4 + 3]);
          }
        }
#pragma unroll
        for (int c3 = 0; c3 < kCols; ++c3) {
          if (d2 < sr2[cb + c3]) {
            atomicMax(mrow + cb + c3, __float_as_int(relu(acc[c3] + sb3[cb + c3])));
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < kTile * H3; i += kThreads) {
    const int t = i / H3, col = i % H3, q = p0 + t;
    if (q < p) {
      const int v = smax[t * (H3 + 1) + col];
      out[((size_t)b * p + q) * H3 + col] = v < 0 ? 0.0f : __int_as_float(v);
    }
  }
}

template <int H1, int H2, int H3>
cudaError_t launch(const float* pts, const float* a, const float* cts, const float* bc,
                   const float* w2, const float* b2, const float* w3, const float* b3,
                   const float* r2, const uint8_t* active, float* out, int b, int n, int p,
                   float r2max, bool bf16, cudaStream_t stream) {
  const dim3 grid((p + kTile - 1) / kTile, b);
  const float4* pts4 = reinterpret_cast<const float4*>(pts);
  if (bf16) {
    fused_sa_kernel<H1, H2, H3, true><<<grid, kThreads, 0, stream>>>(
        pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, n, p, r2max);
  } else {
    fused_sa_kernel<H1, H2, H3, false><<<grid, kThreads, 0, stream>>>(
        pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, n, p, r2max);
  }
  return cudaGetLastError();
}

}  // namespace

// pts (B, N, 4) = x, y, z, BIG*invalid; a (B, N, H1); cts (B, P, 3);
// bc (B, P, H1); w2 (H1, H2), b2 (H2), w3 (H2, H3), b3 (H3) float32 (the
// weights already rounded to the compute dtype); r2 (H3); active
// (B, ceil(N/chunk), ceil(P/tile)) uint8; out (B, P, H3).
extern "C" int deepclr_fused_sa(const float* pts, const float* a, const float* cts,
                                const float* bc, const float* w2, const float* b2,
                                const float* w3, const float* b3, const float* r2,
                                const uint8_t* active, float* out, int b, int n, int p, int h1,
                                int h2, int h3, int chunk, int tile, float r2max, int bf16,
                                cudaStream_t stream) {
  if (b <= 0 || n <= 0 || p <= 0 || chunk != kChunk || tile != kTile || b > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (h1 == 32 && h2 == 32 && h3 == 64) {
    return (int)launch<32, 32, 64>(pts, a, cts, bc, w2, b2, w3, b3, r2, active, out, b, n, p,
                                   r2max, bf16 != 0, stream);
  }
  return (int)cudaErrorInvalidValue;
}
