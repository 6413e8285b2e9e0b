// Fused set abstraction: ball query + shared MLP + max-pool, its argmax
// variant and its equality-select backward, in one library.
//
//   out[p, c] = max over valid j with |x_j - c_p|^2 < r_c^2 of
//               MLP(x_j - c_p || f_j)[c]         (0 for an empty ball)
//
// Replaces, in deepclr_tpu/ops/pallas/fused_sa_kernel.py:
// * fused_sa_kernel<..., ARGMAX = false>: _make_kernel(with_argmax=False),
//   the Pallas TPU kernel behind ball_mlp_max_pallas;
// * fused_sa_kernel<..., ARGMAX = true>: _make_kernel(with_argmax=True),
//   behind ball_mlp_max_pallas_argmax;
// * fused_sa_bwd_kernel: _make_bwd_kernel, behind ball_mlp_max_bwd_pallas.
// All three live in this one source so that the library hash of
// ops/_cuda.py covers the per-pair code they share.
//
// Semantics (as ops/fused_sa.py::_fused_sa_plain): layer 1 is split outside
// the kernel into a per-point term a_j = x_j W1x + f_j W1f + b1 and a
// per-centre term bc_p = -c_p W1x, both float32; per pair the kernel takes
// relu(a_j + bc_p) in float32, rounds it to the compute dtype, and runs the
// two tail layers with float32 accumulation, a float32 bias and ReLU (the
// middle activation rounded to the compute dtype again).  d^2 is the dx^2
// form with rounded products (-fmad=false), so it equals the culling
// pre-pass (csrc/min_d2.cu) bit for bit; the tail's dot products use
// explicit FMAs in a fixed order (pair_layer1/2/3 below; the backward
// takes pair_layer3's per-column chain), so the backward's recompute equals
// the forward bit for bit.
//
// What bounds them on H100: neither bytes nor FLOPs of the function itself.
// The design depends on sparse balls.  On the synthetic KITTI-like clouds
// that chip_smoke.py drives (normal, sigma = 30, 30, 2 m; 16384 points, 1024
// centres) chip_smoke.py counts about 1.2 points per 1 m ball, so the
// in-radius pairs whose MLP the result needs are ~0.01% of the N x P pairs;
// the time goes to the pair tests of the (chunk, tile) blocks the culling
// bitmap keeps, the block synchronisation around them and the launch of
// B * P/16 blocks.  Real scans, denser near the sensor and on the ground,
// have not been measured; with tens of points per ball the MLP over the
// listed pairs, and in the backward the per-pair back-propagation on the
// 32 lanes of one warp, would take over.
//
// Design: one block per (centre tile of 16, cloud), 128 threads.  The block
// walks the point chunks (128 points) and skips every chunk whose bit in the
// culling bitmap is 0 (the pre-pass min d^2 over the (chunk, tile) block,
// with a margin, is >= r_max^2).  For a kept chunk it stages the points in
// shared memory, tests all 16 x 128 pairs (point-major, so the lanes of a
// warp cover 16 centres), and compacts the pairs with d^2 < r_max^2 into a
// shared list with warp ballots.  Only listed pairs run the MLP: one thread
// per pair, activations in registers, weights read as shared-memory
// broadcasts.  The TPU kernels' lane packing, expansion matmul, SMEM bitmap
// layout, centre splits and tile sweeps are not carried over; the dense
// tail over every tile pair is replaced by the compacted pair list.
//
// Forward: each output column's max lives in shared memory as the int bit
// pattern of a non-negative float (ReLU makes every value >= 0, so int order
// is float order) and is updated with shared atomicMax; the rows are padded
// by one word so the lanes' centres fall in distinct banks.
//
// Argmax (ARGMAX = true): the shared word is 64-bit,
// (float bits << 32) | ~j for the flat point index j, updated with a 64-bit
// atomicMax.  Tie rule: the largest value, and among equal values the
// LOWEST point index (~j is larger for a smaller j).  0 marks "no hit":
// every real key is > 0.  The TPU kernel breaks ties group-major
// (fused_sa_kernel.py:213-224, 464-465), so the two agree on the winner
// only where it is unique; both agree on every value.  An empty ball gives
// out = 0 and j = -1.
//
// Backward (equality-select): the same grid, bitmap and pair list.  Each
// listed pair recomputes its activations through pair_layer1/2 and, one
// column at a time, pair_layer3's FMA chain, and a
// column is selected when d^2 < r_c^2 and its value equals the forward's
// out[p, c]; every tied row gets the full cotangent g[p, c].  The tail is
// back-propagated in registers with the TPU kernel's rounding points
// (fused_sa_kernel.py:646-664): relu' is h > 0 on the float32 value, the
// layer input and delta are rounded to the compute dtype before each
// product, accumulation and db stay float32.  The pairs go in rounds of 32,
// one per lane of warp 0, which stages each pair's rounded layer inputs and
// float32 deltas in shared memory; then every thread sums the dW and db
// entries it owns over the round's pairs in registers, and at the end adds
// them to the global result with one atomicAdd per nonzero entry.  (A
// per-pair shared atomicAdd into dW, the first design, spent ~90% of the
// kernel's time in address conflicts between the lanes of a warp.)  dbc
// goes to shared memory (the block owns its tile) and is written out; da
// takes a global atomicAdd, since a point can lie in balls of several
// tiles.  The atomics make the float32 summation order vary from run to
// run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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

// (x - c)^2 summed x, y, z with rounded products: csrc/min_d2.cu's form
__device__ __forceinline__ float sq_dist(const float4 pt, const float4 ct) {
  const float dx = pt.x - ct.x;
  float d2 = dx * dx;
  const float dy = pt.y - ct.y;
  d2 = d2 + dy * dy;
  const float dz = pt.z - ct.z;
  return d2 + dz * dz;
}

// ---- the per-pair MLP, shared by the forward and the backward ------------

// layer 1: relu(a_j + bc_p) in float32 (not yet rounded)
template <int H1>
__device__ __forceinline__ void pair_layer1(const float* __restrict__ arow, const float* bct,
                                            float (&h1)[H1]) {
  const float4* a4 = reinterpret_cast<const float4*>(arow);
#pragma unroll
  for (int k4 = 0; k4 < H1 / 4; ++k4) {
    const float4 av = __ldg(a4 + k4);
    h1[4 * k4 + 0] = relu(av.x + bct[4 * k4 + 0]);
    h1[4 * k4 + 1] = relu(av.y + bct[4 * k4 + 1]);
    h1[4 * k4 + 2] = relu(av.z + bct[4 * k4 + 2]);
    h1[4 * k4 + 3] = relu(av.w + bct[4 * k4 + 3]);
  }
}

// layer 2 on the rounded layer-1 output: relu(h1 W2 + b2) in float32 (not
// yet rounded); FMAs in input order
template <int H1, int H2>
__device__ __forceinline__ void pair_layer2(const float (&h1)[H1], const float* sw2,
                                            const float* sb2, float (&h2)[H2]) {
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
  for (int c2 = 0; c2 < H2; ++c2) h2[c2] = relu(h2[c2] + sb2[c2]);
}

// layer 3, output columns [cb, cb + kCols) on the rounded layer-2 output
template <int H2, int H3, int kCols>
__device__ __forceinline__ void pair_layer3(const float (&h2)[H2], const float* sw3,
                                            const float* sb3, int cb, float (&acc)[kCols]) {
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
  for (int c3 = 0; c3 < kCols; ++c3) acc[c3] = relu(acc[c3] + sb3[cb + c3]);
}

// ---- the block's shared staging, common to all three kernels -------------

template <int H1, int H2, int H3>
struct Staging {
  float w2[H1 * H2];
  float w3[H2 * H3];
  float b2[H2];
  float b3[H3];
  float r2[H3];
  float bc[kTile * (H1 + 1)];
  float4 cts[kTile];
  float4 pts[kChunk];
  int count;
};

template <int H1, int H2, int H3>
__device__ __forceinline__ void stage_block(Staging<H1, H2, H3>& s, const float* __restrict__ cts,
                                            const float* __restrict__ bc,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ b2,
                                            const float* __restrict__ w3,
                                            const float* __restrict__ b3,
                                            const float* __restrict__ r2, int b, int p, int p0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < H1 * H2; i += kThreads) s.w2[i] = w2[i];
  for (int i = tid; i < H2 * H3; i += kThreads) s.w3[i] = w3[i];
  for (int i = tid; i < H2; i += kThreads) s.b2[i] = b2[i];
  for (int i = tid; i < H3; i += kThreads) {
    s.b3[i] = b3[i];
    s.r2[i] = r2[i];
  }
  for (int i = tid; i < kTile * H1; i += kThreads) {
    const int t = i / H1, k = i % H1, q = p0 + t;
    s.bc[t * (H1 + 1) + k] = q < p ? bc[((size_t)b * p + q) * H1 + k] : 0.0f;
  }
  for (int t = tid; t < kTile; t += kThreads) {
    const int q = p0 + t;
    const float* c = cts + ((size_t)b * p + q) * 3;
    // w = 1 marks a slot past the last centre: it never hits
    s.cts[t] = q < p ? make_float4(c[0], c[1], c[2], 0.0f) : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  }
}

// Stage chunk c's points and compact its in-radius pairs (q = t + i * kTile)
// into `list`; returns the pair count.  Call with every thread of the block.
template <int H1, int H2, int H3, typename Q>
__device__ __forceinline__ int list_pairs(Staging<H1, H2, H3>& s, Q* list, float* d2s,
                                          const float4* __restrict__ pts, int b, int n, int j0,
                                          float r2max) {
  const int tid = threadIdx.x, lane = tid & 31;
  __syncthreads();  // the previous chunk's pairs are consumed
  const int cnt = min(kChunk, n - j0);
  for (int i = tid; i < kChunk; i += kThreads) {
    // w = BIG*invalid for real points; 1 marks a slot past the cloud
    s.pts[i] = i < cnt ? pts[(size_t)b * n + j0 + i] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  }
  if (tid == 0) s.count = 0;
  __syncthreads();

  for (int base = 0; base < kPairs; base += kThreads) {
    const int q = base + tid;
    const float4 ct = s.cts[q % kTile], pt = s.pts[q / kTile];
    const float d2 = sq_dist(pt, ct);
    const bool hit = pt.w == 0.0f && ct.w == 0.0f && d2 < r2max;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot) {
      const int leader = __ffs(ballot) - 1;
      int pos = 0;
      if (lane == leader) pos = atomicAdd(&s.count, __popc(ballot));
      pos = __shfl_sync(0xffffffffu, pos, leader);
      if (hit) {
        pos += __popc(ballot & ((1u << lane) - 1u));
        list[pos] = (Q)q;
        if (d2s != nullptr) d2s[pos] = d2;
      }
    }
  }
  __syncthreads();
  return s.count;
}

// ---- B2 / B5: forward, optionally with the winner index -------------------

template <int H1, int H2, int H3, bool BF16, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
fused_sa_kernel(const float4* __restrict__ pts, const float* __restrict__ a,
                const float* __restrict__ cts, const float* __restrict__ bc,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                const float* __restrict__ r2, const uint8_t* __restrict__ active,
                float* __restrict__ out, int* __restrict__ jstar, int n, int p, float r2max) {
  static_assert(H1 % 4 == 0 && H2 % 4 == 0 && H3 % 4 == 0, "widths must be multiples of 4");
  constexpr int kCols = H3 < 32 ? H3 : 32;  // layer-3 columns per register block
  static_assert(H3 % kCols == 0, "H3 must be a multiple of the column block");
  using Key = std::conditional_t<ARGMAX, unsigned long long, int>;

  __shared__ __align__(16) Staging<H1, H2, H3> s;
  __shared__ Key smax[kTile * (H3 + 1)];
  __shared__ int slist[kPairs];
  __shared__ float sd2[kPairs];

  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int tid = threadIdx.x;
  const int p0 = tile * kTile;
  const int nc = (n + kChunk - 1) / kChunk;

  stage_block(s, cts, bc, w2, b2, w3, b3, r2, b, p, p0);
  // no hit yet: -1 for the value bits, 0 for the (value, ~j) key
  for (int i = tid; i < kTile * (H3 + 1); i += kThreads) smax[i] = ARGMAX ? Key(0) : Key(-1);

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c = 0; c < nc; ++c) {
    if (!act[(size_t)c * ntiles]) continue;  // same byte for the whole block
    const int j0 = c * kChunk;
    const int total = list_pairs(s, slist, sd2, pts, b, n, j0, r2max);

    for (int e = tid; e < total; e += kThreads) {
      const int q = slist[e];
      const float d2 = sd2[e];
      const int t = q % kTile, j = j0 + q / kTile;

      float h1[H1];
      pair_layer1<H1>(a + ((size_t)b * n + j) * H1, s.bc + t * (H1 + 1), h1);
#pragma unroll
      for (int k = 0; k < H1; ++k) h1[k] = to_cd<BF16>(h1[k]);
      float h2[H2];
      pair_layer2<H1, H2>(h1, s.w2, s.b2, h2);
#pragma unroll
      for (int k = 0; k < H2; ++k) h2[k] = to_cd<BF16>(h2[k]);

      Key* mrow = smax + t * (H3 + 1);
#pragma unroll
      for (int cb = 0; cb < H3; cb += kCols) {
        float v[kCols];
        pair_layer3<H2, H3, kCols>(h2, s.w3, s.b3, cb, v);
#pragma unroll
        for (int c3 = 0; c3 < kCols; ++c3) {
          if (d2 < s.r2[cb + c3]) {
            if constexpr (ARGMAX) {
              const unsigned long long key =
                  ((unsigned long long)__float_as_uint(v[c3]) << 32) | (unsigned)(~j);
              atomicMax(mrow + cb + c3, key);
            } else {
              atomicMax(mrow + cb + c3, __float_as_int(v[c3]));
            }
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < kTile * H3; i += kThreads) {
    const int t = i / H3, col = i % H3, q = p0 + t;
    if (q < p) {
      const Key v = smax[t * (H3 + 1) + col];
      const size_t o = ((size_t)b * p + q) * H3 + col;
      if constexpr (ARGMAX) {
        out[o] = v == 0 ? 0.0f : __uint_as_float((unsigned)(v >> 32));
        jstar[o] = v == 0 ? -1 : (int)(~(unsigned)(v & 0xffffffffull));
      } else {
        out[o] = v < 0 ? 0.0f : __int_as_float(v);
      }
    }
  }
}

// ---- B4: equality-select backward -----------------------------------------

constexpr int kRound = 32;  // pairs back-propagated per round, one per lane of warp 0

template <int H1, int H2, int H3, bool BF16>
__global__ void __launch_bounds__(kThreads)
fused_sa_bwd_kernel(const float4* __restrict__ pts, const float* __restrict__ a,
                    const float* __restrict__ cts, const float* __restrict__ bc,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ r2, const uint8_t* __restrict__ active,
                    const float* __restrict__ out, const float* __restrict__ g,
                    float* __restrict__ da, float* __restrict__ dbc, float* __restrict__ dw2,
                    float* __restrict__ db2, float* __restrict__ dw3, float* __restrict__ db3,
                    int n, int p, float r2max) {
  static_assert(H1 % 4 == 0 && H2 % 4 == 0 && H3 % 4 == 0, "widths must be multiples of 4");
  static_assert(H1 <= 32 && H2 <= 32, "relu' masks are 32-bit words");
  static_assert((H2 * H3) % kThreads == 0 && (H1 * H2) % kThreads == 0 && H2 + H3 <= kThreads,
                "every dW entry and bias has one owning thread");
  constexpr int kOwn3 = H2 * H3 / kThreads;  // dW3 entries each thread sums
  constexpr int kOwn2 = H1 * H2 / kThreads;  // dW2 entries each thread sums

  __shared__ __align__(16) Staging<H1, H2, H3> s;
  __shared__ unsigned short slist[kPairs];
  __shared__ float sdbc[kTile * (H1 + 1)];
  // one round's pairs: the rounded layer inputs and the float32 deltas of
  // layers 2 and 3 (rows padded by one word: lane r writes row r)
  __shared__ float sh1[kRound][H1 + 1];
  __shared__ float sh2[kRound][H2 + 1];
  __shared__ float sd2[kRound][H2 + 1];
  __shared__ float sd3[kRound][H3 + 1];

  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int tid = threadIdx.x;
  const int p0 = tile * kTile;
  const int nc = (n + kChunk - 1) / kChunk;

  stage_block(s, cts, bc, w2, b2, w3, b3, r2, b, p, p0);
  for (int i = tid; i < kTile * (H1 + 1); i += kThreads) sdbc[i] = 0.0f;
  float acc3[kOwn3], acc2[kOwn2], accb = 0.0f;
#pragma unroll
  for (int r = 0; r < kOwn3; ++r) acc3[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < kOwn2; ++r) acc2[r] = 0.0f;

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c = 0; c < nc; ++c) {
    if (!act[(size_t)c * ntiles]) continue;
    const int j0 = c * kChunk;
    const int total = list_pairs(s, slist, (float*)nullptr, pts, b, n, j0, r2max);

    for (int base = 0; base < total; base += kRound) {
      const int live = min(kRound, total - base);
      if (tid < live) {
        const int q = slist[base + tid];
        const int t = q % kTile, i = q / kTile, j = j0 + i;
        const float d2 = sq_dist(s.pts[i], s.cts[t]);  // the forward's bits
        const float* arow = a + ((size_t)b * n + j) * H1;

        // recompute, keeping relu' (h > 0 on the float32 value) as bit masks
        unsigned m1 = 0u, m2 = 0u;
        float h2[H2];
        {
          float h1[H1];
          pair_layer1<H1>(arow, s.bc + t * (H1 + 1), h1);
#pragma unroll
          for (int k = 0; k < H1; ++k) {
            m1 |= (h1[k] > 0.0f ? 1u : 0u) << k;
            h1[k] = to_cd<BF16>(h1[k]);
            sh1[tid][k] = h1[k];
          }
          pair_layer2<H1, H2>(h1, s.w2, s.b2, h2);
        }
#pragma unroll
        for (int k = 0; k < H2; ++k) {
          m2 |= (h2[k] > 0.0f ? 1u : 0u) << k;
          h2[k] = to_cd<BF16>(h2[k]);
          sh2[tid][k] = h2[k];
        }

        // layer 3: select by equality with the forward.  One column at a
        // time; each column's value is pair_layer3's FMA chain for that
        // column, so it equals the forward's bit for bit.
        const size_t row = ((size_t)b * p + p0 + t) * H3;
        float dh2[H2];
#pragma unroll
        for (int k = 0; k < H2; ++k) dh2[k] = 0.0f;
#pragma unroll 1
        for (int col = 0; col < H3; ++col) {
          float dl = 0.0f;
          if (d2 < s.r2[col]) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < H2; ++k) acc = __fmaf_rn(h2[k], s.w3[k * H3 + col], acc);
            const float v = relu(acc + s.b3[col]);
            if (v > 0.0f && v == __ldg(out + row + col)) dl = __ldg(g + row + col);
          }
          sd3[tid][col] = dl;
          if (dl != 0.0f) {
            const float dr = to_cd<BF16>(dl);
#pragma unroll
            for (int k = 0; k < H2; ++k) dh2[k] = __fmaf_rn(dr, s.w3[k * H3 + col], dh2[k]);
          }
        }

        // layer 2
        float dh1[H1];
#pragma unroll
        for (int k = 0; k < H1; ++k) dh1[k] = 0.0f;
#pragma unroll
        for (int m = 0; m < H2; ++m) {
          const float dl = (m2 >> m) & 1u ? dh2[m] : 0.0f;
          sd2[tid][m] = dl;
          if (dl != 0.0f) {
            const float dr = to_cd<BF16>(dl);
#pragma unroll
            for (int k = 0; k < H1; ++k) dh1[k] = __fmaf_rn(dr, s.w2[k * H2 + m], dh1[k]);
          }
        }

        // layer 1: the cotangents of a_j and bc_p
        float* darow = da + ((size_t)b * n + j) * H1;
        float* dbct = sdbc + t * (H1 + 1);
#pragma unroll
        for (int k = 0; k < H1; ++k) {
          const float d0 = (m1 >> k) & 1u ? dh1[k] : 0.0f;
          if (d0 != 0.0f) {
            atomicAdd(darow + k, d0);
            atomicAdd(dbct + k, d0);
          }
        }
      }
      __syncthreads();

      // dW = sum over the round's pairs of (rounded input) x (rounded delta),
      // db = sum of the deltas: each thread sums the entries it owns
      for (int e = 0; e < live; ++e) {
#pragma unroll
        for (int r = 0; r < kOwn3; ++r) {
          const int idx = tid + r * kThreads;
          acc3[r] += sh2[e][idx / H3] * to_cd<BF16>(sd3[e][idx % H3]);
        }
#pragma unroll
        for (int r = 0; r < kOwn2; ++r) {
          const int idx = tid + r * kThreads;
          acc2[r] += sh1[e][idx / H2] * to_cd<BF16>(sd2[e][idx % H2]);
        }
        if (tid < H3) {
          accb += sd3[e][tid];
        } else if (tid < H3 + H2) {
          accb += sd2[e][tid - H3];
        }
      }
      __syncthreads();  // the next round overwrites the staged pairs
    }
  }
  __syncthreads();

  for (int i = tid; i < kTile * H1; i += kThreads) {
    const int t = i / H1, k = i % H1, q = p0 + t;
    if (q < p) dbc[((size_t)b * p + q) * H1 + k] = sdbc[t * (H1 + 1) + k];
  }
#pragma unroll
  for (int r = 0; r < kOwn3; ++r) {
    if (acc3[r] != 0.0f) atomicAdd(dw3 + tid + r * kThreads, acc3[r]);
  }
#pragma unroll
  for (int r = 0; r < kOwn2; ++r) {
    if (acc2[r] != 0.0f) atomicAdd(dw2 + tid + r * kThreads, acc2[r]);
  }
  if (accb != 0.0f) {
    if (tid < H3) {
      atomicAdd(db3 + tid, accb);
    } else if (tid < H3 + H2) {
      atomicAdd(db2 + tid - H3, accb);
    }
  }
}

template <int H1, int H2, int H3, bool ARGMAX>
cudaError_t launch_fwd(const float* pts, const float* a, const float* cts, const float* bc,
                       const float* w2, const float* b2, const float* w3, const float* b3,
                       const float* r2, const uint8_t* active, float* out, int* jstar, int b,
                       int n, int p, float r2max, bool bf16, cudaStream_t stream) {
  const dim3 grid((p + kTile - 1) / kTile, b);
  const float4* pts4 = reinterpret_cast<const float4*>(pts);
  if (bf16) {
    fused_sa_kernel<H1, H2, H3, true, ARGMAX><<<grid, kThreads, 0, stream>>>(
        pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, jstar, n, p, r2max);
  } else {
    fused_sa_kernel<H1, H2, H3, false, ARGMAX><<<grid, kThreads, 0, stream>>>(
        pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, jstar, n, p, r2max);
  }
  return cudaGetLastError();
}

bool valid_shape(int b, int n, int p, int chunk, int tile) {
  return b > 0 && n > 0 && p > 0 && chunk == kChunk && tile == kTile && b <= 65535;
}

bool compiled_widths(int h1, int h2, int h3) { return h1 == 32 && h2 == 32 && h3 == 64; }

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
  if (!valid_shape(b, n, p, chunk, tile) || !compiled_widths(h1, h2, h3)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_fwd<32, 32, 64, false>(pts, a, cts, bc, w2, b2, w3, b3, r2, active, out,
                                            nullptr, b, n, p, r2max, bf16 != 0, stream);
}

// As deepclr_fused_sa, plus jstar (B, P, H3) int32: the flat point index of
// each column's winner (lowest index on ties), -1 for an empty ball.
extern "C" int deepclr_fused_sa_argmax(const float* pts, const float* a, const float* cts,
                                       const float* bc, const float* w2, const float* b2,
                                       const float* w3, const float* b3, const float* r2,
                                       const uint8_t* active, float* out, int* jstar, int b,
                                       int n, int p, int h1, int h2, int h3, int chunk,
                                       int tile, float r2max, int bf16, cudaStream_t stream) {
  if (!valid_shape(b, n, p, chunk, tile) || !compiled_widths(h1, h2, h3)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_fwd<32, 32, 64, true>(pts, a, cts, bc, w2, b2, w3, b3, r2, active, out,
                                           jstar, b, n, p, r2max, bf16 != 0, stream);
}

// The forward's operands, plus out (B, P, H3) (the forward's own output)
// and g (B, P, H3) its cotangent.  Writes dbc (B, P, H1) and adds into da
// (B, N, H1), dw2 (H1, H2), db2 (H2), dw3 (H2, H3), db3 (H3), which the
// caller zeroes.
extern "C" int deepclr_fused_sa_bwd(const float* pts, const float* a, const float* cts,
                                    const float* bc, const float* w2, const float* b2,
                                    const float* w3, const float* b3, const float* r2,
                                    const uint8_t* active, const float* out, const float* g,
                                    float* da, float* dbc, float* dw2, float* db2, float* dw3,
                                    float* db3, int b, int n, int p, int h1, int h2, int h3,
                                    int chunk, int tile, float r2max, int bf16,
                                    cudaStream_t stream) {
  if (!valid_shape(b, n, p, chunk, tile) || !compiled_widths(h1, h2, h3)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((p + kTile - 1) / kTile, b);
  const float4* pts4 = reinterpret_cast<const float4*>(pts);
  if (bf16 != 0) {
    fused_sa_bwd_kernel<32, 32, 64, true><<<grid, kThreads, 0, stream>>>(
        pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da, dbc, dw2, db2, dw3, db3, n, p,
        r2max);
  } else {
    fused_sa_bwd_kernel<32, 32, 64, false><<<grid, kThreads, 0, stream>>>(
        pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da, dbc, dw2, db2, dw3, db3, n, p,
        r2max);
  }
  return (int)cudaGetLastError();
}
