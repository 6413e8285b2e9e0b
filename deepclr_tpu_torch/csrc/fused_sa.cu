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
// listed pairs, and in the backward each pair's recompute and
// back-propagation, would take over (chip_smoke.py times a dense case).
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
// Backward (equality-select): the same grid, bitmap and pair list; each
// listed pair recomputes its activations with the forward's FMA chains and
// selects the columns whose value equals the forward's out[p, c].  The
// section above fused_sa_bwd_kernel gives its design.
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

// kWeights = false leaves s.w2 and s.w3 unwritten (the backward keeps its
// own copies)
template <bool kWeights = true, int H1, int H2, int H3>
__device__ __forceinline__ void stage_block(Staging<H1, H2, H3>& s, const float* __restrict__ cts,
                                            const float* __restrict__ bc,
                                            const float* __restrict__ w2,
                                            const float* __restrict__ b2,
                                            const float* __restrict__ w3,
                                            const float* __restrict__ b3,
                                            const float* __restrict__ r2, int b, int p, int p0) {
  const int tid = threadIdx.x;
  if constexpr (kWeights) {
    for (int i = tid; i < H1 * H2; i += kThreads) s.w2[i] = w2[i];
    for (int i = tid; i < H2 * H3; i += kThreads) s.w3[i] = w3[i];
  }
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
//
// Replaces: deepclr_tpu/ops/pallas/fused_sa_kernel.py::_make_bwd_kernel (the
// Pallas TPU kernel behind ball_mlp_max_bwd_pallas).
//
// Per listed pair: recompute the MLP, select a column when d^2 < r_c^2 and
// its value equals the forward's out[p, c] (every tied row gets the full
// cotangent g[p, c]), and back-propagate the tail with the TPU kernel's
// rounding points (fused_sa_kernel.py:646-664): relu' is h > 0 on the
// float32 value, the layer input and delta are rounded to the compute dtype
// before each product, sums and db stay float32.
//
// What bounds it on H100: not the function's bytes or operations (its
// bound counts ~10 us at the train shapes) but, per block, the latency of
// the pair tests (as in B2) and of each pair's chain of dependent
// multiply-adds.  The first design carried each pair on one lane of
// warp 0 through every step in sequence (~5,000 dependent FMAs and shared
// loads) while the other three warps waited: 0.559 ms at 10 x 16384 -> 1024
// (NVIDIA H100 80GB HBM3, 700 W), 56x its bound, and slower as balls fill.
//
// Design: the same grid (one block of 4 warps per 16-centre tile), culling
// bitmap and pair list as B2.  The pairs go in rounds of up to 32, split
// into four contiguous runs, one a warp, and a warp takes its pairs one at
// a time with its lanes over units:
//   * lane c computes layer-1 unit c, layer-2 unit c and layer-3 columns c
//     and c + 32, each with the forward's FMA chain (pair_layer2/3: k
//     ascending from 0, then the bias, then ReLU), its weights (W2 column
//     c, W3 columns c and c + 32) held in registers for the whole block
//     and the rounded layer input read as float4 broadcasts from the pair's
//     staged shared row; so each value equals the forward's bit for bit and
//     the equality test selects the forward's winners.  (With the weights
//     in shared memory too, the shared-memory pipe, ~160 loads a pair, bound
//     the dense case);
//   * dh2 = W3 d3 and dh1 = W2 d2 take lanes over the input unit, summing
//     only the selected columns (warp ballots) of the staged rounded delta
//     row, against copies of W3 and W2 in shared memory with rows padded
//     by one word, so lanes over input units read them conflict-free;
//   * no global load waits on the chain: the tile's out and g rows are
//     staged in shared memory once, and each warp loads its next pair's
//     point term a_j while it works on the current pair;
//   * da goes to global atomics, summed in registers over consecutive pairs
//     of one point (the list holds a point's centres together); dbc to
//     shared atomics (the block owns its tile); db to per-lane registers.
// After each round the block reduces dW3 += h2^T d3 and dW2 += h1^T d2 over
// the round's staged rows.  In the bf16 instantiation the staged operands
// are exact bf16 values, so the sums are mma.sync.m16n8k16 bf16 -> f32
// products on the tensor cores (24 tiles of 16 x 8, six a warp, two k-steps
// a round), the product the TPU kernel takes with its matmul.  The float32
// instantiation sums on the CUDA cores, each thread the entries it owns
// (TF32 would round the inputs).  At the end, one global atomicAdd per
// nonzero dW and db entry and block.  The atomics make the float32
// summation order vary from run to run.
//
// Measured (chip_smoke.py, back-to-back launches, NVIDIA H100 80GB HBM3,
// 700 W), bf16 at 10 clouds x 16384 -> 1024: 0.19 ms on the synthetic
// clouds (~1.2 points a 1 m ball; B2 0.18 ms), 2.1 ms on a dense cube
// (~190 points a 1 m ball; B2 1.2 ms).

constexpr int kWarps = kThreads / 32;
constexpr int kRound = 32;  // pairs staged per round
constexpr unsigned kFull = 0xffffffffu;

// One round's pairs: the rounded layer inputs and rounded deltas.  Rows
// are padded by 4 words: 16-byte aligned for float4 broadcasts, and the mma
// fragment loads (row 2t, column g) fall in 32 distinct banks.  Rows past
// the round's last pair are zero.
constexpr int kPad = 4;
template <int H1, int H2, int H3>
struct __align__(16) RoundRows {
  float h1[kRound][H1 + kPad];
  float h2[kRound][H2 + kPad];
  float d2[kRound][H2 + kPad];
  float d3[kRound][H3 + kPad];
};

// The tile's forward output and its cotangent, read by every pair's
// selection test.
template <int H3>
struct TileRows {
  float out[kTile][H3];
  float g[kTile][H3];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b for one 16 x 8 tile: A 16 x 16 (row), B 16 x 8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// dW3 (H2 x H3) and dW2 (H1 x H2) summed over the staged rounds.
template <int H1, int H2, int H3, bool BF16>
struct DwSums;

// float32: every thread sums the entries it owns, on the CUDA cores.
template <int H1, int H2, int H3>
struct DwSums<H1, H2, H3, false> {
  static_assert((H2 * H3) % kThreads == 0 && (H1 * H2) % kThreads == 0,
                "every dW entry has one owning thread");
  static constexpr int kOwn3 = H2 * H3 / kThreads;
  static constexpr int kOwn2 = H1 * H2 / kThreads;
  float acc3[kOwn3], acc2[kOwn2];

  __device__ DwSums() {
#pragma unroll
    for (int r = 0; r < kOwn3; ++r) acc3[r] = 0.0f;
#pragma unroll
    for (int r = 0; r < kOwn2; ++r) acc2[r] = 0.0f;
  }

  __device__ void add(const RoundRows<H1, H2, H3>& rows, int live) {
    const int tid = threadIdx.x;
    for (int e = 0; e < live; ++e) {
#pragma unroll
      for (int r = 0; r < kOwn3; ++r) {
        const int idx = tid + r * kThreads;
        acc3[r] += rows.h2[e][idx / H3] * rows.d3[e][idx % H3];
      }
#pragma unroll
      for (int r = 0; r < kOwn2; ++r) {
        const int idx = tid + r * kThreads;
        acc2[r] += rows.h1[e][idx / H2] * rows.d2[e][idx % H2];
      }
    }
  }

  __device__ void flush(float* dw2, float* dw3) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < kOwn3; ++r) {
      if (acc3[r] != 0.0f) atomicAdd(dw3 + tid + r * kThreads, acc3[r]);
    }
#pragma unroll
    for (int r = 0; r < kOwn2; ++r) {
      if (acc2[r] != 0.0f) atomicAdd(dw2 + tid + r * kThreads, acc2[r]);
    }
  }
};

// bf16: the tensor cores.  Tile tau of the 24: tau < 16 is dW3's
// (rows 16 * (tau / 8), columns 8 * (tau % 8)), the rest dW2's.
template <int H1, int H2, int H3>
struct DwSums<H1, H2, H3, true> {
  static_assert(H1 == 32 && H2 == 32 && H3 == 64, "the tile map is for widths (32, 32, 64)");
  static constexpr int kTiles3 = (H2 / 16) * (H3 / 8);
  static constexpr int kTilesPerWarp = (kTiles3 + (H1 / 16) * (H2 / 8)) / kWarps;
  float acc[kTilesPerWarp][4];

  __device__ DwSums() {
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }

  // tile tau: its A rows (staged [pair][unit] rows, read transposed), its B
  // rows, their strides, and the tile's first row and column of dW
  __device__ static void tile(const RoundRows<H1, H2, H3>& rows, int tau, const float*& a,
                              const float*& bm, int& sb, int& mb, int& nb) {
    if (tau < kTiles3) {
      a = &rows.h2[0][0];
      bm = &rows.d3[0][0];
      sb = H3 + kPad;
      mb = 16 * (tau / (H3 / 8));
      nb = 8 * (tau % (H3 / 8));
    } else {
      const int u = tau - kTiles3;
      a = &rows.h1[0][0];
      bm = &rows.d2[0][0];
      sb = H2 + kPad;
      mb = 16 * (u / (H2 / 8));
      nb = 8 * (u % (H2 / 8));
    }
  }

  __device__ void add(const RoundRows<H1, H2, H3>& rows, int live) {
    constexpr int sa = H1 + kPad;  // == H2 + kPad: the stride of both A sources
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gr = lane >> 2, tg = lane & 3;
    for (int kb = 0; kb < live; kb += 16) {
#pragma unroll
      for (int i = 0; i < kTilesPerWarp; ++i) {
        const float* a;
        const float* bm;
        int sb, mb, nb;
        tile(rows, warp * kTilesPerWarp + i, a, bm, sb, mb, nb);
        // A[m][k] = a[(kb + k) * sa + mb + m], B[k][n] = bm[(kb + k) * sb + nb + n]
        const float* a0 = a + (kb + 2 * tg) * sa + mb + gr;
        const float* b0 = bm + (kb + 2 * tg) * sb + nb + gr;
        mma_bf16(acc[i], pack_bf16(a0[0], a0[sa]), pack_bf16(a0[8], a0[sa + 8]),
                 pack_bf16(a0[8 * sa], a0[9 * sa]), pack_bf16(a0[8 * sa + 8], a0[9 * sa + 8]),
                 pack_bf16(b0[0], b0[sb]), pack_bf16(b0[8 * sb], b0[9 * sb]));
      }
    }
  }

  __device__ void flush(float* dw2, float* dw3) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gr = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i) {
      const int tau = warp * kTilesPerWarp + i;
      const bool l3 = tau < kTiles3;
      const int u = l3 ? tau : tau - kTiles3;
      const int ncols = l3 ? H3 : H2;
      const int mb = 16 * (u / (ncols / 8)), nb = 8 * (u % (ncols / 8));
      float* dw = l3 ? dw3 : dw2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mb + gr + 8 * (e >> 1), col = nb + 2 * tg + (e & 1);
        if (acc[i][e] != 0.0f) atomicAdd(dw + row * ncols + col, acc[i][e]);
      }
    }
  }
};

// bf16: registers capped so three blocks share an SM (168 a thread, a
// small spill; measured faster than two blocks at ~230).  float32: the
// owner-computes dW sums spill badly under that cap, so two blocks.
template <int H1, int H2, int H3, bool BF16>
__global__ void __launch_bounds__(kThreads, BF16 ? 3 : 1)
fused_sa_bwd_kernel(const float4* __restrict__ pts, const float* __restrict__ a,
                    const float* __restrict__ cts, const float* __restrict__ bc,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ r2, const uint8_t* __restrict__ active,
                    const float* __restrict__ out, const float* __restrict__ g,
                    float* __restrict__ da, float* __restrict__ dbc, float* __restrict__ dw2,
                    float* __restrict__ db2, float* __restrict__ dw3, float* __restrict__ db3,
                    int n, int p, float r2max) {
  static_assert(H1 == 32 && H2 == 32 && H3 == 64,
                "lane c owns layer-1/2 unit c and layer-3 columns c, c + 32");
  using Rows = RoundRows<H1, H2, H3>;

  __shared__ __align__(16) Staging<H1, H2, H3> s;
  __shared__ unsigned short slist[kPairs];
  __shared__ float sdbc[kTile * (H1 + 1)];
  // the weights with rows padded by one word, for the back-propagation:
  // lanes over input units read them conflict-free
  __shared__ float w2p[H1][H2 + 1];
  __shared__ float w3p[H2][H3 + 1];
  __shared__ float sdb[H3 + H2];  // db3 then db2, summed over the block's warps
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Rows& rows = *reinterpret_cast<Rows*>(dyn_smem);
  TileRows<H3>& tr = *reinterpret_cast<TileRows<H3>*>(dyn_smem + sizeof(Rows));

  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tile * kTile;
  const int nc = (n + kChunk - 1) / kChunk;

  stage_block<false>(s, cts, bc, w2, b2, w3, b3, r2, b, p, p0);
  for (int i = tid; i < H1 * H2; i += kThreads) w2p[i / H2][i % H2] = w2[i];
  for (int i = tid; i < H2 * H3; i += kThreads) w3p[i / H3][i % H3] = w3[i];
  for (int i = tid; i < kTile * H3; i += kThreads) {
    const int t = i / H3, q = p0 + t;
    const size_t o = ((size_t)b * p + q) * H3 + i % H3;
    tr.out[t][i % H3] = q < p ? out[o] : 0.0f;
    tr.g[t][i % H3] = q < p ? g[o] : 0.0f;
  }
  for (int i = tid; i < kTile * (H1 + 1); i += kThreads) sdbc[i] = 0.0f;
  for (int i = tid; i < H3 + H2; i += kThreads) sdb[i] = 0.0f;
  // this lane's recompute weights, in registers: W2 column lane, W3 columns
  // lane and lane + 32
  float w2c[H1], w3lo[H2], w3hi[H2];
#pragma unroll
  for (int k = 0; k < H1; ++k) w2c[k] = __ldg(w2 + k * H2 + lane);
#pragma unroll
  for (int k = 0; k < H2; ++k) {
    w3lo[k] = __ldg(w3 + k * H3 + lane);
    w3hi[k] = __ldg(w3 + k * H3 + lane + 32);
  }
  DwSums<H1, H2, H3, BF16> dw;
  float db3_lo = 0.0f, db3_hi = 0.0f, db2_c = 0.0f;  // columns lane, lane + 32; unit lane

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c = 0; c < nc; ++c) {
    if (!act[(size_t)c * ntiles]) continue;
    const int j0 = c * kChunk;
    const int total = list_pairs(s, slist, (float*)nullptr, pts, b, n, j0, r2max);

    for (int base = 0; base < total; base += kRound) {
      const int live = min(kRound, total - base);
      for (int r = live + warp; r < kRound; r += kWarps) {  // rows past the round's pairs
        rows.h1[r][lane] = rows.h2[r][lane] = rows.d2[r][lane] = 0.0f;
        rows.d3[r][lane] = rows.d3[r][lane + 32] = 0.0f;
      }
      // warp w takes the round's rows [w * per, (w + 1) * per): contiguous,
      // so a point's pairs stay together, and spread over the four warps
      const int per = (live + kWarps - 1) / kWarps;
      const int r_begin = warp * per, r_end = min(r_begin + per, live);
      int cur_j = -1;  // the point whose da the lanes are summing
      float da_sum = 0.0f;
      // the point term of the warp's next pair, loaded one pair ahead
      float a_next = 0.0f;
      if (r_begin < r_end) {
        a_next = __ldg(a + ((size_t)b * n + j0 + slist[base + r_begin] / kTile) * H1 + lane);
      }
      for (int r = r_begin; r < r_end; ++r) {
        const int q = slist[base + r];
        const int t = q % kTile, i = q / kTile, j = j0 + i;
        const float a_j = a_next;
        if (r + 1 < r_end) {
          a_next = __ldg(a + ((size_t)b * n + j0 + slist[base + r + 1] / kTile) * H1 + lane);
        }
        const float d2 = sq_dist(s.pts[i], s.cts[t]);  // the forward's bits

        // layer 1, unit lane: pair_layer1's value
        const float h1 = relu(a_j + s.bc[t * (H1 + 1) + lane]);
        rows.h1[r][lane] = to_cd<BF16>(h1);
        __syncwarp();
        // layer 2, unit lane: pair_layer2's chain
        float acc2 = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < H1 / 4; ++k4) {
          const float4 hv = *reinterpret_cast<const float4*>(&rows.h1[r][4 * k4]);
          acc2 = __fmaf_rn(hv.x, w2c[4 * k4 + 0], acc2);
          acc2 = __fmaf_rn(hv.y, w2c[4 * k4 + 1], acc2);
          acc2 = __fmaf_rn(hv.z, w2c[4 * k4 + 2], acc2);
          acc2 = __fmaf_rn(hv.w, w2c[4 * k4 + 3], acc2);
        }
        const float h2 = relu(acc2 + s.b2[lane]);
        rows.h2[r][lane] = to_cd<BF16>(h2);
        __syncwarp();
        // layer 3, columns lane and lane + 32: pair_layer3's chain
        float v_lo = 0.0f, v_hi = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < H2 / 4; ++k4) {
          const float4 hv = *reinterpret_cast<const float4*>(&rows.h2[r][4 * k4]);
          v_lo = __fmaf_rn(hv.x, w3lo[4 * k4 + 0], v_lo);
          v_hi = __fmaf_rn(hv.x, w3hi[4 * k4 + 0], v_hi);
          v_lo = __fmaf_rn(hv.y, w3lo[4 * k4 + 1], v_lo);
          v_hi = __fmaf_rn(hv.y, w3hi[4 * k4 + 1], v_hi);
          v_lo = __fmaf_rn(hv.z, w3lo[4 * k4 + 2], v_lo);
          v_hi = __fmaf_rn(hv.z, w3hi[4 * k4 + 2], v_hi);
          v_lo = __fmaf_rn(hv.w, w3lo[4 * k4 + 3], v_lo);
          v_hi = __fmaf_rn(hv.w, w3hi[4 * k4 + 3], v_hi);
        }
        v_lo = relu(v_lo + s.b3[lane]);
        v_hi = relu(v_hi + s.b3[lane + 32]);

        // select by equality with the forward
        const float g_lo = d2 < s.r2[lane] && v_lo > 0.0f && v_lo == tr.out[t][lane] ? tr.g[t][lane] : 0.0f;
        const float g_hi = d2 < s.r2[lane + 32] && v_hi > 0.0f && v_hi == tr.out[t][lane + 32]
                               ? tr.g[t][lane + 32] : 0.0f;
        db3_lo += g_lo;
        db3_hi += g_hi;
        rows.d3[r][lane] = to_cd<BF16>(g_lo);
        rows.d3[r][lane + 32] = to_cd<BF16>(g_hi);
        const unsigned sel_lo = __ballot_sync(kFull, g_lo != 0.0f);
        const unsigned sel_hi = __ballot_sync(kFull, g_hi != 0.0f);
        if ((sel_lo | sel_hi) == 0u) {  // no column selected: nothing flows back
          rows.d2[r][lane] = 0.0f;
          continue;
        }
        __syncwarp();

        // dh2 = W3 d3, lane over the input unit
        float dh2 = 0.0f;
        for (unsigned m = sel_lo; m != 0u; m &= m - 1u) {
          const int col = __ffs(m) - 1;
          dh2 = __fmaf_rn(rows.d3[r][col], w3p[lane][col], dh2);
        }
        for (unsigned m = sel_hi; m != 0u; m &= m - 1u) {
          const int col = 32 + __ffs(m) - 1;
          dh2 = __fmaf_rn(rows.d3[r][col], w3p[lane][col], dh2);
        }
        const float dl2 = h2 > 0.0f ? dh2 : 0.0f;
        db2_c += dl2;
        rows.d2[r][lane] = to_cd<BF16>(dl2);
        const unsigned sel2 = __ballot_sync(kFull, dl2 != 0.0f);
        __syncwarp();

        // dh1 = W2 d2, lane over the input unit
        float dh1 = 0.0f;
        for (unsigned m = sel2; m != 0u; m &= m - 1u) {
          const int u = __ffs(m) - 1;
          dh1 = __fmaf_rn(rows.d2[r][u], w2p[lane][u], dh1);
        }
        const float d0 = h1 > 0.0f ? dh1 : 0.0f;

        // layer 1: the cotangents of a_j and bc_p
        if (j != cur_j) {  // warp-uniform
          if (cur_j >= 0 && da_sum != 0.0f) atomicAdd(da + ((size_t)b * n + cur_j) * H1 + lane, da_sum);
          cur_j = j;
          da_sum = 0.0f;
        }
        da_sum += d0;
        if (d0 != 0.0f) atomicAdd(sdbc + t * (H1 + 1) + lane, d0);
      }
      if (cur_j >= 0 && da_sum != 0.0f) atomicAdd(da + ((size_t)b * n + cur_j) * H1 + lane, da_sum);
      __syncthreads();
      dw.add(rows, live);
      __syncthreads();  // the next round overwrites the staged rows
    }
  }

  if (db3_lo != 0.0f) atomicAdd(sdb + lane, db3_lo);
  if (db3_hi != 0.0f) atomicAdd(sdb + lane + 32, db3_hi);
  if (db2_c != 0.0f) atomicAdd(sdb + H3 + lane, db2_c);
  __syncthreads();

  for (int i = tid; i < kTile * H1; i += kThreads) {
    const int t = i / H1, k = i % H1, q = p0 + t;
    if (q < p) dbc[((size_t)b * p + q) * H1 + k] = sdbc[t * (H1 + 1) + k];
  }
  dw.flush(dw2, dw3);
  if (tid < H3 + H2 && sdb[tid] != 0.0f) atomicAdd(tid < H3 ? db3 + tid : db2 + tid - H3, sdb[tid]);
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

// B4 at the compiled widths: its round and tile rows live in dynamic shared
// memory (static and dynamic together exceed the 48 KB a launch gets by
// default).
template <bool BF16>
cudaError_t launch_bwd(const float4* pts, const float* a, const float* cts, const float* bc,
                       const float* w2, const float* b2, const float* w3, const float* b3,
                       const float* r2, const uint8_t* active, const float* out, const float* g,
                       float* da, float* dbc, float* dw2, float* db2, float* dw3, float* db3, int b,
                       int n, int p, float r2max, cudaStream_t stream) {
  const auto kernel = fused_sa_bwd_kernel<32, 32, 64, BF16>;
  const int smem = (int)(sizeof(RoundRows<32, 32, 64>) + sizeof(TileRows<64>));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kTile - 1) / kTile, b);
  kernel<<<grid, kThreads, smem, stream>>>(pts, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da,
                                           dbc, dw2, db2, dw3, db3, n, p, r2max);
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
  const float4* pts4 = reinterpret_cast<const float4*>(pts);
  if (bf16 != 0) {
    return (int)launch_bwd<true>(pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da, dbc, dw2,
                                 db2, dw3, db3, b, n, p, r2max, stream);
  }
  return (int)launch_bwd<false>(pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da, dbc, dw2,
                                db2, dw3, db3, b, n, p, r2max, stream);
}
