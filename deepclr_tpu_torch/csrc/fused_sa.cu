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
// * fused_sa_bwd_kernel: _make_bwd_kernel, behind ball_mlp_max_bwd_pallas,
//   with fused_sa_bwd_finish_kernel, the port's own second launch that sums
//   its per-block dW / db rows in a fixed order and converts its
//   fixed-point da (the design note above fused_sa_bwd_kernel); B4's entry
//   point first launches da_scale_kernel, which writes that fixed point's
//   scale.
// All three live in this one source and run every pair's MLP through one
// function, pair_recompute, so the backward's recompute equals the
// forward bit for bit by construction; the library hash of ops/_cuda.py
// covers it.
//
// Semantics (as ops/fused_sa.py::_fused_sa_plain): layer 1 is split outside
// the kernel into a per-point term a_j = x_j W1x + f_j W1f + b1 and a
// per-centre term bc_p = -c_p W1x, both float32; per pair the kernel takes
// relu(a_j + bc_p) in float32, rounds it to the compute dtype, and runs the
// two tail layers with float32 accumulation, a float32 bias and ReLU (the
// middle activation rounded to the compute dtype again).  d^2 is the dx^2
// form with rounded products (-fmad=false), so it equals the culling
// pre-pass (csrc/min_d2.cu) bit for bit; the tail's dot products are
// explicit FMAs in a fixed order (pair_recompute).  Only the widths
// (32, 32, 64) are compiled: every shipped configuration.
//
// ---- B2 / B5, the forward ----------------------------------------------
//
// What bounds it on H100: bytes, ~0.008 ms at the serving shapes (32 clouds
// x 16384 points -> 1024 centres, at the card's HBM rate): the points,
// centres, centre terms, bitmap and output once, and the point-term rows
// of the points inside some ball.  Its operations, ~40k in-radius pairs of
// ~3k multiply-adds on the synthetic KITTI-like clouds (~1.2 points a 1 m
// ball), are microseconds of work.  What is left after culling is small
// and scattered, so the design fights latency: a block's chain of
// dependent global loads and barriers, and a lane that runs a pair's MLP
// alone while its block waits.  On dense balls (~190 points a 1 m ball)
// the MLP's issue rate and, were the weights read from shared memory, the
// shared-memory pipe bound it.
//
// Design: one block of four warps per (centre tile of 16, cloud), the
// culling bitmap's layout (B4 reads the same bitmap).
// * Kept chunks: the block reads its tile's bitmap bytes 128 chunks at a
//   time, one byte a thread, and compacts the kept chunks into a shared
//   list with warp ballots; no serial walk over the nc bytes.
// * Prefetch: each kept chunk's 128 points (2 KB) are copied into one of
//   two shared buffers with cp.async, one 16-byte point a thread, issued
//   before the chunk ahead of it is tested and waited for after.
// * Pair tests: thread i tests point i of the chunk against the tile's 16
//   centres (broadcast reads) and keeps a 16-bit hit mask.  Warp ballots
//   count the hits per (centre, warp), a 64-entry scan gives their offsets,
//   and the pairs are appended centre-major, each with its global point
//   index and d^2, to the block's pair list, which accumulates over chunks.
// * Rounds: when the list could not take another chunk's 2048 pairs, and
//   at the end, its pairs go in four contiguous runs, one a warp.  A warp
//   takes its pairs one at a time with lanes over units (pair_recompute):
//   lane c holds W2 column c and W3 columns c and c + 32 in registers and
//   reads the rounded layer inputs as float4 broadcasts from its warp's
//   rows, so no weight is read from shared memory and no lane runs a pair
//   alone.  Each warp loads its next pair's point term while it works on
//   the current one.
// Design studies (not kept): two or four pairs a warp, their chains
// interleaved, were faster on dense balls and slower on the serving shapes;
// a ring of three or four chunk buffers, and prefetching each listed pair's
// point-term row into L1, were no faster on the serving shapes.
// * Column max: a lane keeps its two columns' running max in registers
//   while consecutive pairs share a centre (the list is centre-major
//   within each chunk), and flushes it with one shared atomicMax a column
//   when the centre changes.  B2's word is the int bit pattern of a
//   non-negative float (ReLU makes every value >= 0, so int order is float
//   order), initialised to -1 for "no hit"; the rows are padded by one word.
//
// Argmax (ARGMAX = true): the word is 64-bit, (float bits << 32) | ~j for
// the flat point index j.  Tie rule: the largest value, and among equal
// values the LOWEST point index (~j is larger for a smaller j); the max of
// keys is order-free, so the runs, rounds and flushes cannot change the
// winner.  0 marks "no hit": every real key is > 0.  The TPU kernel breaks
// ties group-major (fused_sa_kernel.py:213-224, 464-465), so the two agree
// on the winner only where it is unique; both agree on every value.  An
// empty ball gives out = 0 and j = -1.
//
// Backward (equality-select): the same grid and bitmap, its own pair list
// (point-major, per chunk); each listed pair runs pair_recompute and
// selects the columns whose value equals the forward's out[p, c].  The
// section above fused_sa_bwd_kernel gives its design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;    // centres per block
constexpr int kChunk = 128;  // points per culling chunk
constexpr int kPairs = kTile * kChunk;
constexpr unsigned kFull = 0xffffffffu;

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

// Lane c's weights: W2 column c, W3 columns c and c + 32 (already rounded
// to the compute dtype, held in float32), in registers for the whole block.
struct LaneWeights {
  float w2c[32], w3lo[32], w3hi[32];

  __device__ __forceinline__ void load(const float* __restrict__ w2, const float* __restrict__ w3,
                                       int lane) {
#pragma unroll
    for (int k = 0; k < 32; ++k) w2c[k] = __ldg(w2 + k * 32 + lane);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      w3lo[k] = __ldg(w3 + k * 64 + lane);
      w3hi[k] = __ldg(w3 + k * 64 + lane + 32);
    }
  }
};

// One pair's MLP at widths (32, 32, 64), the whole warp together, lanes
// over units: lane c returns layer-1 unit c (h1), layer-2 unit c (h2) and
// layer-3 columns c and c + 32 (v_lo, v_hi), each float32 after its ReLU,
// not rounded.  A dot product runs k ascending from 0 with __fmaf_rn, then
// adds the bias, then takes ReLU; its input, the previous layer rounded to
// the compute dtype, is staged in the warp's rows h1row and h2row (32
// floats each, 16-byte aligned) and read back as float4 broadcasts.  The
// forward and the backward both call this, so they compute the same bits.
// A warp may reuse the same two rows for its next pair: the second
// __syncwarp here is passed only after every lane's layer-2 reads, and the
// next pair's first only after its layer-3 reads.
template <bool BF16>
__device__ __forceinline__ void pair_recompute(const LaneWeights& w, float a_c, float bc_c,
                                               const float* sb2, const float* sb3, float* h1row,
                                               float* h2row, float& h1, float& h2, float& v_lo,
                                               float& v_hi) {
  const int lane = threadIdx.x & 31;
  h1 = relu(a_c + bc_c);
  h1row[lane] = to_cd<BF16>(h1);
  __syncwarp();
  float acc2 = 0.0f;
#pragma unroll
  for (int k4 = 0; k4 < 8; ++k4) {
    const float4 hv = *reinterpret_cast<const float4*>(h1row + 4 * k4);
    acc2 = __fmaf_rn(hv.x, w.w2c[4 * k4 + 0], acc2);
    acc2 = __fmaf_rn(hv.y, w.w2c[4 * k4 + 1], acc2);
    acc2 = __fmaf_rn(hv.z, w.w2c[4 * k4 + 2], acc2);
    acc2 = __fmaf_rn(hv.w, w.w2c[4 * k4 + 3], acc2);
  }
  h2 = relu(acc2 + sb2[lane]);
  h2row[lane] = to_cd<BF16>(h2);
  __syncwarp();
  v_lo = 0.0f;
  v_hi = 0.0f;
#pragma unroll
  for (int k4 = 0; k4 < 8; ++k4) {
    const float4 hv = *reinterpret_cast<const float4*>(h2row + 4 * k4);
    v_lo = __fmaf_rn(hv.x, w.w3lo[4 * k4 + 0], v_lo);
    v_hi = __fmaf_rn(hv.x, w.w3hi[4 * k4 + 0], v_hi);
    v_lo = __fmaf_rn(hv.y, w.w3lo[4 * k4 + 1], v_lo);
    v_hi = __fmaf_rn(hv.y, w.w3hi[4 * k4 + 1], v_hi);
    v_lo = __fmaf_rn(hv.z, w.w3lo[4 * k4 + 2], v_lo);
    v_hi = __fmaf_rn(hv.z, w.w3hi[4 * k4 + 2], v_hi);
    v_lo = __fmaf_rn(hv.w, w.w3lo[4 * k4 + 3], v_lo);
    v_hi = __fmaf_rn(hv.w, w.w3hi[4 * k4 + 3], v_hi);
  }
  v_lo = relu(v_lo + sb3[lane]);
  v_hi = relu(v_hi + sb3[lane + 32]);
}

// ---- the block's shared staging, common to all three kernels -------------

template <int H1, int H2, int H3>
struct Staging {
  float b2[H2];
  float b3[H3];
  float r2[H3];
  float bc[kTile * (H1 + 1)];
  float4 cts[kTile];
};

template <int H1, int H2, int H3>
__device__ __forceinline__ void stage_block(Staging<H1, H2, H3>& s, const float* __restrict__ cts,
                                            const float* __restrict__ bc,
                                            const float* __restrict__ b2,
                                            const float* __restrict__ b3,
                                            const float* __restrict__ r2, int b, int p, int p0) {
  const int tid = threadIdx.x;
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

// ---- B2 / B5: forward, optionally with the winner index -------------------

constexpr int kListCap = 3072;               // pairs the block's list holds
constexpr int kRoundAt = kListCap - kPairs;  // a round runs once the list holds more

// cp.async of one 16-byte point into shared memory; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// this thread's point of chunk c into buf (zeros past the cloud)
__device__ __forceinline__ void prefetch_chunk(float4* buf, const float4* cloud, int c, int n) {
  const int j = c * kChunk + threadIdx.x;
  cp_async16(buf + threadIdx.x, cloud + (j < n ? j : 0), j < n ? 16 : 0);
}

// The column-max word: B2 the int bits of a value >= 0, B5 (bits << 32) | ~j
template <bool ARGMAX>
using MaxKey = std::conditional_t<ARGMAX, unsigned long long, int>;

template <bool ARGMAX>
__device__ __forceinline__ MaxKey<ARGMAX> no_hit() {
  return ARGMAX ? MaxKey<ARGMAX>(0) : MaxKey<ARGMAX>(-1);
}

template <bool ARGMAX>
__device__ __forceinline__ MaxKey<ARGMAX> max_key(float v, int j) {
  if constexpr (ARGMAX) {
    return ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)(~j);
  } else {
    return __float_as_int(v);
  }
}

template <bool ARGMAX>
__device__ __forceinline__ void flush_max(MaxKey<ARGMAX>* row, MaxKey<ARGMAX> lo, MaxKey<ARGMAX> hi) {
  const int lane = threadIdx.x & 31;
  if (lo != no_hit<ARGMAX>()) atomicMax(row + lane, lo);
  if (hi != no_hit<ARGMAX>()) atomicMax(row + lane + 32, hi);
}

// One round over the list's `total` pairs: four contiguous runs, one a
// warp, each pair's MLP with lanes over units, the column max in registers
// while the centre stays the same.
template <bool BF16, bool ARGMAX, int H1, int H2, int H3>
__device__ __forceinline__ void mlp_round(const Staging<H1, H2, H3>& s, const LaneWeights& lw,
                                          const int* slist, const float* sd2, int total,
                                          const float* __restrict__ arows, float* h1row,
                                          float* h2row, MaxKey<ARGMAX> (*smax)[H3 + 1]) {
  using Key = MaxKey<ARGMAX>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (total + kWarps - 1) / kWarps;
  const int e0 = warp * per, e1 = min(e0 + per, total);
  if (e0 >= e1) return;  // warp-uniform
  const float r2lo = s.r2[lane], r2hi = s.r2[lane + 32];
  int cur_t = slist[e0] & (kTile - 1);
  Key run_lo = no_hit<ARGMAX>(), run_hi = no_hit<ARGMAX>();
  float a_next = __ldg(arows + (size_t)(slist[e0] >> 4) * H1 + lane);
  for (int e = e0; e < e1; ++e) {
    const int q = slist[e], t = q & (kTile - 1), j = q >> 4;
    const float d2 = sd2[e];
    const float a_c = a_next;
    if (e + 1 < e1) a_next = __ldg(arows + (size_t)(slist[e + 1] >> 4) * H1 + lane);
    if (t != cur_t) {  // warp-uniform: the previous centre's run is complete
      flush_max<ARGMAX>(smax[cur_t], run_lo, run_hi);
      cur_t = t;
      run_lo = run_hi = no_hit<ARGMAX>();
    }
    float h1, h2, v_lo, v_hi;
    pair_recompute<BF16>(lw, a_c, s.bc[t * (H1 + 1) + lane], s.b2, s.b3, h1row, h2row, h1, h2, v_lo,
                         v_hi);
    if (d2 < r2lo) {
      const Key k = max_key<ARGMAX>(v_lo, j);
      run_lo = k > run_lo ? k : run_lo;
    }
    if (d2 < r2hi) {
      const Key k = max_key<ARGMAX>(v_hi, j);
      run_hi = k > run_hi ? k : run_hi;
    }
  }
  flush_max<ARGMAX>(smax[cur_t], run_lo, run_hi);
}

template <int H1, int H2, int H3, bool BF16, bool ARGMAX>
__global__ void __launch_bounds__(kThreads)
fused_sa_kernel(const float4* __restrict__ pts, const float* __restrict__ a,
                const float* __restrict__ cts, const float* __restrict__ bc,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                const float* __restrict__ r2, const uint8_t* __restrict__ active,
                float* __restrict__ out, int* __restrict__ jstar, int n, int p, float r2max) {
  static_assert(H1 == 32 && H2 == 32 && H3 == 64,
                "lane c owns layer-1/2 unit c and layer-3 columns c, c + 32");
  static_assert(kThreads == kChunk, "thread i tests point i of a chunk");
  using Key = MaxKey<ARGMAX>;

  __shared__ __align__(16) Staging<H1, H2, H3> s;
  __shared__ __align__(16) float4 spts[2][kChunk];     // the kept chunks' points, double-buffered
  __shared__ __align__(16) float srows[kWarps][2][H1];  // each warp's rounded h1 and h2 rows
  __shared__ Key smax[kTile][H3 + 1];
  __shared__ int slist[kListCap];  // (j << 4) | t: global point index, centre in the tile
  __shared__ float sd2[kListCap];
  __shared__ int skept[kThreads];                                // the window's kept chunks
  __shared__ int scnt[kTile * kWarps], soff[kTile * kWarps];     // per (centre, warp)
  __shared__ int swarp[kWarps];
  __shared__ int s_count;

  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int p0 = tile * kTile;
  const int nc = (n + kChunk - 1) / kChunk;
  const float4* cloud = pts + (size_t)b * n;
  const float* arows = a + (size_t)b * n * H1;
  float* h1row = srows[warp][0];
  float* h2row = srows[warp][1];

  stage_block(s, cts, bc, b2, b3, r2, b, p, p0);
  for (int i = tid; i < kTile * (H3 + 1); i += kThreads) (&smax[0][0])[i] = no_hit<ARGMAX>();
  if (tid == 0) s_count = 0;
  LaneWeights lw;
  lw.load(w2, w3, lane);

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c0 = 0; c0 < nc; c0 += kThreads) {
    // the window's kept chunks, in order: one bitmap byte a thread, ballots
    const int cw = c0 + tid;
    const bool keep = cw < nc && act[(size_t)cw * ntiles] != 0;
    const unsigned kb = __ballot_sync(kFull, keep);
    if (lane == 0) swarp[warp] = __popc(kb);
    __syncthreads();  // (first window: the staging too)
    int nk = 0, before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? swarp[w] : 0;
      nk += swarp[w];
    }
    if (keep) skept[before + __popc(kb & below)] = cw;
    __syncthreads();
    if (nk == 0) continue;  // block-uniform

    prefetch_chunk(spts[0], cloud, skept[0], n);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      // into the buffer chunk kk - 1 used: every thread read it before
      // that chunk's first barrier
      if (kk + 1 < nk) prefetch_chunk(spts[(kk + 1) & 1], cloud, skept[kk + 1], n);
      cp_async_commit();

      // this thread's point against the tile's centres
      const int j = skept[kk] * kChunk + tid;
      const float4 pt = spts[kk & 1][tid];
      unsigned hits = 0;
      if (j < n && pt.w == 0.0f) {  // w = BIG*invalid; past the cloud the slot is zeros
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const float4 ct = s.cts[t];
          if (ct.w == 0.0f && sq_dist(pt, ct) < r2max) hits |= 1u << t;
        }
      }
      // hits per (centre, warp), then a centre-major scan gives the offsets
      const bool any = __any_sync(kFull, hits != 0);
      int mine = 0;
      if (any) {
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const unsigned bt = __ballot_sync(kFull, (hits >> t) & 1u);
          if (lane == t) mine = __popc(bt);
        }
      }
      if (lane < kTile) scnt[lane * kWarps + warp] = mine;
      __syncthreads();
      if (warp == 0) {
        const int v0 = scnt[2 * lane], v1 = scnt[2 * lane + 1];
        int incl = v0 + v1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        const int base = s_count;
        __syncwarp();
        soff[2 * lane] = base + incl - v0 - v1;
        soff[2 * lane + 1] = base + incl - v1;
        if (lane == 31) s_count = base + incl;
      }
      cp_async_wait_all();  // chunk kk + 1 has landed
      __syncthreads();      // the offsets and chunk kk + 1's points are visible
      if (any) {
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const unsigned bt = __ballot_sync(kFull, (hits >> t) & 1u);
          if ((hits >> t) & 1u) {
            const int pos = soff[t * kWarps + warp] + __popc(bt & below);
            slist[pos] = (j << 4) | t;
            sd2[pos] = sq_dist(pt, s.cts[t]);
          }
        }
      }
      const int total = s_count;
      if (total > kRoundAt) {  // block-uniform: the next chunk might not fit
        __syncthreads();       // the list is complete
        mlp_round<BF16, ARGMAX>(s, lw, slist, sd2, total, arows, h1row, h2row, smax);
        __syncthreads();       // every run has read the list
        if (tid == 0) s_count = 0;
      }
    }
  }
  __syncthreads();
  const int total = s_count;
  if (total > 0) mlp_round<BF16, ARGMAX>(s, lw, slist, sd2, total, arows, h1row, h2row, smax);
  __syncthreads();

  for (int i = tid; i < kTile * H3; i += kThreads) {
    const int t = i / H3, col = i % H3, q = p0 + t;
    if (q < p) {
      const Key v = smax[t][col];
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
// the pair tests and of each pair's chain of dependent multiply-adds.  The
// first design carried each pair on one lane of warp 0 through every step
// in sequence (~5,000 dependent FMAs and shared loads) while the other
// three warps waited: 0.559 ms at 10 x 16384 -> 1024 (NVIDIA H100 80GB
// HBM3, 700 W), 56x its bound, and slower as balls fill.
//
// Design: the same grid (one block of 4 warps per 16-centre tile) and
// culling bitmap as B2, and its own per-chunk pair list (list_pairs,
// point-major).  The pairs go in rounds of up to 32, split into four
// contiguous runs, one a warp, and a warp takes its pairs one at a time
// with its lanes over units:
//   * pair_recompute gives lane c layer-1 unit c, layer-2 unit c and
//     layer-3 columns c and c + 32, exactly as the forward computed them, so
//     the equality test selects the forward's winners; the rounded layer
//     inputs it stages are the round's h1 and h2 rows;
//   * dh2 = W3 d3 and dh1 = W2 d2 take lanes over the input unit, summing
//     only the selected columns (warp ballots) of the staged rounded delta
//     row, against copies of W3 and W2 in shared memory with rows padded
//     by one word, so lanes over input units read them conflict-free;
//   * no global load waits on the chain: the tile's out and g rows are
//     staged in shared memory once, and each warp loads its next pair's
//     point term a_j while it works on the current pair;
//   * da is summed in registers over consecutive pairs of one point (the
//     list holds a point's centres together); dbc goes to the warp's own
//     shared row, db to per-lane registers.
// After each round the block reduces dW3 += h2^T d3 and dW2 += h1^T d2 over
// the round's staged rows.  In the bf16 instantiation the staged operands
// are exact bf16 values, so the sums are mma.sync.m16n8k16 bf16 -> f32
// products on the tensor cores (24 tiles of 16 x 8, six a warp, two k-steps
// a round), the product the TPU kernel takes with its matmul.  The float32
// instantiation sums on the CUDA cores, each thread the entries it owns
// (TF32 would round the inputs).
//
// Determinism: two launches on the same operands give the same bits in
// every output, as the TPU kernel does (its grid runs in order and it sums
// its centre splits in a fixed order).  No float sum depends on which
// block or warp finishes first:
//   * the pair list is built as B2 builds its own: per (pass, warp) hit
//     counts, a scan in that order, ballot ranks.  It holds a chunk's pairs
//     in ascending q = t + 16 i (point-major), a function of the inputs
//     alone, and rounds and warp runs cut it by position;
//   * dbc and db: one shared row a warp, summed in warp order at the end;
//   * dW and db across blocks: each block stores all its partial sums
//     (kPartWidth = 3168 floats) in its own row of a workspace (B x tiles
//     rows: 8.1 MB at 10 clouds x 1024 centres), and a second launch,
//     fused_sa_bwd_finish, sums the rows in block order: thread (segment s,
//     column) takes rows s, s + 8, s + 16, ... in order, then the eight
//     segment sums add in order;
//   * da, which every tile whose balls hold a point adds into: int64
//     fixed-point atomics, order-free because integer addition is
//     associative.  The values are integer multiples of 2^-S, S = 62 - e,
//     where 2^e exceeds 1.01 P G and G = max row sum |W2| x max row sum |W3|
//     x max finite |g|, a float64 product, so it cannot overflow and S may
//     be negative (da_scale_kernel, launched first by the same entry point,
//     writes S).  No pair adds more than G to a point's entry and a point
//     has at most P pairs, so no sum leaves int64.  Each warp run's float sum is rounded to that
//     grid once: against the exact sum of those float runs the error is at
//     most P 2^-(S+1) <= 1.01 P^2 G 2^-62, about 2.3e-13 G at P = 1024, far
//     below float32 rounding.  fused_sa_bwd_finish converts the integers to
//     float32 (one rounding).  The alternative, (point, tile) partial rows
//     summed in tile order, needs a workspace that grows with the visited
//     blocks (1.3 GB on the dense case at 10 x 16384), where the int64 sums
//     take twice da's bytes.
//   * non-finite cotangents: a warp run's da sum that is NaN or inf never
//     reaches the integer (a NaN would convert to a fixed integer and
//     saturate the sum); it sets the (point, lane) bit of a flag word, one
//     uint32 a point (H1 = 32), by atomicOr, which is order-free too, and
//     fused_sa_bwd_finish writes NaN there.  So da is non-finite exactly
//     where a selected pair's float chain is, as in the twin, and relu' is
//     a select on both sides (a product would spread a NaN to inactive
//     units).  A non-finite weight makes the bound itself non-finite: then
//     all of da is NaN.
//
// Measured before this design (back-to-back launches between two CUDA
// events, NVIDIA H100 80GB HBM3, 700 W), bf16 at 10 clouds x 16384 ->
// 1024: 0.19 ms on the synthetic clouds (~1.2 points a 1 m ball), 2.1 ms
// on a dense cube (~190 points a 1 m ball), with float atomics for da, dW
// and db.

constexpr int kRound = 32;                  // pairs staged per round
constexpr int kPasses = kPairs / kThreads;  // list_pairs' passes over a chunk's (point, centre) slots

// A block's row of the dW / db workspace: dW3 (H2 x H3), dW2 (H1 x H2),
// db3 (H3), db2 (H2) at the compiled widths (32, 32, 64).
constexpr int kPartDw3 = 0;
constexpr int kPartDw2 = kPartDw3 + 32 * 64;
constexpr int kPartDb3 = kPartDw2 + 32 * 32;
constexpr int kPartDb2 = kPartDb3 + 64;
constexpr int kPartWidth = kPartDb2 + 32;

// Stage chunk c's points and list its in-radius pairs q = t + i * kTile in
// ascending q (point-major) into `list`; returns the pair count.  Pass k
// tests q = k * kThreads + tid; lane k keeps pass k's ballot, the (pass,
// warp) counts are scanned in that order, and each hit's slot is its
// scanned offset plus its rank in the ballot, so the order depends on the
// inputs alone.  Call with every thread of the block.
template <int H1, int H2, int H3>
__device__ __forceinline__ int list_pairs(const Staging<H1, H2, H3>& s, float4* spts,
                                          unsigned short* list, int* cnt, int* off, int* count,
                                          const float4* __restrict__ pts, int b, int n, int j0,
                                          float r2max) {
  static_assert(kPasses <= 32 && kPasses * kWarps == 64,
                "lane k keeps pass k's ballot; the scan takes two counts a lane");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the previous chunk's pairs are consumed
  const int npts = min(kChunk, n - j0);
  for (int i = tid; i < kChunk; i += kThreads) {
    // w = BIG*invalid for real points; 1 marks a slot past the cloud
    spts[i] = i < npts ? pts[(size_t)b * n + j0 + i] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  }
  __syncthreads();

  unsigned mine = 0u;
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const int q = k * kThreads + tid;
    const float4 ct = s.cts[q % kTile], pt = spts[q / kTile];
    const bool hit = pt.w == 0.0f && ct.w == 0.0f && sq_dist(pt, ct) < r2max;
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == k) mine = ballot;
  }
  if (lane < kPasses) cnt[lane * kWarps + warp] = __popc(mine);
  __syncthreads();
  if (warp == 0) {  // exclusive offsets in (pass, warp) order, i.e. ascending q
    const int v0 = cnt[2 * lane], v1 = cnt[2 * lane + 1];
    int incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    off[2 * lane] = incl - v0 - v1;
    off[2 * lane + 1] = incl - v1;
    if (lane == 31) *count = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    const unsigned bt = __shfl_sync(kFull, mine, k);
    if ((bt >> lane) & 1u) {
      list[off[k * kWarps + warp] + __popc(bt & below)] = (unsigned short)(k * kThreads + tid);
    }
  }
  __syncthreads();
  return *count;
}

// da += x in fixed point: x * 2^S rounded to an integer (scale = 2^S); a
// non-finite x sets the lane's bit of the point's flag word instead
__device__ __forceinline__ void add_fixed(unsigned long long* dst, unsigned* flags, int lane, float x,
                                          double scale) {
  if (!isfinite(x)) {
    atomicOr(flags, 1u << lane);
  } else if (x != 0.0f) {
    atomicAdd(dst, (unsigned long long)__double2ll_rn((double)x * scale));
  }
}

// B4's fixed-point state (int32 words, zeroed by the caller): S, the flags
// below, max finite |g| as float bits, the scale blocks' ticket, then one
// flag word a point of da (bit k: lane k's sum was not finite).
constexpr int kStateWords = 4;
constexpr int kFlagG = 1;      // g holds a NaN or an inf
constexpr int kFlagBound = 2;  // the bound is not finite (a weight is not): all of da is NaN
constexpr int kScaleThreads = 256;
constexpr int kScaleBlocks = 264;  // two a SM at most

// S of the fixed-point da: blocks reduce max finite |g| (as unsigned bits,
// which order non-negative floats) and a non-finite flag with atomics,
// order-free; the last block to take a ticket computes the bound 1.01 P x
// max row sum |W2| x max row sum |W3| x max finite |g| in float64 (rows
// summed in column order) and S = 62 - e with 2^e > bound (62 for a zero
// bound).  Bound: bytes (g read once), so g is read as float4 with several
// loads in flight a thread, and the last block stages W2 and W3 in shared
// memory in one round of loads before its 64 threads sum the rows, which
// keeps dependent global loads off its tail.  ops/fused_sa.py::da_scale is
// its twin.
__global__ void __launch_bounds__(kScaleThreads)
da_scale_kernel(const float* __restrict__ g, long long n_g, const float* __restrict__ w2,
                const float* __restrict__ w3, int p, int* __restrict__ state) {
  __shared__ unsigned s_max[kScaleThreads / 32];
  __shared__ int s_nonfinite[kScaleThreads / 32];
  __shared__ double s_rows[64];
  __shared__ float s_w[32 * 32 + 32 * 64];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned mx = 0u;
  int nonfinite = 0;
  auto take = [&](float x) {
    const float v = fabsf(x);
    if (isfinite(v)) {
      mx = max(mx, __float_as_uint(v));
    } else {
      nonfinite = 1;
    }
  };
  // float4 loads, several in flight a thread; the order of a max is free
  const long long n4 = (reinterpret_cast<uintptr_t>(g) & 15) == 0 ? n_g / 4 : 0;
  const long long stride = (long long)gridDim.x * kScaleThreads;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * kScaleThreads + threadIdx.x; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(g)[i];
    take(v.x);
    take(v.y);
    take(v.z);
    take(v.w);
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * kScaleThreads + threadIdx.x; i < n_g; i += stride)
    take(g[i]);
  mx = __reduce_max_sync(kFull, mx);
  nonfinite = __reduce_or_sync(kFull, nonfinite);
  if (lane == 0) {
    s_max[warp] = mx;
    s_nonfinite[warp] = nonfinite;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kScaleThreads / 32; ++w) {
      mx = max(mx, s_max[w]);
      nonfinite |= s_nonfinite[w];
    }
    atomicMax(reinterpret_cast<unsigned*>(state + 2), mx);
    if (nonfinite) atomicOr(state + 1, kFlagG);
    __threadfence();
    s_last = atomicAdd(state + 3, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // W2 (32 x 32) and W3 (32 x 64) staged by the whole block in one round of
  // loads, then each row summed in column order by its own thread
  for (int i = threadIdx.x; i < 32 * 32 + 32 * 64; i += kScaleThreads) s_w[i] = i < 32 * 32 ? w2[i] : w3[i - 32 * 32];
  __syncthreads();
  if (threadIdx.x < 64) {
    const int r = threadIdx.x & 31, width = threadIdx.x < 32 ? 32 : 64;
    const float* row = threadIdx.x < 32 ? s_w + r * 32 : s_w + 32 * 32 + r * 64;
    double acc = 0.0;
    for (int c = 0; c < width; ++c) acc += fabs((double)row[c]);
    s_rows[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double r2 = 0.0, r3 = 0.0;
    for (int r = 0; r < 32; ++r) {
      r2 = fmax(r2, s_rows[r]);
      r3 = fmax(r3, s_rows[32 + r]);
    }
    // NaN row sums: fmax drops them, so test the rows themselves
    bool finite = true;
    for (int r = 0; r < 64; ++r) finite = finite && isfinite(s_rows[r]);
    const double gmax = (double)__uint_as_float(atomicOr(reinterpret_cast<unsigned*>(state + 2), 0u));
    const double bound = r2 * r3 * gmax * (1.01 * p);
    int sc = 62;
    if (!finite || !isfinite(bound)) {
      sc = 0;
      atomicOr(state + 1, kFlagBound);
    } else if (bound > 0.0) {
      int e;
      frexp(bound, &e);
      sc = 62 - e;
    }
    state[0] = sc;
  }
}

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

  // every entry, into the block's workspace row
  __device__ void store(float* dw2, float* dw3) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < kOwn3; ++r) dw3[tid + r * kThreads] = acc3[r];
#pragma unroll
    for (int r = 0; r < kOwn2; ++r) dw2[tid + r * kThreads] = acc2[r];
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

  // every entry, into the block's workspace row: each (row, column) of
  // dW3 and dW2 belongs to one fragment register of one lane
  __device__ void store(float* dw2, float* dw3) const {
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
        dw[row * ncols + col] = acc[i][e];
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
                    int* __restrict__ da_state, unsigned long long* __restrict__ da_fx,
                    float* __restrict__ dbc, float* __restrict__ part, int n, int p, float r2max) {
  static_assert(H1 == 32 && H2 == 32 && H3 == 64,
                "lane c owns layer-1/2 unit c and layer-3 columns c, c + 32");
  using Rows = RoundRows<H1, H2, H3>;

  __shared__ __align__(16) Staging<H1, H2, H3> s;
  __shared__ __align__(16) float4 spts[kChunk];
  __shared__ unsigned short slist[kPairs];
  __shared__ int scnt[kPasses * kWarps], soff[kPasses * kWarps];
  __shared__ int s_count;
  __shared__ float sdbc[kWarps][kTile * (H1 + 1)];  // each warp's dbc sums
  // the weights with rows padded by one word, for the back-propagation:
  // lanes over input units read them conflict-free
  __shared__ float w2p[H1][H2 + 1];
  __shared__ float w3p[H2][H3 + 1];
  __shared__ float sdb[kWarps][H3 + H2];  // each warp's db3 then db2
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Rows& rows = *reinterpret_cast<Rows*>(dyn_smem);
  TileRows<H3>& tr = *reinterpret_cast<TileRows<H3>*>(dyn_smem + sizeof(Rows));

  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tile * kTile;
  const int nc = (n + kChunk - 1) / kChunk;

  stage_block(s, cts, bc, b2, b3, r2, b, p, p0);
  for (int i = tid; i < H1 * H2; i += kThreads) w2p[i / H2][i % H2] = w2[i];
  for (int i = tid; i < H2 * H3; i += kThreads) w3p[i / H3][i % H3] = w3[i];
  for (int i = tid; i < kTile * H3; i += kThreads) {
    const int t = i / H3, q = p0 + t;
    const size_t o = ((size_t)b * p + q) * H3 + i % H3;
    tr.out[t][i % H3] = q < p ? out[o] : 0.0f;
    tr.g[t][i % H3] = q < p ? g[o] : 0.0f;
  }
  for (int i = tid; i < kWarps * kTile * (H1 + 1); i += kThreads) (&sdbc[0][0])[i] = 0.0f;
  float* wdbc = sdbc[warp];
  const double da_scale = ldexp(1.0, da_state[0]);
  unsigned* da_flags = reinterpret_cast<unsigned*>(da_state) + kStateWords + (size_t)b * n;
  LaneWeights lw;  // this lane's recompute weights
  lw.load(w2, w3, lane);
  DwSums<H1, H2, H3, BF16> dw;
  float db3_lo = 0.0f, db3_hi = 0.0f, db2_c = 0.0f;  // columns lane, lane + 32; unit lane

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c = 0; c < nc; ++c) {
    if (!act[(size_t)c * ntiles]) continue;
    const int j0 = c * kChunk;
    const int total = list_pairs(s, spts, slist, scnt, soff, &s_count, pts, b, n, j0, r2max);

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
        const float d2 = sq_dist(spts[i], s.cts[t]);  // the forward's bits

        // the forward's activations, the rounded inputs staged as the round's rows
        float h1, h2, v_lo, v_hi;
        pair_recompute<BF16>(lw, a_j, s.bc[t * (H1 + 1) + lane], s.b2, s.b3, rows.h1[r], rows.h2[r],
                             h1, h2, v_lo, v_hi);

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
          if (cur_j >= 0) {
            add_fixed(da_fx + ((size_t)b * n + cur_j) * H1 + lane, da_flags + cur_j, lane, da_sum, da_scale);
          }
          cur_j = j;
          da_sum = 0.0f;
        }
        da_sum += d0;
        wdbc[t * (H1 + 1) + lane] += d0;
      }
      if (cur_j >= 0) {
        add_fixed(da_fx + ((size_t)b * n + cur_j) * H1 + lane, da_flags + cur_j, lane, da_sum, da_scale);
      }
      __syncthreads();
      dw.add(rows, live);
      __syncthreads();  // the next round overwrites the staged rows
    }
  }

  sdb[warp][lane] = db3_lo;
  sdb[warp][lane + 32] = db3_hi;
  sdb[warp][H3 + lane] = db2_c;
  __syncthreads();

  // the warps' rows, summed in warp order
  for (int i = tid; i < kTile * H1; i += kThreads) {
    const int t = i / H1, k = i % H1, q = p0 + t;
    float v = sdbc[0][t * (H1 + 1) + k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += sdbc[w][t * (H1 + 1) + k];
    if (q < p) dbc[((size_t)b * p + q) * H1 + k] = v;
  }
  float* row = part + ((size_t)b * ntiles + tile) * kPartWidth;
  dw.store(row + kPartDw2, row + kPartDw3);
  if (tid < H3 + H2) {
    float v = sdb[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += sdb[w][tid];
    row[kPartDb3 + tid] = v;  // db3 then db2, as in sdb
  }
}

// B4's second launch: dW and db summed over the workspace rows in block
// order, and da converted from fixed point to float32 (NaN where a flag
// bit is set, everywhere under kFlagBound).  Blocks below
// kFinishColBlocks take 32 workspace columns each: thread (segment s, lane)
// sums rows s, s + 8, s + 16, ... of its column in order, then segment 0
// adds the eight segment sums in order.  The blocks above convert da,
// grid-stride.  Bound: bytes (the workspace and the int64 da read once,
// the float32 outputs written once).
constexpr int kFinishThreads = 256;
constexpr int kFinishSegs = kFinishThreads / 32;
constexpr int kFinishColBlocks = kPartWidth / 32;
static_assert(kPartWidth % 32 == 0, "whole warps of workspace columns");

__global__ void __launch_bounds__(kFinishThreads)
fused_sa_bwd_finish_kernel(const float* __restrict__ part, int nrows,
                           const unsigned long long* __restrict__ da_fx,
                           const int* __restrict__ da_state, long long n_da, float* __restrict__ da,
                           float* __restrict__ dw2, float* __restrict__ db2,
                           float* __restrict__ dw3, float* __restrict__ db3) {
  if (blockIdx.x < kFinishColBlocks) {
    __shared__ float seg[kFinishSegs][32];
    const int lane = threadIdx.x & 31, sg = threadIdx.x >> 5;
    const int col = blockIdx.x * 32 + lane;
    float acc = 0.0f;
    for (int r = sg; r < nrows; r += kFinishSegs) acc += part[(size_t)r * kPartWidth + col];
    seg[sg][lane] = acc;
    __syncthreads();
    if (sg == 0) {
      float v = seg[0][lane];
#pragma unroll
      for (int k = 1; k < kFinishSegs; ++k) v += seg[k][lane];
      if (col < kPartDw2) {
        dw3[col - kPartDw3] = v;
      } else if (col < kPartDb3) {
        dw2[col - kPartDw2] = v;
      } else if (col < kPartDb2) {
        db3[col - kPartDb3] = v;
      } else {
        db2[col - kPartDb2] = v;
      }
    }
    return;
  }
  const int ex = da_state[0];
  const bool all_nan = (da_state[1] & kFlagBound) != 0;
  const unsigned* flags = reinterpret_cast<const unsigned*>(da_state) + kStateWords;
  const long long stride = (long long)(gridDim.x - kFinishColBlocks) * kFinishThreads;
  for (long long i = (long long)(blockIdx.x - kFinishColBlocks) * kFinishThreads + threadIdx.x; i < n_da;
       i += stride) {
    const bool bad = all_nan || ((flags[i >> 5] >> (i & 31)) & 1u);
    da[i] = bad ? __int_as_float(0x7fc00000) : ldexpf(__ll2float_rn((long long)da_fx[i]), -ex);
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

// n < 2^27: the forward's pair list packs (j << 4) | t into an int
bool valid_shape(int b, int n, int p, int chunk, int tile) {
  return b > 0 && n > 0 && n < (1 << 27) && p > 0 && chunk == kChunk && tile == kTile && b <= 65535;
}

bool compiled_widths(int h1, int h2, int h3) { return h1 == 32 && h2 == 32 && h3 == 64; }

// B4 at the compiled widths: its round and tile rows live in dynamic shared
// memory (static and dynamic together exceed the 48 KB a launch gets by
// default).
template <bool BF16>
cudaError_t launch_bwd(const float4* pts, const float* a, const float* cts, const float* bc,
                       const float* w2, const float* b2, const float* w3, const float* b3,
                       const float* r2, const uint8_t* active, const float* out, const float* g,
                       int* da_state, unsigned long long* da_fx, float* dbc, float* part, int b,
                       int n, int p, float r2max, cudaStream_t stream) {
  const auto kernel = fused_sa_bwd_kernel<32, 32, 64, BF16>;
  const int smem = (int)(sizeof(RoundRows<32, 32, 64>) + sizeof(TileRows<64>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_g = (long long)b * p * 64;
  const long long want = (n_g + 8 * kScaleThreads - 1) / (8 * kScaleThreads);
  da_scale_kernel<<<(int)(want < kScaleBlocks ? want : kScaleBlocks), kScaleThreads, 0, stream>>>(
      g, n_g, w2, w3, p, da_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kTile - 1) / kTile, b);
  kernel<<<grid, kThreads, smem, stream>>>(pts, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da_state,
                                           da_fx, dbc, part, n, p, r2max);
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

// The forward's operands, plus out (B, P, H3) (the forward's own output),
// g (B, P, H3) its cotangent and da_state (int32, kStateWords + B * N,
// zeroed by the caller).  Launches da_scale_kernel, which writes S and the
// flags into da_state, then the backward, which writes dbc (B, P, H1) and
// part (B * ceil(P/tile), kPartWidth): each block's dW3, dW2, db3 and db2
// sums; adds da * 2^S into da_fx (B, N, H1) int64, which the caller
// zeroes, and sets da_state's per-point flag bits for non-finite sums.
extern "C" int deepclr_fused_sa_bwd(const float* pts, const float* a, const float* cts,
                                    const float* bc, const float* w2, const float* b2,
                                    const float* w3, const float* b3, const float* r2,
                                    const uint8_t* active, const float* out, const float* g,
                                    int* da_state, unsigned long long* da_fx, float* dbc,
                                    float* part, int b, int n, int p, int h1, int h2, int h3,
                                    int chunk, int tile, float r2max, int bf16,
                                    cudaStream_t stream) {
  if (!valid_shape(b, n, p, chunk, tile) || !compiled_widths(h1, h2, h3)) {
    return (int)cudaErrorInvalidValue;
  }
  const float4* pts4 = reinterpret_cast<const float4*>(pts);
  if (bf16 != 0) {
    return (int)launch_bwd<true>(pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da_state, da_fx,
                                 dbc, part, b, n, p, r2max, stream);
  }
  return (int)launch_bwd<false>(pts4, a, cts, bc, w2, b2, w3, b3, r2, active, out, g, da_state, da_fx,
                                dbc, part, b, n, p, r2max, stream);
}

// B4's second launch: part (nrows, kPartWidth) summed over its rows in order
// into dw2 (32, 32), db2 (32), dw3 (32, 64), db3 (64); da_fx (n_da int64,
// H1 = 32 a point) times 2^-S into da (n_da float32), S and the flags from
// da_state (as deepclr_fused_sa_bwd left it).
extern "C" int deepclr_fused_sa_bwd_finish(const float* part, int nrows,
                                           const unsigned long long* da_fx, const int* da_state,
                                           long long n_da, float* da, float* dw2, float* db2,
                                           float* dw3, float* db3, cudaStream_t stream) {
  if (nrows <= 0 || n_da < 0 || n_da % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long da_blocks = (n_da + kFinishThreads - 1) / kFinishThreads;
  const int grid = kFinishColBlocks + (int)(da_blocks < 4096 ? (da_blocks > 0 ? da_blocks : 1) : 4096);
  fused_sa_bwd_finish_kernel<<<grid, kFinishThreads, 0, stream>>>(part, nrows, da_fx, da_state, n_da, da,
                                                                  dw2, db2, dw3, db3);
  return (int)cudaGetLastError();
}
