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
// x 16384 points -> 1024 centres; chip_smoke.py's bound): the points,
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
// clouds (~1.2 points a 1 m ball), 2.1 ms on a dense cube (~190 points a
// 1 m ball).

constexpr int kRound = 32;  // pairs staged per round

// Stage chunk c's points and compact its in-radius pairs (q = t + i * kTile,
// point-major) into `list`; returns the pair count.  Call with every thread
// of the block.
template <int H1, int H2, int H3>
__device__ __forceinline__ int list_pairs(const Staging<H1, H2, H3>& s, float4* spts,
                                          unsigned short* list, int* count,
                                          const float4* __restrict__ pts, int b, int n, int j0,
                                          float r2max) {
  const int tid = threadIdx.x, lane = tid & 31;
  __syncthreads();  // the previous chunk's pairs are consumed
  const int cnt = min(kChunk, n - j0);
  for (int i = tid; i < kChunk; i += kThreads) {
    // w = BIG*invalid for real points; 1 marks a slot past the cloud
    spts[i] = i < cnt ? pts[(size_t)b * n + j0 + i] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  }
  if (tid == 0) *count = 0;
  __syncthreads();

  for (int base = 0; base < kPairs; base += kThreads) {
    const int q = base + tid;
    const float4 ct = s.cts[q % kTile], pt = spts[q / kTile];
    const float d2 = sq_dist(pt, ct);
    const bool hit = pt.w == 0.0f && ct.w == 0.0f && d2 < r2max;
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (ballot) {
      const int leader = __ffs(ballot) - 1;
      int pos = 0;
      if (lane == leader) pos = atomicAdd(count, __popc(ballot));
      pos = __shfl_sync(kFull, pos, leader);
      if (hit) {
        pos += __popc(ballot & ((1u << lane) - 1u));
        list[pos] = (unsigned short)q;
      }
    }
  }
  __syncthreads();
  return *count;
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
  __shared__ __align__(16) float4 spts[kChunk];
  __shared__ unsigned short slist[kPairs];
  __shared__ int s_count;
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

  stage_block(s, cts, bc, b2, b3, r2, b, p, p0);
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
  LaneWeights lw;  // this lane's recompute weights
  lw.load(w2, w3, lane);
  DwSums<H1, H2, H3, BF16> dw;
  float db3_lo = 0.0f, db3_hi = 0.0f, db2_c = 0.0f;  // columns lane, lane + 32; unit lane

  const uint8_t* act = active + (size_t)b * nc * ntiles + tile;
  for (int c = 0; c < nc; ++c) {
    if (!act[(size_t)c * ntiles]) continue;
    const int j0 = c * kChunk;
    const int total = list_pairs(s, spts, slist, &s_count, pts, b, n, j0, r2max);

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
