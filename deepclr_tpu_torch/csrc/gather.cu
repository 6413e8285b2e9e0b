// The backward of the row gather out[b, m] = src[b, idx[b, m]]
// (ops/grouping.py::gather_points, and so group_points), with a sum order
// that is a function of the inputs alone:
//
//   dsrc[b, j, c] = sum over m with idx[b, m] = j, m ascending, of g[b, m, c]
//
// float32, sequential from 0.0f, no FMA (nothing here multiplies): equal
// bit for bit to the CPU's scatter_add_, the wrapper's twin.
//
// What it replaces: XLA's transpose of the gather in
// deepclr_tpu/ops/grouping.py:45 (the JAX package gathers with XLA and
// leaves the backward to it).  On the card torch.gather's backward is a
// scatter_add_ whose float atomics add in a varying order, so the port has
// its own.  B5's backward scatter (ops/fused_sa.py::_winner_grads) is the
// same sum.
//
// What bounds it on H100: bytes.  g is read once (every row of g belongs to
// one run), the index once, dsrc written once.  At MotionEmbedding's train
// shape (5 x 20480 rows of 128 into 1024) that is ~56 MB, 0.0167 ms at
// 3.35 TB/s.  What the design does about it, in two launches and no sort:
//
// 1. gather_bwd_index_kernel builds a run index with work linear in M + N.
//    The M indices of a cloud are cut into segments of lseg consecutive m
//    (ops/grouping.py::segment_length: 128 at N = 1024), one warp a
//    segment.  The warp counts its keys in shared memory, walking the
//    segment 32 m at a time in m order: __match_any_sync gives each m its
//    rank among the equal keys of its chunk, the count so far the rank
//    among the chunks before, so ranks are stable.  An exclusive scan of
//    the counts gives the segment's local CSR: perm[s lseg + off[s][k] +
//    rank] = m, and offsets[s][k] for k in 0..N.  Integer counts and fixed
//    walks: the index is the same on every run.  An index outside [0, N)
//    goes into bucket N, after every row, and is never summed.
// 2. gather_bwd_sum_kernel: one warp a source row j.  Lane t reads segment
//    t's sub-run [off[t][j], off[t][j + 1]) (32 segments at a time); a warp
//    scan of their lengths concatenates them, segment by segment, which is
//    ascending m.  Each lane fetches one entry's m (a binary search of the
//    scan by shuffles; the next 32 entries' m are fetched while the current
//    32 are added), and the m are broadcast by __shfl_sync.  The rows of g
//    go through a stage in shared memory with cp.async, 16 rows of 512
//    bytes at C = 128 all in flight at once, without registers to hold
//    them; then each lane adds its channels in m order.  At C % 4 == 0 a
//    lane holds 4 channels as a float4 (one coalesced 512-byte read a row
//    at C = 128), other widths one float.  When a row has fewer than 32
//    slots (C = 32: 8 float4) the lanes split into groups that copy
//    several rows a step, 32 rows a stage; every group adds all of them.
//    Rows no index names are written as zeros.  Why 16 rows: a real kNN
//    index has long runs (140 on a ray-cast batch), each one warp's chain
//    of stages; an 8-row stage or 8 loads in registers keep more warps
//    resident and sum a uniform index ~20% faster, but a ray-cast one ~30%
//    slower (H100 measurements, PERF.md).
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;      // a block's shared memory on H100 (227 KB)
constexpr int kIndexSmemTarget = 65536;  // shared memory a block of the index launch aims at
constexpr int kIndexMaxWarps = 4;
constexpr int kSumThreads = 128;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kStageCells = 16 * 32;  // a warp's stage: 16 rows of 32 float4 (8 KB), or more narrower rows

// A warp's shared arrays in the index launch: key[lseg] int32, rank[lseg]
// and cnt[n + 1] uint16 (counts and offsets never exceed lseg <= 16384).
__host__ __device__ inline int index_smem_per_warp(int n, int lseg) {
  return ((6 * lseg + 2 * (n + 1)) + 15) & ~15;
}

__global__ void gather_bwd_index_kernel(const int64_t* __restrict__ idx, int* __restrict__ perm,
                                        uint16_t* __restrict__ offsets, int m, int n, int lseg, int segs,
                                        int warps, int smem_per_warp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * warps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (s >= segs) return;  // warp-uniform; the warps of a block share nothing
  int* key = reinterpret_cast<int*>(smem + (size_t)(threadIdx.x >> 5) * smem_per_warp);
  uint16_t* rank = reinterpret_cast<uint16_t*>(key + lseg);
  uint16_t* cnt = rank + lseg;
  const int m0 = s * lseg;
  const int len = min(lseg, m - m0);
  const int64_t* ib = idx + (size_t)b * m + m0;

  for (int k = lane; k <= n; k += 32) cnt[k] = 0;
  for (int i = lane; i < len; i += 32) {
    const int64_t v = ib[i];
    key[i] = (v >= 0 && v < n) ? (int)v : n;
  }
  __syncwarp();

  // ranks, in m order: the count of the key in earlier chunks plus the
  // lanes below with the same key
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < len; i0 += 32) {
    const int i = i0 + lane;
    const int k = i < len ? key[i] : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    int seen = 0;
    if (k >= 0) {
      seen = cnt[k];
      rank[i] = (uint16_t)(seen + __popc(peers & below));
    }
    __syncwarp();
    if (k >= 0 && (peers & below) == 0) cnt[k] = (uint16_t)(seen + __popc(peers));
    __syncwarp();
  }

  // exclusive scan of cnt[0..n] in place: lane l takes a contiguous range
  const int per = (n + 1 + 31) / 32;
  const int k0 = min(n + 1, lane * per), k1 = min(n + 1, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += cnt[k];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  int run = incl - sum;
  for (int k = k0; k < k1; ++k) {
    const int c = cnt[k];
    cnt[k] = (uint16_t)run;
    run += c;
  }
  __syncwarp();

  uint16_t* ob = offsets + ((size_t)b * segs + s) * (n + 1);
  for (int k = lane; k <= n; k += 32) ob[k] = cnt[k];
  int* pb = perm + (size_t)b * m + m0;
  for (int i = lane; i < len; i += 32) pb[cnt[key[i]] + rank[i]] = m0 + i;
}

// A 16- or 4-byte asynchronous copy from global into shared memory
// (cp.async; .cg, which skips L1, takes only 16).
template <bool kVec4>
__device__ __forceinline__ void copy_async(void* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kVec4) asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(at), "l"(src));
  else asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(at), "l"(src));
}

// A pass's lanes: ns live slots, p = the power of two >= ns lanes a row,
// 32 / p rows copied a step, r rows a stage (at most kStageCells cells).
__host__ __device__ inline int stage_rows(int ns) { return min(32, kStageCells / ns); }

template <bool kVec4>
__global__ void __launch_bounds__(kSumThreads)
gather_bwd_sum_kernel(const float* __restrict__ g, const int* __restrict__ perm,
                      const uint16_t* __restrict__ offsets, float* __restrict__ dsrc, int m, int n, int c,
                      int lseg, int segs) {
  using Vec = typename std::conditional<kVec4, float4, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (j >= n) return;  // warp-uniform
  const int slots = kVec4 ? c / 4 : c;
  const int ns0 = min(32, slots);  // the first pass takes the most cells
  Vec* stage = reinterpret_cast<Vec*>(smem) + (size_t)(threadIdx.x >> 5) * ns0 * stage_rows(ns0);
  const float* gb = g + (size_t)b * m * c;
  const int* pb = perm + (size_t)b * m;
  const uint16_t* ob = offsets + (size_t)b * segs * (n + 1) + j;
  float* row = dsrc + ((size_t)b * n + j) * c;

  for (int slot0 = 0; slot0 < slots; slot0 += 32) {  // one pass at C <= 128 (float4), C <= 32
    const int ns = min(32, slots - slot0);
    int p = 1;
    while (p < ns) p <<= 1;
    const int groups = 32 / p, r = stage_rows(ns);  // r is a multiple of groups
    const int q = lane / p, sl = lane % p;
    const bool live = sl < ns;
    const float* gs = gb + (size_t)(slot0 + sl) * (kVec4 ? 4 : 1);
    Vec acc;
    if constexpr (kVec4) acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f); else acc = 0.0f;

    for (int s0 = 0; s0 < segs; s0 += 32) {
      // lane t: segment s0 + t's sub-run of row j
      int start = 0, len = 0;
      if (s0 + lane < segs) {
        const uint16_t* o = ob + (size_t)(s0 + lane) * (n + 1);
        start = o[0];
        len = o[1] - start;
      }
      int incl = len;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      // entry e of the concatenated run, in lane t's segment, is perm[first_t + e]
      const int first = (s0 + lane) * lseg + start - (incl - len);
      auto entry = [&](int e0) {
        const int e = e0 + lane;
        int t = 0;  // the lanes whose runs end at or before e
        for (int d = 16; d; d >>= 1)
          if (__shfl_sync(kFull, incl, t + d - 1) <= e) t += d;
        const int at = __shfl_sync(kFull, first, t) + e;
        return e < total ? __ldg(pb + at) : -1;
      };

      int cur = total > 0 ? entry(0) : -1;
      for (int e0 = 0; e0 < total; e0 += 32) {
        const int nxt = e0 + 32 < total ? entry(e0 + 32) : -1;  // its loads overlap this chunk's
        const int cnt = min(32, total - e0);
        for (int h = 0; h < cnt; h += r) {
          const int ch = min(r, cnt - h);
          // every row of the stage in flight at once: lane (q, sl) copies slot
          // sl of rows q, q + groups, ...
          for (int u = q; u < r; u += groups) {
            const int src = __shfl_sync(kFull, cur, (h + u) & 31);
            if (live && u < ch) copy_async<kVec4>(stage + u * ns + sl, gs + (size_t)src * c);
          }
          asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
          __syncwarp();
          if (live) {
            for (int u = 0; u < ch; ++u) {  // in m order
              const Vec v = stage[u * ns + sl];
              if constexpr (kVec4) {
                acc.x = acc.x + v.x;
                acc.y = acc.y + v.y;
                acc.z = acc.z + v.z;
                acc.w = acc.w + v.w;
              } else {
                acc = acc + v;
              }
            }
          }
          __syncwarp();  // the stage is read before the next copies land
        }
        cur = nxt;
      }
    }
    if (live && q == 0) {
      if constexpr (kVec4) reinterpret_cast<float4*>(row)[slot0 + sl] = acc; else row[slot0 + sl] = acc;
    }
  }
}

}  // namespace

// idx (B, M) int64; perm (B, M) int32 and offsets (B, S, N + 1) uint16, S =
// ceil(M / lseg): segment s's local CSR (see above), every entry written.
// lseg in [32, 16384], N <= 65536 at lseg = 16384 (a warp's shared arrays
// within 227 KB).
extern "C" int deepclr_gather_bwd_index(const int64_t* idx, int* perm, uint16_t* offsets, int b, int m, int n,
                                        int lseg, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || m <= 0 || n <= 0 || lseg < 32 || lseg > 16384) return (int)cudaErrorInvalidValue;
  const int per_warp = index_smem_per_warp(n, lseg);
  if (per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int segs = (m + lseg - 1) / lseg;
  const int warps = max(1, min(kIndexMaxWarps, kIndexSmemTarget / per_warp));
  const int smem = warps * per_warp;
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(gather_bwd_index_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const dim3 grid((segs + warps - 1) / warps, b);
  gather_bwd_index_kernel<<<grid, 32 * warps, smem, stream>>>(idx, perm, offsets, m, n, lseg, segs, warps,
                                                              per_warp);
  return (int)cudaGetLastError();
}

// g (B, M, C) float32; perm, offsets from deepclr_gather_bwd_index with the
// same lseg (none when M = 0); dsrc (B, N, C) float32, every entry written.
extern "C" int deepclr_gather_bwd(const float* g, const int* perm, const uint16_t* offsets, float* dsrc, int b,
                                  int m, int n, int c, int lseg, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || m < 0 || n <= 0 || c <= 0 || lseg < 32 || lseg > 16384)
    return (int)cudaErrorInvalidValue;
  const int segs = (m + lseg - 1) / lseg;
  const dim3 grid((n + kSumWarps - 1) / kSumWarps, b);
  const bool vec4 = c % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dsrc) % 16 == 0;
  const int ns0 = min(32, vec4 ? c / 4 : c);  // as in the kernel
  const int smem = kSumWarps * ns0 * stage_rows(ns0) * (vec4 ? 16 : 4);
  static int smem_allowed[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_allowed[vec4]) {
    const cudaError_t err = cudaFuncSetAttribute(
        vec4 ? reinterpret_cast<const void*>(gather_bwd_sum_kernel<true>)
             : reinterpret_cast<const void*>(gather_bwd_sum_kernel<false>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed[vec4] = smem;
  }
  if (vec4)
    gather_bwd_sum_kernel<true><<<grid, kSumThreads, smem, stream>>>(g, perm, offsets, dsrc, m, n, c, lseg, segs);
  else
    gather_bwd_sum_kernel<false><<<grid, kSumThreads, smem, stream>>>(g, perm, offsets, dsrc, m, n, c, lseg,
                                                                      segs);
  return (int)cudaGetLastError();
}
