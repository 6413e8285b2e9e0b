// Furthest point sampling, one thread-block cluster per cloud.
//
// Replaces: deepclr_tpu/ops/pallas/fps_kernel.py::_fps_kernel_wide (the
// Pallas TPU kernel behind furthest_point_sample_pallas).
//
// Semantics (bit-exact with ops/fps.py::_fps_plain): start at the lowest
// valid index (0 when the cloud has none); invalid points keep a running
// distance of -1 and are never picked while a valid point remains; each step
// updates the running min d^2 to the last pick and takes the argmax, ties to
// the lowest index.  d^2 = (dx*dx + dy*dy) + dz*dz with every product
// rounded (the library is built with -fmad=false).
//
// What bounds it on H100: neither bytes nor operations.  The npoint steps
// are a serial chain, and each ends in an argmax over the whole cloud, so
// the time is npoint x (the latency of one step).  The first design ran
// one 1024-thread block per cloud: 16 running distances a thread,
// a 10-round shuffle argmax a warp, a __syncthreads and a second shuffle
// argmax, ~2.5 us a step (2.57 ms at 32 x 16384 -> 1024, NVIDIA H100 80GB
// HBM3, 700 W), and it used only B of the 132 SMs (1 in the odometry step).
//
// Design: a cluster of C CTAs per cloud (C = 1, 2, 4, 8 or 16; 16 is the
// non-portable cluster size).  CTA r owns the contiguous index range
// [r * per_cta, (r + 1) * per_cta): its coordinates as three shared planes,
// the running distances PT >= 4 a thread in registers (thread t owns local
// points t, t + T, ..., so plane reads are conflict-free).  A step:
//   * every thread updates its PT distances and keeps its best (strict >
//     over ascending index: the lowest index of a tie);
//   * a warp argmax in two redux instructions: __reduce_max_sync on the
//     order-preserving bits of d, then __reduce_min_sync on the index among
//     the lanes at that maximum; the warps' winners meet in shared memory
//     (one __syncthreads) and warp 0 takes the CTA's winner the same way;
//   * lanes 0..C-1 of warp 0 send the CTA's candidate (key, index, x, y, z)
//     to slot `rank` of every CTA with st.async into distributed shared
//     memory, each store completing bytes on the receiving CTA's mbarrier
//     for that step's parity (double-buffered slots);
//   * every warp waits on its own CTA's mbarrier, reduces the C slots by
//     the same rule and takes the winner's coordinates from the payload, so
//     no remote read and no cluster-wide barrier sits on the chain.
// The slots and barriers cannot run ahead: a CTA sends step s + 2's
// candidate only after its barrier saw step s + 1's from every CTA, each
// sent after all of that CTA's warps had read step s's slots.
//
// Design studies on an NVIDIA H100 80GB HBM3 at 700 W ranked the ways to
// meet a step: one cluster-wide barrier a step (barrier.cluster.arrive.
// release / wait.acquire by every thread) was the slowest, even at C = 1
// slower than the first design; st.async with every warp sending its own
// candidate (C x W slots) next; this CTA-first design the fastest.  Four
// points a thread beat eight and sixteen.  CTAs may share an SM: at 32
// clouds 16-CTA clusters sharing SMs beat 2-CTA clusters alone on theirs.
// C = 1 is the single-block design.
//
// Measured when this design was chosen (back-to-back launches between two
// CUDA events, NVIDIA H100 80GB HBM3, 700 W): 1.14 / 0.76 / 0.70 ms at
// 32 / 10 / 1 clouds of 16384 -> 1024 (C = 16), 2.33 ms at C = 1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMinPerThread = 4;
constexpr int kMaxPerThread = 16;
constexpr int kMaxPerCta = kMaxThreads * kMaxPerThread;  // 16384 points
constexpr unsigned kFull = 0xffffffffu;

// A CTA's candidate: (ordered(d), cloud index, x, y) and (z, 0), written
// into every CTA of the cluster by st.async, whose completion the receiving
// CTA's mbarrier of that step's parity counts in bytes.
struct Slots {
  uint4 head[2][kMaxCluster];  // the C CTAs' candidates of a step
  uint2 tail[2][kMaxCluster];
  uint2 warp_best[kMaxWarps];  // this CTA's warp winners: (ordered(d), index)
  unsigned long long bar[2];
};
constexpr unsigned kSlotBytes = sizeof(uint4) + sizeof(uint2);

// Order-preserving map: a < b as floats iff ordered(a) < ordered(b).
__device__ __forceinline__ unsigned ordered(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (max key, then min index) over the warp; every lane returns the winner.
__device__ __forceinline__ void warp_argmax(unsigned& key, int& idx) {
  const unsigned m = __reduce_max_sync(kFull, key);
  idx = (int)__reduce_min_sync(kFull, key == m ? (unsigned)idx : 0xffffffffu);
  key = m;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned remote_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_async(unsigned dst, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void store_async(unsigned dst, uint2 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

// one arrival (the barrier's only one) and `bytes` more expected this phase
__device__ __forceinline__ void arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int PT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           int32_t* __restrict__ out, int n, int npoint, int per_cta) {
  extern __shared__ float planes[];
  __shared__ Slots slots;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cloud = blockIdx.x / c;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int span = nt * PT;  // plane length: every slot a thread owns
  const int base = rank * per_cta;
  const int cnt = max(0, min(per_cta, n - base));  // this CTA's points
  float* xs = planes;
  float* ys = xs + span;
  float* zs = ys + span;
  const float* p = xyz + ((size_t)cloud * n + base) * 3;
  const uint8_t* m = mask + (size_t)cloud * n + base;
  int32_t* o = out + (size_t)cloud * npoint;

  for (int l = tid; l < span; l += nt) {
    const bool in = l < cnt;
    xs[l] = in ? p[3 * l] : 0.0f;
    ys[l] = in ? p[3 * l + 1] : 0.0f;
    zs[l] = in ? p[3 * l + 2] : 0.0f;
  }

  // first pick: the lowest valid index (key 1), else the lowest index (key 0)
  float dist[PT];
  float best_d = -INFINITY;
  int best_l = tid;  // a slot past the CTA's points keeps -inf: never picked
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int l = tid + k * nt;
    if (l < cnt) {
      const bool valid = m[l] != 0;
      dist[k] = valid ? 1e10f : -1.0f;
      const float key = valid ? 1.0f : 0.0f;
      if (key > best_d) {
        best_d = key;
        best_l = l;
      }
    } else {
      dist[k] = -INFINITY;
    }
  }

  const unsigned step_bytes = (unsigned)c * kSlotBytes;  // one candidate from every CTA
  const unsigned bar0 = smem_addr(&slots.bar[0]);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar0 + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm(bar0, step_bytes);                      // step 0
    if (npoint > 1) arm(bar0 + 8, step_bytes);  // step 1
  }
  // every CTA of the cluster runs, with its barriers armed, before any
  // candidate store
  cluster_arrive();
  cluster_wait();

  // where lane r < C of warp 0 stores this CTA's candidate: slot `rank` of CTA r
  unsigned dst_head = 0, dst_tail = 0, dst_bar = 0;
  if (warp == 0 && lane < c) {
    dst_head = remote_addr(smem_addr(&slots.head[0][rank]), (unsigned)lane);
    dst_tail = remote_addr(smem_addr(&slots.tail[0][rank]), (unsigned)lane);
    dst_bar = remote_addr(bar0, (unsigned)lane);
  }
  constexpr unsigned kHeadPar = sizeof(slots.head[0]), kTailPar = sizeof(slots.tail[0]);

  for (int s = 0; s < npoint; ++s) {
    const int par = s & 1;
    unsigned key = ordered(best_d);
    int idx = base + best_l;
    warp_argmax(key, idx);
    if (lane == 0) slots.warp_best[warp] = make_uint2(key, (unsigned)idx);
    __syncthreads();
    if (warp == 0) {  // the CTA's candidate, to every CTA of the cluster
      const uint2 wb = lane < nwarps ? slots.warp_best[lane] : make_uint2(0u, 0xffffffffu);
      key = wb.x;
      idx = (int)wb.y;
      warp_argmax(key, idx);
      if (lane < c) {
        const int l = idx - base;  // the CTA's winner lies in this CTA
        const unsigned bar = dst_bar + 8u * par;
        store_async(dst_head + kHeadPar * par,
                    make_uint4(key, (unsigned)idx, __float_as_uint(xs[l]), __float_as_uint(ys[l])), bar);
        store_async(dst_tail + kTailPar * par, make_uint2(__float_as_uint(zs[l]), 0u), bar);
      }
    }
    // this step's C candidates have landed here; the barrier of this parity
    // serves steps par, par + 2, ..., so step s is its phase s / 2
    wait_phase(bar0 + 8u * par, (unsigned)(s >> 1) & 1u);
    // re-arm for step s + 2.  No CTA sends step s + 2's candidate before
    // this CTA has sent step s + 1's, after every one of its warps has read
    // step s's slots, so neither the phase count nor the slots run ahead.
    if (tid == 0 && s + 2 < npoint) arm(bar0 + 8u * par, step_bytes);

    // the cluster's winner, from this CTA's copy of the candidates
    const uint4 h = lane < c ? slots.head[par][lane] : make_uint4(0u, 0xffffffffu, 0u, 0u);
    const unsigned mk = __reduce_max_sync(kFull, h.x);
    const unsigned mi = __reduce_min_sync(kFull, h.x == mk ? h.y : 0xffffffffu);
    const int src = __ffs(__ballot_sync(kFull, h.x == mk && h.y == mi)) - 1;
    const float4 ct = make_float4(__uint_as_float(__shfl_sync(kFull, h.z, src)),
                                  __uint_as_float(__shfl_sync(kFull, h.w, src)),
                                  __uint_as_float(slots.tail[par][src].x), 0.0f);
    if (rank == 0 && tid == 0) o[s] = (int)mi;
    if (s + 1 == npoint) break;

    best_d = -INFINITY;
    best_l = tid;
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int l = tid + k * nt;
      if (l < cnt) {
        const float dx = xs[l] - ct.x;
        const float dy = ys[l] - ct.y;
        const float dz = zs[l] - ct.z;
        float d2 = dx * dx + dy * dy;
        d2 = d2 + dz * dz;
        dist[k] = fminf(dist[k], d2);
      }
      // l grows with k, so a strict '>' keeps the lowest index of a tie
      if (dist[k] > best_d) {
        best_d = dist[k];
        best_l = l;
      }
    }
  }
  // no CTA leaves while another may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

using Kernel = void (*)(const float*, const uint8_t*, int32_t*, int, int, int);

struct Plan {
  Kernel kernel;
  int pt;  // points a thread: the instantiation
  int per_cta, threads;
  size_t smem;  // the three coordinate planes
};

// Threads and points a thread for one CTA of the cluster: at least
// kMinPerThread points a thread (fewer warps, fewer slots to reduce), at
// most 1024 threads.
bool make_plan(int n, int c, Plan& plan) {
  if (n <= 0 || (c != 1 && c != 2 && c != 4 && c != 8 && c != kMaxCluster)) return false;
  plan.per_cta = (n + c - 1) / c;
  if (plan.per_cta > kMaxPerCta) return false;
  int pt = kMinPerThread;
  while (pt < kMaxPerThread && (plan.per_cta + pt - 1) / pt > kMaxThreads) pt *= 2;
  plan.threads = ((plan.per_cta + pt - 1) / pt + 31) / 32 * 32;
  plan.smem = (size_t)3 * plan.threads * pt * sizeof(float);
  plan.pt = pt;
  plan.kernel = pt == 4 ? fps_kernel<4> : pt == 8 ? fps_kernel<8> : fps_kernel<16>;
  return true;
}

constexpr int kMaxDevices = 64;
std::atomic<bool> g_prepared[kMaxDevices][3];  // by device and instantiation (PT = 4, 8, 16)

// The function attributes are driver calls, so each instantiation gets them
// once a device, not before every launch: the dynamic shared memory of its
// largest plan (1024 threads) and the non-portable cluster size 16.
cudaError_t prepare(const Plan& plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<bool>& done = g_prepared[dev][plan.pt == 4 ? 0 : plan.pt == 8 ? 1 : 2];
  if (done.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(3 * kMaxThreads * plan.pt * sizeof(float)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(plan.kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.store(true, std::memory_order_release);
  return err;
}

cudaError_t configure(const Plan& plan, int c, int b, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  cudaError_t err = prepare(plan);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(b * c));
  cfg.blockDim = dim3((unsigned)plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// xyz (B, N, 3) float32, mask (B, N) uint8 -> out (B, npoint) int32, with a
// cluster of c CTAs per cloud (1, 2, 4, 8 or 16; ceil(N / c) <= 16384).
extern "C" int deepclr_fps(const float* xyz, const uint8_t* mask, int32_t* out, int b, int n,
                           int npoint, int c, cudaStream_t stream) {
  Plan plan;
  if (b <= 0 || npoint <= 0 || !make_plan(n, c, plan)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(plan, c, b, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, plan.kernel, xyz, mask, out, n, npoint, plan.per_cta);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of c CTAs for an N-point cloud the current device holds
// at once (cudaOccupancyMaxActiveClusters); launches nothing.
extern "C" int deepclr_fps_max_active_clusters(int n, int c, int* clusters) {
  Plan plan;
  if (!make_plan(n, c, plan)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(plan, c, 1, nullptr, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, plan.kernel, &cfg);
}
