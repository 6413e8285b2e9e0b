// Furthest point sampling, one thread block per cloud.
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
// What bounds it on H100: the npoint steps are a serial chain, and each step
// ends in a block-wide (max d^2, min index) reduction, so the kernel is
// latency-bound (sync + shuffle tree per step), not bound by bytes or FLOPs:
// it moves ~13 bytes per point once and does ~9 operations per point per step.
//
// Design: the cloud's coordinates live in shared memory as three planes
// (12 bytes a point: 192 KB at N = 16384, inside a block's 227 KB), and each
// thread keeps the running min d^2 of its PT points in registers (16 at
// N = 16384 with 1024 threads), so a step reads no device memory.  Thread t
// owns points t, t + T, t + 2T, ... so plane reads are conflict-free.  The
// block reduction takes one __syncthreads per step: per-warp winners go to a
// double-buffered slot array and every warp reduces the 32 slots itself.
// One block per cloud gives 2B blocks (32 at the flagship B = 16) on 132 SMs.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void take_better(float& d, int& i, float od, int oi) {
  if (od > d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(d, i, od, oi);
  }
}

// Block-wide (max d, min index); every thread returns the winner index.
__device__ __forceinline__ int block_argmax(float d, int i, float (*slot_d)[32],
                                            int (*slot_i)[32], int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_argmax(d, i);
  if (lane == 0) {
    slot_d[parity][warp] = d;
    slot_i[parity][warp] = i;
  }
  __syncthreads();
  d = lane < nwarps ? slot_d[parity][lane] : -INFINITY;
  i = lane < nwarps ? slot_i[parity][lane] : INT_MAX;
  warp_argmax(d, i);
  return i;
}

template <int PT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
           int32_t* __restrict__ out, int n, int npoint) {
  extern __shared__ float planes[];
  __shared__ float slot_d[2][32];
  __shared__ int slot_i[2][32];
  float* xs = planes;
  float* ys = xs + n;
  float* zs = ys + n;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const float* p = xyz + (size_t)b * n * 3;
  const uint8_t* m = mask + (size_t)b * n;
  int32_t* o = out + (size_t)b * npoint;

  for (int j = tid; j < n; j += nt) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
  }

  float dist[PT];
  float key_d = -INFINITY;
  int key_i = INT_MAX;
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int j = tid + k * nt;
    if (j < n) {
      const bool valid = m[j] != 0;
      dist[k] = valid ? 1e10f : -1.0f;
      // first pick: lowest valid index, or 0 when none is valid
      take_better(key_d, key_i, valid ? 1.0f : 0.0f, j);
    } else {
      dist[k] = -INFINITY;  // slot past the cloud: never picked
    }
  }
  int parity = 0;
  int last = block_argmax(key_d, key_i, slot_d, slot_i, parity);
  parity ^= 1;
  if (tid == 0) o[0] = last;

  for (int s = 1; s < npoint; ++s) {
    const float cx = xs[last], cy = ys[last], cz = zs[last];
    float best_d = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int j = tid + k * nt;
      if (j < n) {
        const float dx = xs[j] - cx;
        const float dy = ys[j] - cy;
        const float dz = zs[j] - cz;
        float d2 = dx * dx + dy * dy;
        d2 = d2 + dz * dz;
        dist[k] = fminf(dist[k], d2);
      }
      // j grows with k, so a strict '>' keeps the lowest index of a tie
      if (dist[k] > best_d) {
        best_d = dist[k];
        best_i = j;
      }
    }
    last = block_argmax(best_d, best_i, slot_d, slot_i, parity);
    parity ^= 1;
    if (tid == 0) o[s] = last;
  }
}

template <int PT>
cudaError_t launch(const float* xyz, const uint8_t* mask, int32_t* out, int b, int n,
                   int npoint, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PT><<<b, threads, smem, stream>>>(xyz, mask, out, n, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" int deepclr_fps(const float* xyz, const uint8_t* mask, int32_t* out, int b,
                           int n, int npoint, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return (int)cudaErrorInvalidValue;
  if (n <= kMaxThreads) {
    const int threads = ((n + 31) / 32) * 32;
    return (int)launch<1>(xyz, mask, out, b, n, npoint, threads, stream);
  }
  const int per = (n + kMaxThreads - 1) / kMaxThreads;
  if (per <= 2) return (int)launch<2>(xyz, mask, out, b, n, npoint, kMaxThreads, stream);
  if (per <= 4) return (int)launch<4>(xyz, mask, out, b, n, npoint, kMaxThreads, stream);
  if (per <= 8) return (int)launch<8>(xyz, mask, out, b, n, npoint, kMaxThreads, stream);
  if (per <= 16) return (int)launch<16>(xyz, mask, out, b, n, npoint, kMaxThreads, stream);
  return (int)cudaErrorInvalidValue;
}
