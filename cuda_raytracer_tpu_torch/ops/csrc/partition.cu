// Stable compaction of the live entries of a payload to a prefix.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/partition.py
// (_partition_kernel, launched by compact_live_payload).  That kernel
// sweeps 1024-lane blocks in order on one core, routes each block's live
// lanes through a shift network into a staging tail and carries the
// write cursor from block to block.  A CUDA thread can store where it
// likes and blocks run in no order, so here a position comes from a scan:
//   1. count   - per block of 1024 entries, how many are live;
//   2. scan    - one block turns the block counts into exclusive offsets
//                and their total into n_live;
//   3. scatter - each live entry is copied to offset[block] + its rank in
//                the block (warp ballots and a scan of the warp counts).
// The order of the live entries is kept, the result is the same from run
// to run, and there are no float atomics.
//
// The payload is entry-major: [n, R] float32 with R = 8 (a wavefront
// queue entry: o.xyz d.xyz rayid tub) or 16 (a whole path state), an
// entry is live when its field 7 (tub) is >= 0.  Entries of the output
// past n_live are defined: all zero with tub = -1 (dead).
//
// Bound on the H100: bytes.  Every entry is read (R*4 bytes) and every
// live entry written (R*4 bytes); no arithmetic to speak of.  This design
// reads the payload twice (count and scatter; field 7 alone still touches
// every 32-byte sector of an R = 8 entry) and writes the dead tail, so it
// moves two to three times the bound's bytes; a single-pass scan with
// decoupled look-back is the known way to read the payload once.

#include <cuda_runtime.h>

#define PBLOCK 1024

__global__ void __launch_bounds__(PBLOCK)
partition_count_kernel(const float* __restrict__ payload, int n, int R,
                       int* __restrict__ block_counts) {
  const int i = blockIdx.x * PBLOCK + threadIdx.x;
  const bool live = i < n && payload[(size_t)i * R + 7] >= 0.0f;
  const int c = __syncthreads_count(live);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// inclusive scan of one value per lane over the warp
__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// in place: block_counts[b] becomes the sum of the counts before b
__global__ void __launch_bounds__(1024)
partition_scan_kernel(int* __restrict__ block_counts, int nblocks,
                      int* __restrict__ n_live) {
  __shared__ int warp_sums[32];
  __shared__ int carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_s = 0;
  __syncthreads();
  for (int start = 0; start < nblocks; start += 1024) {
    const int idx = start + threadIdx.x;
    const int v = idx < nblocks ? block_counts[idx] : 0;
    const int x = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
    __syncthreads();
    const int carry = carry_s;
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    const int total = warp_sums[31];
    if (idx < nblocks) block_counts[idx] = carry + before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry_s = carry + total;
  }
  __syncthreads();
  if (threadIdx.x == 0) *n_live = carry_s;
}

__global__ void __launch_bounds__(PBLOCK)
partition_scatter_kernel(const float* __restrict__ payload, int n, int R,
                         const int* __restrict__ block_offsets,
                         const int* __restrict__ n_live,
                         float* __restrict__ out) {
  __shared__ int warp_counts[32];
  const int i = blockIdx.x * PBLOCK + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = i < n && payload[(size_t)i * R + 7] >= 0.0f;
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_counts[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int c = warp_counts[lane];
    warp_counts[lane] = warp_inclusive_scan(c, lane) - c;  // exclusive
  }
  __syncthreads();
  const int quads = R / 4;
  if (live) {
    const int dst = block_offsets[blockIdx.x] + warp_counts[warp] +
                    __popc(bal & ((1u << lane) - 1u));
    const float4* s = reinterpret_cast<const float4*>(payload + (size_t)i * R);
    float4* d = reinterpret_cast<float4*>(out + (size_t)dst * R);
    for (int q = 0; q < quads; ++q) d[q] = s[q];
  }
  // the tail past n_live: dead entries (live ones all land before it)
  if (i < n && i >= *n_live) {
    float4* d = reinterpret_cast<float4*>(out + (size_t)i * R);
    for (int q = 0; q < quads; ++q)
      d[q] = make_float4(0.0f, 0.0f, 0.0f, q == 1 ? -1.0f : 0.0f);
  }
}

// payload, out: [n, R] float32, R a multiple of 4 and >= 8; block_scratch:
// at least ceil(n / 1024) int32; n_live: one int32.
extern "C" int partition_compact(const void* payload, void* out,
                                 void* block_scratch, void* n_live, int n,
                                 int R, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    const int nblocks = (n + PBLOCK - 1) / PBLOCK;
    partition_count_kernel<<<nblocks, PBLOCK, 0, st>>>(
        (const float*)payload, n, R, (int*)block_scratch);
    partition_scan_kernel<<<1, 1024, 0, st>>>((int*)block_scratch, nblocks,
                                              (int*)n_live);
    partition_scatter_kernel<<<nblocks, PBLOCK, 0, st>>>(
        (const float*)payload, n, R, (const int*)block_scratch,
        (const int*)n_live, (float*)out);
  }
  return (int)cudaGetLastError();
}
