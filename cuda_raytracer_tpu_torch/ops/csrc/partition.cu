// Stable compaction of live entries to a prefix, in one pass.
//
// Replaces the TPU kernel cuda_raytracer_tpu/ops/pallas/partition.py
// (_partition_kernel, launched by compact_live_payload).  That kernel
// sweeps 1024-lane blocks in order on one core, routes each block's live
// lanes through a shift network into a staging tail and carries the
// write cursor from block to block.  Blocks here run in no order, so a
// position comes from a single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002):
//   * a block takes the next tile id from an atomic counter, so every
//     tile it may wait on has already started and never waits on it;
//   * it ranks its tile's live entries by warp ballots and a scan of the
//     warp counts, publishes the tile's count (flag AGG), looks back over
//     its predecessors' flag/value words a warp at a time until it meets
//     an inclusive prefix (flag INC), then publishes its own;
//   * it copies each live entry to its rank; the last tile writes n_live.
// The order of the live entries is kept, the result is the same from run
// to run, and there are no float atomics.  Entries of the output past
// n_live are left unwritten (undefined), as in the TPU kernel.
//
// One scan core, two loaders:
//   * PayloadLoader: an [n, R] float32 payload, R = 8 (a wavefront queue
//     entry: o.xyz d.xyz rayid tub) or 16 (a whole path state); an entry
//     is live when its field 7 (tub) is >= 0.
//   * RayLoader: the rays as the frame holds them (o, d [n, 3], valid [n],
//     t_limit [n] or none); lane i is live when valid[i] and its bound
//     tub = min(t_limit[i], 1e30) (1e30 without t_limit; NaN stays NaN)
//     is >= 0, and becomes the 8-float queue entry (o.xyz d.xyz i tub),
//     i as an int32 bit pattern.  It reads valid (and t_limit) for every
//     lane and o, d only for live lanes: the wavefront trace's level-0
//     queue without building it at full size first.
//
// Bound on the H100: bytes.  Payload: every entry read once (field 7
// alone touches every 32-byte sector of an R = 8 entry) and every live
// entry written once, (n + n_live) * R * 4 B.  Rays: n * (1 B, + 4 B with
// t_limit) + n_live * (24 B read + 32 B written).  The design reads each
// byte once from device memory (a live entry's second read, for the copy,
// comes from L1/L2 right after its liveness test) and writes nothing past
// n_live; the look-back adds one 8-byte word per tile.

#include <cuda_runtime.h>

#define CBLOCK 256
#define CWARPS (CBLOCK / 32)
#define FULL 0xffffffffu
#define T_NO_LIMIT 1e30f

// flag of a tile's status word (high 32 bits); the low 32 bits hold the
// value: the tile's own count (AGG) or the count of it and all before (INC)
#define FLAG_AGG 1ull
#define FLAG_INC 2ull

struct PayloadLoader {
  const float* payload;
  float* out;
  int R;
  __device__ __forceinline__ bool live(long long i, float* tub) const {
    *tub = payload[i * R + 7];
    return *tub >= 0.0f;
  }
  __device__ __forceinline__ void emit(long long i, long long dst,
                                       float) const {
    const float4* s = reinterpret_cast<const float4*>(payload + i * R);
    float4* d = reinterpret_cast<float4*>(out + dst * R);
    for (int q = 0; q < R / 4; ++q) d[q] = s[q];
  }
};

struct RayLoader {
  const float* o;
  const float* d;
  const bool* valid;
  const float* t_limit;  // null: closest-hit, every valid lane is live
  float* out;            // [n, 8]
  __device__ __forceinline__ bool live(long long i, float* tub) const {
    if (!valid[i]) return false;
    if (t_limit == nullptr) {
      *tub = T_NO_LIMIT;
      return true;
    }
    const float t = t_limit[i];
    *tub = t != t ? t : fminf(t, T_NO_LIMIT);  // torch.clamp_max keeps NaN
    return *tub >= 0.0f;
  }
  __device__ __forceinline__ void emit(long long i, long long dst,
                                       float tub) const {
    float4* e = reinterpret_cast<float4*>(out + dst * 8);
    e[0] = make_float4(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i]);
    e[1] = make_float4(d[3 * i + 1], d[3 * i + 2], __int_as_float((int)i),
                       tub);
  }
};

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ void publish(unsigned long long* state, int tile,
                                        unsigned long long flag, int value) {
  *reinterpret_cast<volatile unsigned long long*>(state + tile) =
      (flag << 32) | (unsigned)value;
}

// warp 0 of tile `tile` (> 0): the count of all entries before the tile.
// Lane k reads the status word of tile - 1 - k - 32 * round; tiles before
// 0 read as an inclusive 0.
__device__ __forceinline__ int look_back(unsigned long long* state, int tile,
                                         int lane) {
  int excl = 0;
  for (int p0 = tile - 1;; p0 -= 32) {
    const int p = p0 - lane;
    unsigned long long s;
    do {
      s = p >= 0 ? *reinterpret_cast<volatile unsigned long long*>(state + p)
                 : (FLAG_INC << 32);
    } while (__any_sync(FULL, (s >> 32) == 0ull));
    const unsigned inc = __ballot_sync(FULL, (s >> 32) == FLAG_INC);
    int v = (int)(unsigned)(s & 0xffffffffull);
    if (inc) {  // stop at the nearest inclusive prefix
      if (lane > __ffs(inc) - 1) v = 0;
      return excl + warp_sum(v);
    }
    excl += warp_sum(v);
  }
}

// one tile of CBLOCK * ITEMS entries per block; item j of thread t is
// entry tile_base + j * CBLOCK + t.  state: [tiles] status words and
// tile_counter, all zero at launch.
template <class Loader, int ITEMS>
__global__ void __launch_bounds__(CBLOCK)
compact_kernel(Loader ld, long long n, unsigned long long* __restrict__ state,
               int* __restrict__ tile_counter, int* __restrict__ n_live,
               int last_tile) {
  __shared__ int s_tile, s_excl;
  __shared__ int s_counts[ITEMS * CWARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * (CBLOCK * ITEMS) + threadIdx.x;

  unsigned bal[ITEMS];
  float tub[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = base + (long long)j * CBLOCK;
    const bool lv = i < n && ld.live(i, &tub[j]);
    bal[j] = __ballot_sync(FULL, lv);
    if (lane == 0) s_counts[j * CWARPS + warp] = __popc(bal[j]);
  }
  __syncthreads();

  if (warp == 0) {
    // exclusive scan of the ITEMS * CWARPS warp counts, in item-major
    // order (= entry order); lane k holds K consecutive counts
    constexpr int K = (ITEMS * CWARPS + 31) / 32;
    int c[K], sum = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = lane * K + k;
      c[k] = idx < ITEMS * CWARPS ? s_counts[idx] : 0;
      sum += c[k];
    }
    const int incl = warp_inclusive_scan(sum, lane);
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = lane * K + k;
      if (idx < ITEMS * CWARPS) s_counts[idx] = run;
      run += c[k];
    }
    const int agg = __shfl_sync(FULL, incl, 31);
    int excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(state, 0, FLAG_INC, agg);
    } else {
      if (lane == 0) publish(state, tile, FLAG_AGG, agg);
      excl = look_back(state, tile, lane);
      if (lane == 0) publish(state, tile, FLAG_INC, excl + agg);
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == last_tile) *n_live = excl + agg;
    }
  }
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;
  const int excl = s_excl;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if ((bal[j] >> lane) & 1u) {
      const long long dst =
          excl + s_counts[j * CWARPS + warp] + __popc(bal[j] & lt);
      ld.emit(base + (long long)j * CBLOCK, dst, tub[j]);
    }
  }
}

template <class Loader, int ITEMS>
static int launch(const Loader& ld, long long n, void* scratch, void* n_live,
                  cudaStream_t st) {
  const long long per = (long long)CBLOCK * ITEMS;
  const int tiles = (int)((n + per - 1) / per);
  // scratch: [tiles] status words, then the tile counter
  unsigned long long* state = (unsigned long long*)scratch;
  cudaMemsetAsync(state, 0, (size_t)(tiles + 1) * 8, st);
  compact_kernel<Loader, ITEMS><<<tiles, CBLOCK, 0, st>>>(
      ld, n, state, (int*)(state + tiles), (int*)n_live, tiles - 1);
  return (int)cudaGetLastError();
}

// entries per tile of each form (sizes the caller's scratch)
#define PAYLOAD_ITEMS 8
#define RAY_ITEMS 16

extern "C" int partition_tile_entries(int rays) {
  return CBLOCK * (rays ? RAY_ITEMS : PAYLOAD_ITEMS);
}

// payload, out: [n, R] float32, R a multiple of 4 and >= 8; scratch: at
// least tiles + 1 int64; n_live: one int32.
extern "C" int partition_compact(const void* payload, void* out,
                                 void* scratch, void* n_live, long long n,
                                 int R, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  PayloadLoader ld{(const float*)payload, (float*)out, R};
  return launch<PayloadLoader, PAYLOAD_ITEMS>(ld, n, scratch, n_live,
                                               (cudaStream_t)stream);
}

// o, d: [n, 3] float32; valid [n] bool; t_limit [n] float32 or null; out:
// [n, 8] float32; scratch and n_live as above.
extern "C" int partition_rays(const void* o, const void* d, const void* valid,
                              const void* t_limit, void* out, void* scratch,
                              void* n_live, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  RayLoader ld{(const float*)o, (const float*)d, (const bool*)valid,
               (const float*)t_limit, (float*)out};
  return launch<RayLoader, RAY_ITEMS>(ld, n, scratch, n_live,
                                       (cudaStream_t)stream);
}
