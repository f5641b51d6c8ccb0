// Fused sampling epilogue for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/fused_sampling.py::
//   fused_sample_kernel (def :171, pl.pallas_call :181, body
//   _sample_kernel :142 with _topk_threshold :110)
// and computes what it computes, per row of (B, V) fp32 logits:
//   * z = logits / temperature (a division, as the plain version's, so z
//     is bit-equal to it and ties split alike);
//   * with top_k: the k-th largest value of z counting duplicates (the
//     reference's count-above walk returns the same value: the smallest
//     distinct t with count(z >= t) >= k), then z < kth -> -1e30, so every
//     tie at the k-th value is kept (lax.top_k's threshold);
//   * with top-p: p = exp(z - max) / sum and p < cutoff[b] -> -1e30, where
//     the per-row cutoff (it needs a vocabulary sort) comes from outside;
//   * y = z + gumbel (the noise comes from outside too);
//   * the FIRST index of the max of y, as int32.
//
// Design: one launch; each row split over a thread-block cluster.
//   * Grid (n_split, B), cluster (n_split, 1, 1), 1024 threads a block:
//     block r of a row's cluster owns the r-th contiguous slice of
//     ceil(V / n_split) elements (the last slices may be short or empty).
//     The wrapper picks n_split, at most the portable cluster size 8, from
//     B, V and the SM count (fused_sampling.py::choose_sample_split). A
//     block asks for enough shared memory to have its SM to itself.
//   * Read once. The block copies its slice of the logits into dynamic
//     shared memory with 16-byte cp.async and, where both fit, its slice
//     of the noise too, in a second group that lands while the block
//     works. It divides by the temperature in place and takes its max.
//     Every later pass reads shared memory. (A slice too large for shared
//     memory, at a V no model of the repo has, takes the same code with
//     every pass reading device memory: right, and slower.)
//   * Top-k in four cluster steps whatever k is and whatever the data: a
//     radix select over order-preserving uint32 keys of z (-0.0 keyed as
//     +0.0), 8 bits a step from the top. In each step every block
//     histograms the next digit of its keys under the digits found so far
//     (shared atomics into 16 histograms, two warps to each), adds the
//     non-empty bins into every block's cluster histogram through
//     distributed shared memory (DSMEM, `red.shared::cluster`), and after
//     one cluster barrier every block picks the same digit. Two cluster
//     histograms alternate, and a block clears the one it read before its
//     next arrive, so one barrier a step suffices. The four digits give
//     the exact key of the k-th largest, ties counted. Each step is a pass
//     over the staged slice; only the first counts every key.
//   * Cluster reductions by push: each block writes its partial result
//     into slot [rank] of every block's (or rank 0's) shared memory, then
//     one cluster barrier (arrive.release / wait.acquire). The row max
//     rides on the first step's barrier; the top-p denominator, one pass
//     of exp(z - max) over the entries top-k keeps, is summed in rank
//     order, so every block holds the same one; the final (value, global index) pairs go to rank
//     0, which merges them by arg_merge (larger value, then smaller global
//     index: the first index of the max, wherever the slices fall) and
//     writes out[b]. No second launch, no global scratch; after the last
//     barrier no block touches another's memory, so the blocks may leave
//     in any order.
//   * Cluster barriers a call: the start (its wait hidden behind the
//     loads), four top-k steps, top-p (without top-k, one more for the
//     max), the final one.
//
// One deliberate difference: the top-p test keeps a token whose p is
// below the cutoff by less than a relative TOP_P_SLACK, and always keeps
// the top slot. The cutoff comes from torch's softmax and this kernel
// sums the row in another order, so without the margin the token that
// sits exactly on the cutoff (there is always one) would flip at random.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3): the function must read
// the logits and the noise once, 2 * B * V * 4 bytes (9.7 MB at B = 8,
// V = 152064: 2.9 us), and does a few operations per element, so it is
// bound by bytes. The design reads each byte once; what keeps it above
// the bound is the chain of block-wide steps (each a pass over the slice
// in shared memory or a scan, ended by a barrier) and cluster barriers
// between the load and the token, each waiting on the slowest thread or
// block (PERF.md has the times).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int HROWS = 16;           // first-digit histograms, 2 warps each
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;           // 8-bit radix digits
constexpr int PASSES = 4;           // 32-bit keys
constexpr int MAX_SPLIT = 8;        // the portable cluster size
constexpr int MAX_DYN_SMEM = 192 * 1024;
// Dynamic shared memory a block asks for at least: with its static part,
// more than half an SM's 228 KB, so the scheduler never packs two blocks
// on one SM (a cluster with two blocks an SM runs at the pace of those).
constexpr int MIN_DYN_SMEM = 116 * 1024;
constexpr float NEG_INF = -1e30f;  // the reference's masked value
// Relative margin of the top-p test: far above the few ulps by which two
// fp32 sums of the row in different orders differ, far below the gap
// between two distinct probabilities of bf16 logits.
constexpr float TOP_P_SLACK = 1.0f / 16384;

static_assert(THREADS >= BINS && WARPS <= 32, "block shape");

struct Params {
  const float* logits;
  const float* gumbel;
  const float* cutoff;  // (B, 1); read only when use_top_p
  int* out;
  int V;
  int per;  // slice length, ceil(V / n_split)
  float temperature;
  int top_k;  // <= 0: no top-k
  int use_top_p;
  int n_split;
  int stage_noise;  // the noise slice is staged in shared memory too
};

// Floats a staged slice takes: its element i sits at index i - a0, where
// a0 <= lo is 16-byte aligned in device memory, so up to 3 in front; a
// multiple of 4, so the next region stays 16-byte aligned.
__host__ __device__ constexpr int region_floats(int per) {
  return (per + 6) / 4 * 4;
}

// 2: logits and noise staged in shared memory; 1: the logits only; 0:
// neither (every pass reads device memory).
__host__ __device__ constexpr int staging(int per) {
  return 8L * region_floats(per) <= MAX_DYN_SMEM   ? 2
         : 4L * region_floats(per) <= MAX_DYN_SMEM ? 1
                                                   : 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier: writes (to any block's shared
// memory) before a thread's arrive are seen by every thread after its
// wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Adds v to the word at `local` in the shared memory of the cluster's
// block `rank` (fire and forget: the next cluster barrier publishes it).
__device__ __forceinline__ void red_add_cluster(unsigned* local, int rank,
                                                unsigned v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" ::"r"(remote),
               "r"(v)
               : "memory");
}

// Issues the copy of row[lo, hi) into dst, element i at dst[i - a0] (a0
// the last 16-byte boundary at or below lo): cp.async for the aligned
// body, plain loads for the at most 3 elements on either side. Returns
// lo - a0.
__device__ int stage(float* dst, const float* row, int lo, int hi) {
  const int tid = threadIdx.x;
  const int head = (int)((reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
  const int a0 = lo - head;
  const int first = head ? a0 + 4 : lo;
  if (hi <= first) {
    if (tid < hi - lo) dst[lo + tid - a0] = row[lo + tid];
    return head;
  }
  const int n_vec = (hi - first) / 4;
  const int vec_end = first + 4 * n_vec;
  for (int t = tid; t < n_vec; t += THREADS)
    cp_async16(dst + (first - a0) + 4 * t, row + first + 4 * t);
  if (tid < first - lo) dst[lo + tid - a0] = row[lo + tid];
  if (tid < hi - vec_end) dst[vec_end + tid - a0] = row[vec_end + tid];
  return head;
}

// Order-preserving key of a float: a < b iff key(a) < key(b), with -0.0
// keyed as +0.0 (they compare equal).
__device__ __forceinline__ unsigned radix_key(float z) {
  unsigned u = __float_as_uint(z);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Block-wide reductions returning the result to every thread. The first
// __syncthreads frees `red` from the previous reduction's readers.
__device__ float block_max(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < WARPS ? red[lane] : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (value, index) with the larger value winning and, on a tie, the smaller
// index: the first index attaining the max.
__device__ __forceinline__ void arg_merge(float& v, int& i, float v2,
                                          int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ void block_argmax(float& v, int& i, float* redv, int* redi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
              __shfl_xor_sync(0xffffffffu, i, off));
  __syncthreads();
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  v = lane < WARPS ? redv[lane] : -INFINITY;
  i = lane < WARPS ? redi[lane] : INT_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
              __shfl_xor_sync(0xffffffffu, i, off));
}

// STAGED: the logits slice lives in shared memory (see staging()).
template <bool STAGED>
__global__ void __launch_bounds__(THREADS) sample_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned hist[HROWS][BINS];   // shared by warps w, w + 16
  __shared__ unsigned hist_sum[2][BINS];   // the row's, by pass parity
  __shared__ float max_part[MAX_SPLIT];    // slot r: rank r's partial
  __shared__ float sum_part[MAX_SPLIT];
  __shared__ float best_part[MAX_SPLIT];   // read by rank 0 only
  __shared__ int arg_part[MAX_SPLIT];
  __shared__ float redf[WARPS];
  __shared__ int redi[WARPS];
  __shared__ unsigned scan[BINS / 32];
  __shared__ unsigned sel[2];  // the pass's digit, the rank left in it

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = p.n_split, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int lo = min(p.V, rank * p.per), len = min(p.V, lo + p.per) - lo;
  const float* row = p.logits + (size_t)b * p.V + lo;
  const float* noise = p.gumbel + (size_t)b * p.V + lo;
  const float temp = p.temperature;
  const bool use_k = p.top_k > 0;

  // Clear what other blocks add into, then arrive: the matching wait
  // comes before this block's first remote write, after the loads.
  for (int i = tid; i < 2 * BINS; i += THREADS) hist_sum[i / BINS][i % BINS] = 0;
  for (int i = tid; i < HROWS * BINS; i += THREADS) hist[i / BINS][i % BINS] = 0;
  cluster_arrive();

  float* zs = smem;          // z of the slice, element j at zs[j]
  const float* ns = noise;   // the noise slice, element j at ns[j]
  if constexpr (STAGED) {
    zs = smem + stage(smem, row - lo, lo, lo + len);
    cp_async_commit();
    if (p.stage_noise) {
      float* dst = smem + region_floats(p.per);
      ns = dst + stage(dst, noise - lo, lo, lo + len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the logits; the noise may still be landing
    __syncthreads();
  }
  auto z_at = [&](int j) {
    if constexpr (STAGED) return zs[j];
    else return row[j] / temp;
  };

  // The radix select's state, the same in every thread of the cluster:
  // the digits found so far (prefix under mask), the rank of the k-th
  // largest among the keys under them, the next digit's shift.
  unsigned prefix = 0, mask = 0, krem = (unsigned)p.top_k;
  int shift = 8 * (PASSES - 1);
  // Counts the next digit of `key` into the histogram this warp shares
  // when the key lies under the prefix.
  auto count = [&](unsigned key, bool valid) {
    if (valid && (key & mask) == prefix)
      atomicAdd(&hist[warp % HROWS][(key >> shift) & (BINS - 1)], 1u);
  };
  // One cluster step: fold the warps' histograms into the block's, add
  // its non-empty bins into every block's cluster histogram and meet;
  // then take the digit that holds the krem-th largest (an inclusive scan
  // of the counts in descending digit order; the one bin where krem
  // falls).
  auto next_digit = [&](int pass) {
    unsigned* sum = hist_sum[pass & 1];
    __syncthreads();
    if (tid < BINS) {
      unsigned c = 0;
      for (int w = 0; w < HROWS; ++w) {
        c += hist[w][tid];
        hist[w][tid] = 0;
      }
      if (c)
        for (int r = 0; r < n; ++r) red_add_cluster(sum + tid, r, c);
    }
    cluster_sync();
    unsigned c = 0, incl = 0;
    if (tid < BINS) {
      c = sum[BINS - 1 - tid];
      sum[BINS - 1 - tid] = 0;  // free for pass + 2 (after the next barrier)
      incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) scan[warp] = incl;
    }
    __syncthreads();
    if (tid < BINS) {
      for (int w = 0; w < warp; ++w) incl += scan[w];
      const unsigned above = incl - c;
      if (above < krem && krem <= incl) {
        sel[0] = BINS - 1 - tid;
        sel[1] = krem - above;
      }
    }
    __syncthreads();
    prefix |= sel[0] << shift;
    mask |= (unsigned)(BINS - 1) << shift;
    krem = sel[1];
    shift -= 8;
  };

  // z = logits / temperature in place, the block's max and, with top-k,
  // the first digit's histogram
  float m = -INFINITY;
  for (int base = 0; base < len; base += THREADS) {  // uniform trips
    const int j = base + tid;
    const bool valid = j < len;
    float z = 0.f;
    if (valid) {
      if constexpr (STAGED) {
        z = zs[j] / temp;
        zs[j] = z;  // read by other threads only after the next barrier
      } else {
        z = row[j] / temp;
      }
      m = fmaxf(m, z);
    }
    if (use_k) count(radix_key(z), valid);
  }
  m = block_max(m, redf);
  const bool use_max = use_k || p.use_top_p;  // top-p needs the row max
  cluster_wait();
  if (use_max && tid < n) *cluster.map_shared_rank(&max_part[rank], tid) = m;

  // top-k threshold: the key of the k-th largest, one digit a cluster
  // step (the first digit was counted on the way in)
  float kth = -INFINITY, zmax = -INFINITY;
  if (use_k) {
    next_digit(0);
    for (int pass = 1; pass < PASSES; ++pass) {
      for (int j = tid; j < len; j += THREADS) count(radix_key(z_at(j)), true);
      next_digit(pass);
    }
    kth = key_value(prefix);
  } else if (p.use_top_p) {
    cluster_sync();  // the max
  }
  if (use_max)
    for (int r = 0; r < n; ++r) zmax = fmaxf(zmax, max_part[r]);
  // The reference's top-k filter: z below the k-th value is masked
  // (NEG_INF). A masked entry adds 0 to the top-p sum and is dropped
  // whatever top-p says, so neither pass below evaluates exp for it.
  auto masked = [&](float z) { return use_k && z < kth; };

  // top-p: p = exp(z - max) / sum, the reference's softmax form (the top
  // slot survives top-k, so the max is zmax; masked terms are 0). The sum
  // is taken in another order than the one the cutoff came from, which
  // moves p by a few ulps; so a token is dropped only when p is below the
  // cutoff by more than TOP_P_SLACK (relative), and the top slot always
  // stays, as the reference's nucleus promises.
  float denom = 1.f, cut = 0.f;
  if (p.use_top_p) {
    float s = 0.f;
    for (int j = tid; j < len; j += THREADS) {
      const float z = z_at(j);
      if (!masked(z)) s += expf(z - zmax);
    }
    s = block_sum(s, redf);
    if (tid < n) *cluster.map_shared_rank(&sum_part[rank], tid) = s;
    cluster_sync();
    denom = 0.f;
    for (int r = 0; r < n; ++r) denom += sum_part[r];  // rank order
    cut = p.cutoff[b];
  }

  if constexpr (STAGED) {
    if (p.stage_noise) {
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  // Gumbel-argmax over the filtered z
  float best = -INFINITY;
  int arg = INT_MAX;
  for (int j = tid; j < len; j += THREADS) {
    const float z = z_at(j);
    const bool drop =
        masked(z) || (p.use_top_p && z < zmax &&
                      expf(z - zmax) / denom * (1.f + TOP_P_SLACK) < cut);
    arg_merge(best, arg, (drop ? NEG_INF : z) + ns[j], lo + j);
  }
  block_argmax(best, arg, redf, redi);
  if (tid == 0) {
    *cluster.map_shared_rank(&best_part[rank], 0) = best;
    *cluster.map_shared_rank(&arg_part[rank], 0) = arg;
  }
  cluster_sync();
  if (rank == 0 && tid == 0) {
    float v = best_part[0];
    int a = arg_part[0];
    for (int r = 1; r < n; ++r) arg_merge(v, a, best_part[r], arg_part[r]);
    p.out[b] = a;
  }
}

struct Plan {
  int per, staged, smem;
};

Plan plan(int v, int n_split) {
  const int per = (v + n_split - 1) / n_split;
  const int mode = staging(per);
  const int bytes = mode * 4 * region_floats(per);
  return {per, mode, bytes > MIN_DYN_SMEM ? bytes : MIN_DYN_SMEM};
}

// The launch configuration of one call; attrs must outlive the launch.
cudaLaunchConfig_t config(const Plan& pl, int n_split, int batch,
                          cudaStream_t stream, cudaLaunchAttribute* attrs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's dynamic shared-memory limit on the current device
// once; then checks (once per cluster size and shared-memory size) that
// at least one such cluster fits on the card.
template <bool STAGED>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int n_split) {
  static bool ready[64] = {};
  static int checked[64][MAX_SPLIT + 1] = {};  // largest smem seen to fit
  constexpr auto kernel = sample_kernel<STAGED>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYN_SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int smem = (int)cfg.dynamicSmemBytes + 1;  // 0 means unchecked
  if (checked[dev][n_split] >= smem) return cudaSuccess;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  checked[dev][n_split] = smem;
  return cudaSuccess;
}

template <bool STAGED>
int launch(const Params& p, const Plan& pl, int batch, cudaStream_t s) {
  cudaLaunchAttribute attrs[1];
  const cudaLaunchConfig_t cfg = config(pl, p.n_split, batch, s, attrs);
  cudaError_t err = prepare<STAGED>(cfg, p.n_split);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, sample_kernel<STAGED>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// logits, gumbel: (batch, v) fp32, 4-byte aligned; cutoff: (batch, 1)
// fp32; out: (batch,) int32. top_k <= 0 means no top-k; use_top_p 0
// ignores cutoff. n_split: blocks (one cluster) per row, 1 .. 8.
int fused_sample_fwd(const void* logits, const void* gumbel,
                     const void* cutoff, void* out, int batch, int v,
                     float temperature, int top_k, int use_top_p,
                     int n_split, void* stream) {
  if (batch <= 0 || batch > 65535 || v <= 0 || !(temperature > 0.f) ||
      top_k > v || n_split < 1 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(v, n_split);
  Params p{static_cast<const float*>(logits),
           static_cast<const float*>(gumbel),
           static_cast<const float*>(cutoff),
           static_cast<int*>(out),
           v,
           pl.per,
           temperature,
           top_k,
           use_top_p,
           n_split,
           pl.staged == 2};
  const auto s = static_cast<cudaStream_t>(stream);
  return pl.staged ? launch<true>(p, pl, batch, s)
                   : launch<false>(p, pl, batch, s);
}

}  // extern "C"
