// Fused sampling epilogue for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/fused_sampling.py::
//   fused_sample_kernel (def :171, pl.pallas_call :181, body
//   _sample_kernel :142 with _topk_threshold :110)
// and computes what it computes, per row of (B, V) fp32 logits:
//   * z = logits / temperature;
//   * with top_k: the k-th largest value of z found WITHOUT a sort by the
//     reference's count-above walk (start at the row max; step down to the
//     largest value below the current threshold until at least k entries
//     clear it), so every tie at the k-th value is kept (lax.top_k's
//     threshold); then z < kth -> -1e30;
//   * with top-p: p = exp(z - max) / sum and p < cutoff[b] -> -1e30, where
//     the per-row cutoff (it needs a vocabulary sort) comes from outside;
//   * y = z + gumbel (the noise comes from outside too);
//   * the FIRST index of the max of y, as int32.
//
// Design. The Pallas kernel holds a whole (1, V) row in VMEM. A row of the
// serving path (V = 152064 fp32, 608 KB) does not fit in an SM's shared
// memory (227 KB), so here one block of 1024 threads owns one row and
// makes passes over it in device memory, each pass a strided read and one
// block reduction (warp shuffles, then one value per warp in shared
// memory); after the first pass the row sits in L2. The top-k walk (two
// block reductions per step, at most k steps) would re-read the row from
// L2 at every step, so it runs over a candidate set instead: the
// elements at or above the k-th largest of the 1024 per-thread maxima,
// gathered into shared memory (see sample_kernel). Where they do not
// fit, the walk runs over the row.
//
// One deliberate difference: the top-p test keeps a token whose p is
// below the cutoff by less than a relative TOP_P_SLACK, and always keeps
// the top slot. The cutoff comes from torch's softmax and this kernel
// sums the row in another order, so without the margin the token that
// sits exactly on the cutoff (there is always one) would flip at random.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3): the function must read
// the logits and the noise once, 2 * B * V * 4 bytes (9.7 MB at B=8), and
// does a few operations per element, so it is bound by bytes: about 3 us.
// This simple version runs only B blocks (8 of 132 SMs at B=8), with
// scalar strided loads; splitting rows over more blocks is later work.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;  // the reference's masked value
constexpr int CAND_CAP = 4096;     // top-k candidates kept in shared memory
// Relative margin of the top-p test: far above the few ulps by which two
// fp32 sums of the row in different orders differ, far below the gap
// between two distinct probabilities of bf16 logits.
constexpr float TOP_P_SLACK = 1.0f / 16384;

struct Params {
  const float* logits;
  const float* gumbel;
  const float* cutoff;  // (B, 1); read only when use_top_p
  int* out;
  int V;
  float temperature;
  int top_k;  // <= 0: no top-k
  int use_top_p;
};

// Each block-wide reduction returns the result to every thread. The first
// __syncthreads frees `red` from the previous reduction's readers.
__device__ float block_max(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[lane];  // WARPS == 32
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
  x = red[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ int block_count(int x, int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[lane];
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

__device__ int block_argmax(float v, int i, float* redv, int* redi) {
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
  v = redv[lane];
  i = redi[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
              __shfl_xor_sync(0xffffffffu, i, off));
  return i;
}

// The count-above walk over the values v(i), i < n, read through `at`:
// the smallest distinct value t with count(v >= t) >= k (every tie at the
// k-th value kept). Starts from the max `t`.
template <typename At>
__device__ float topk_walk(At at, int n, int k, float t, float* redf,
                           int* redi) {
  int c = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) c += (at(i) >= t);
  c = block_count(c, redi);
  while (c < k) {
    float t2 = -FLT_MAX;  // jnp.finfo(float32).min
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float x = at(i);
      if (x < t) t2 = fmaxf(t2, x);
    }
    t2 = block_max(t2, redf);
    if (!(t2 < t)) break;  // nothing left below t
    t = t2;
    c = 0;
    for (int i = threadIdx.x; i < n; i += THREADS) c += (at(i) >= t);
    c = block_count(c, redi);
  }
  return t;
}

__global__ void __launch_bounds__(THREADS) sample_kernel(Params p) {
  static_assert(WARPS == 32, "the second reduction stage is one warp");
  __shared__ float redf[WARPS];
  __shared__ int redi[WARPS];
  __shared__ float local_max[THREADS];
  __shared__ float cand[CAND_CAP];
  __shared__ int n_cand;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = p.logits + (long)b * p.V;
  const float* noise = p.gumbel + (long)b * p.V;
  const float temp = p.temperature;
  auto z_at = [&](int i) { return row[i] / temp; };

  float lm = -INFINITY;  // this thread's max, then the row max
#pragma unroll 4
  for (int i = tid; i < p.V; i += THREADS) lm = fmaxf(lm, z_at(i));
  local_max[tid] = lm;
  const float zmax = block_max(lm, redf);

  // top-k threshold. The k largest per-thread maxima are k elements of
  // the row, so the k-th largest element is >= the k-th largest of those
  // maxima (m_k): every element the threshold keeps is >= m_k. Elements
  // >= m_k (usually a few times k) are gathered into shared memory and
  // the walk runs there; if they do not fit, it runs over the row.
  const bool use_k = p.top_k > 0;
  float kth = -INFINITY;
  if (use_k) {
    float m_k = -FLT_MAX;
    if (p.top_k <= THREADS)
      m_k = topk_walk([&](int i) { return local_max[i]; }, THREADS,
                      p.top_k, zmax, redf, redi);
    if (tid == 0) n_cand = 0;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < p.V; i += THREADS) {
      const float z = z_at(i);
      if (z >= m_k) {
        const int slot = atomicAdd(&n_cand, 1);
        if (slot < CAND_CAP) cand[slot] = z;
      }
    }
    __syncthreads();
    const int nc = n_cand;
    kth = nc <= CAND_CAP
              ? topk_walk([&](int i) { return cand[i]; }, nc, p.top_k,
                          zmax, redf, redi)
              : topk_walk(z_at, p.V, p.top_k, zmax, redf, redi);
  }
  auto filtered = [&](int i) {
    const float z = z_at(i);
    return (use_k && z < kth) ? NEG_INF : z;
  };

  // top-p: p = exp(z - max) / sum, the reference's softmax form (the top
  // slot survives top-k, so the max is zmax). The kernel's sum is taken
  // in another order than the one the cutoff came from, which moves p by
  // a few ulps; so a token is dropped only when p is below the cutoff by
  // more than TOP_P_SLACK (relative), and the top slot always stays, as
  // the reference's nucleus promises.
  float denom = 1.f, cut = 0.f;
  if (p.use_top_p) {
    float s = 0.f;
#pragma unroll 4
    for (int i = tid; i < p.V; i += THREADS) s += expf(filtered(i) - zmax);
    denom = block_sum(s, redf);
    cut = p.cutoff[b];
  }

  float best = -INFINITY;
  int arg = 0x7fffffff;
#pragma unroll 4
  for (int i = tid; i < p.V; i += THREADS) {
    float z = filtered(i);
    if (p.use_top_p && z < zmax &&
        expf(z - zmax) / denom * (1.f + TOP_P_SLACK) < cut)
      z = NEG_INF;
    arg_merge(best, arg, z + noise[i], i);
  }
  arg = block_argmax(best, arg, redf, redi);
  if (tid == 0) p.out[b] = arg;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// logits, gumbel: (batch, v) fp32; cutoff: (batch, 1) fp32; out: (batch,)
// int32. top_k <= 0 means no top-k; use_top_p 0 ignores cutoff.
int fused_sample_fwd(const void* logits, const void* gumbel,
                     const void* cutoff, void* out, int batch, int v,
                     float temperature, int top_k, int use_top_p,
                     void* stream) {
  if (batch <= 0 || v <= 0 || !(temperature > 0.f) || top_k > v)
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(logits),
           static_cast<const float*>(gumbel),
           static_cast<const float*>(cutoff), static_cast<int*>(out), v,
           temperature, top_k, use_top_p};
  sample_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
