// Fused forward attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
//   (def :83, pl.pallas_call :105, body _kernel :29)
// and computes what its body computes, with the same semantics:
//   * q (B,S,H,D), k/v (B,T,KV,D), all contiguous; GQA kv_head = h / (H/KV);
//   * s = (q . k) / sqrt(D), then softcap * tanh(s / softcap) when a cap is
//     set, then the masks from global row/column positions:
//     cols < t_valid, causal cols <= rows, window cols > rows - window;
//   * an fp32 online softmax (running max, running sum, accumulator);
//   * a row with no visible key writes 0; the output has q's dtype.
//
// Design. The Pallas kernel walks k-blocks on a sequential grid axis and
// keeps the running state in VMEM scratch between grid steps. Hopper has no
// sequential grid axis, so here each thread block owns one
// (batch, head, 64-row q tile) and loops over the 64-column k tiles itself,
// holding the running max/sum/accumulator in registers. k tiles that no row
// of the q tile can see (past t_valid, above the causal diagonal, before the
// window) are skipped; the Pallas kernel runs them masked, which adds
// nothing to the sums. 256 threads form a 16x16 grid: thread (ty, tx) owns
// rows ty + 16i (i < 4) of the tile, columns tx + 16j (j < 4) of each score
// tile and output columns tx + 16c (c < D/16). q and k tiles sit transposed
// in shared memory as fp32 ([D][65], padded against bank conflicts), v as
// [64][D], and the probabilities of one k tile as [64][80] (the pad puts the
// two half-warps on disjoint banks). Both products run as fp32 FMA on the
// CUDA cores; row max and row sum reduce over the 16 lanes of a row with
// warp shuffles.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM3):
// at the main path's shape (B=32, S=T=512, H=12, D=64, bf16, bidirectional)
// the call does 4*B*H*S*T*D = 25.8 GFLOP (26.1 us at the tensor-core peak)
// and must move q, k, v and o once: 4 * 25.2 MB = 100.7 MB (30.0 us at the
// memory peak). So the least time is about 30 us, bound by bytes.
//
// What this simple design leaves on the table: both products run on the
// CUDA cores in fp32 (67 TFLOP/s peak, so at least 385 us for the FLOPs)
// instead of wgmma on the tensor cores; tiles are loaded element by element
// with no cp.async/TMA double buffering, so loads do not overlap compute;
// and each k/v tile is fetched once per q tile (8 times per head at S=512),
// mostly from L2. A faster version is work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;
constexpr int ROWS = BLOCK_Q / 16;   // q rows per thread
constexpr int COLS = BLOCK_K / 16;   // score columns per thread
constexpr int QK_STRIDE = BLOCK_Q + 1;
constexpr int P_STRIDE = BLOCK_K + 16;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KV;  // S % BLOCK_Q == 0, T % BLOCK_K == 0 (the wrapper pads)
  int group;        // H / KV
  int t_valid;      // columns >= t_valid are padding
  int causal;
  int window;       // <= 0: no window
  float softcap;    // <= 0: no cap
  float scale;      // 1 / sqrt(D)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (2 * d * QK_STRIDE + BLOCK_K * d + BLOCK_Q * P_STRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_t = smem;                    // [D][QK_STRIDE]
  float* k_t = q_t + D * QK_STRIDE;     // [D][QK_STRIDE]
  float* v_s = k_t + D * QK_STRIDE;     // [BLOCK_K][D]
  float* p_s = v_s + BLOCK_K * D;       // [BLOCK_Q][P_STRIDE]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long q_stride = (long)p.H * D;    // elements between q rows
  const long kv_stride = (long)p.KV * D;  // elements between k/v rows
  const int row0 = qt * BLOCK_Q;

  const T* q = static_cast<const T*>(p.q) +
               ((long)b * p.S + row0) * q_stride + (long)h * D;
  const T* k = static_cast<const T*>(p.k) +
               (long)b * p.T * kv_stride + (long)kvh * D;
  const T* v = static_cast<const T*>(p.v) +
               (long)b * p.T * kv_stride + (long)kvh * D;
  T* o = static_cast<T*>(p.o) + ((long)b * p.S + row0) * q_stride +
         (long)h * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, d = i % D;
    q_t[d * QK_STRIDE + r] = to_float(q[r * q_stride + d]);
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // k columns any row of this tile can see: [col_lo, col_hi)
  int col_hi = p.t_valid;
  if (p.causal) col_hi = min(col_hi, row0 + BLOCK_Q);
  int col_lo = 0;
  if (p.window > 0) col_lo = max(0, row0 - p.window + 1);
  const int kt_lo = col_lo / BLOCK_K;
  const int kt_hi = col_hi > 0 ? (col_hi + BLOCK_K - 1) / BLOCK_K : 0;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // q_t is written; the last tile's k_t/v_s/p_s are read
    const long kbase = (long)kt * BLOCK_K * kv_stride;
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int c = i / D, d = i % D;
      k_t[d * QK_STRIDE + c] = to_float(k[kbase + c * kv_stride + d]);
      v_s[c * D + d] = to_float(v[kbase + c * kv_stride + d]);
    }
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = q_t[d * QK_STRIDE + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = k_t[d * QK_STRIDE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = kt * BLOCK_K + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool visible = col < p.t_valid;
        if (p.causal) visible = visible && col <= row;
        if (p.window > 0) visible = visible && col > row - p.window;
        s[i][j] = visible ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row are lanes (ty % 2) * 16 + 0..15 of the warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // fully-masked so far: m_new stays NEG_INF and exp(0) = 1; kill those
      const bool alive = m_new > NEG_INF / 2;
      const float alpha = m[i] > NEG_INF / 2 ? expf(m[i] - m_new) : 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float pj = alive ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * P_STRIDE + tx + 16 * j] = pj;
        rsum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BLOCK_K; ++c) {
      float pv[ROWS], vv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = p_s[(ty + 16 * i) * P_STRIDE + c];
#pragma unroll
      for (int e = 0; e < DC; ++e) vv[e] = v_s[c * D + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float denom = l[i] == 0.f ? 1.f : l[i];  // no visible key -> 0
    const long r = ty + 16 * i;
#pragma unroll
    for (int e = 0; e < DC; ++e)
      o[r * q_stride + tx + 16 * e] = from_float<T>(acc[i][e] / denom);
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.S / BLOCK_Q, p.H, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, s);
    case 32: return launch<T, 32>(p, batch, s);
    case 64: return launch<T, 64>(p, batch, s);
    case 128: return launch<T, 128>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows of q per block and columns of k per tile: S and T must be padded to
// multiples of these.
int flash_attention_block_q() { return BLOCK_Q; }
int flash_attention_block_k() { return BLOCK_K; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bfloat16 tensors, 0 for float32.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int is_bf16, int batch, int s, int t, int h, int kv,
                        int d, int t_valid, int causal, int window,
                        float softcap, void* stream) {
  if (s % BLOCK_Q || t % BLOCK_K || kv <= 0 || h % kv)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, s, t, h, kv, h / kv, t_valid, causal, window, softcap,
           1.0f / sqrtf((float)d)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_head_dim<__nv_bfloat16>(p, batch, d, st)
                 : dispatch_head_dim<float>(p, batch, d, st);
}

}  // extern "C"
