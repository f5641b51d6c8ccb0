// Ragged decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py::
//   decode_attention_kernel (def :202, pl.pallas_call :242, body _kernel
//   :106 with _tile_update :43 and _clamp_tile :95)
// and computes what it computes, with the same semantics:
//   * q (B,H,D), k/v caches (B,T,KV,D), lengths (B,) int32, all contiguous;
//     query head h reads kv head h / G, G = H / KV;
//   * row b attends positions j <= lengths[b], and j > lengths[b] - window
//     when a window is set; a length at or past T sees every position
//     (what the reference's clamped cache write leaves behind);
//   * s = (q . k) / sqrt(D), then softcap * tanh(s / softcap) when a cap is
//     set; an fp32 online softmax (running max, running sum, accumulator);
//   * a row with no visible position writes 0 (cannot happen in decode,
//     where the new token is always visible); output in q's dtype.
//
// Design. The Pallas kernel runs a (batch, kv_head, tile) grid whose last
// axis is sequential, keeps (m, l, acc) in VMEM scratch across tiles, and
// clamps the tile index at the row's last valid tile so dead tiles cost no
// DMA. Here one thread block owns one (batch row, kv head) and loops over
// 64-position tiles of its own row from the first visible one to
// min(lengths[b], T - 1): the loop bound is the per-row early exit that
// _clamp_tile gives on the TPU. All G query heads of the kv head are
// processed together, so each K/V tile is read from memory once for the
// whole group (GQA as rows, as the MXU does it); G need not be a power of
// two (qwen2: 7). 128 threads: each tile is loaded 16 bytes a thread at a
// time, all loads of the tile in flight together, and staged as fp32 in
// shared memory (K as [64][D+1], padded against bank conflicts; V as
// [64][D]); scores are spread over (head, position) pairs; each warp runs
// the online-softmax update of some heads with shuffles; the accumulator
// [G][D] lives in shared memory, each entry owned by one thread.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3, 67 TFLOP/s fp32 FMA):
// decode attention does 4 * H * D FLOPs per visible position and must read
// 2 * KV * D cache elements per visible position, so it is bound by bytes
// (one FLOP per byte in bf16). At the serving path's shape (B=8, H=28,
// KV=4, D=128, bf16, a few hundred visible positions a row) that is about
// 2 us a layer. This simple version launches only B * KV blocks (32 at
// B=8 on 132 SMs), does not overlap a tile's loads with the previous
// tile's arithmetic (no cp.async/TMA double buffering), and runs on the
// CUDA cores in fp32; splitting the sequence over more blocks (the
// partials kernel's (num, den, m) merge) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BLOCK_T = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // per block on sm_90

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  int T, H, KV, group;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no cap
  float scale;    // 1 / sqrt(D)
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

size_t smem_bytes(int g, int d) {
  return sizeof(float) * ((size_t)2 * g * d + BLOCK_T * (d + 1) +
                          BLOCK_T * d + g * BLOCK_T + 3 * g);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  static_assert(BLOCK_T == 64, "the softmax step gives each lane 2 columns");
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static_assert(D % VEC == 0, "rows are loaded 16 bytes at a time");
  constexpr int DV = D / VEC;
  constexpr int LOAD_ROUNDS = (BLOCK_T * DV + THREADS - 1) / THREADS;
  extern __shared__ float smem[];
  const int G = p.group;
  float* q_s = smem;                     // [G][D]
  float* k_s = q_s + G * D;              // [BLOCK_T][D + 1]
  float* v_s = k_s + BLOCK_T * (D + 1);  // [BLOCK_T][D]
  float* s_s = v_s + BLOCK_T * D;        // [G][BLOCK_T] scores, then probs
  float* acc_s = s_s + G * BLOCK_T;      // [G][D]
  float* m_s = acc_s + G * D;            // [G] running max
  float* l_s = m_s + G;                  // [G] running sum
  float* a_s = l_s + G;                  // [G] this tile's rescale factor

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long kv_stride = (long)p.KV * D;  // elements between positions
  const T* q = static_cast<const T*>(p.q) +
               ((long)b * p.H + (long)kvh * G) * D;
  const T* k = static_cast<const T*>(p.k) + (long)b * p.T * kv_stride +
               (long)kvh * D;
  const T* v = static_cast<const T*>(p.v) + (long)b * p.T * kv_stride +
               (long)kvh * D;
  T* o = static_cast<T*>(p.o) + ((long)b * p.H + (long)kvh * G) * D;

  // visible positions of this row: [lo, hi]
  const int len = p.lengths[b];
  const int hi = min(len, p.T - 1);
  const int lo = p.window > 0 ? max(0, len - p.window + 1) : 0;

  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_float(q[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  for (int t0 = (lo / BLOCK_T) * BLOCK_T; lo <= hi && t0 <= hi;
       t0 += BLOCK_T) {
    __syncthreads();  // init is visible; the last tile is fully consumed
    const int n = min(BLOCK_T, hi + 1 - t0);  // positions of this tile <= hi
#pragma unroll
    for (int r = 0; r < LOAD_ROUNDS; ++r) {  // 16-byte loads, all in flight
      const int i = tid + r * THREADS;
      if (i < BLOCK_T * DV) {
        const int j = i / DV, d0 = (i % DV) * VEC;
        uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;
        if (j < n) {
          const long off = (long)(t0 + j) * kv_stride + d0;
          kraw = *reinterpret_cast<const uint4*>(k + off);
          vraw = *reinterpret_cast<const uint4*>(v + off);
        }
        const T* kx = reinterpret_cast<const T*>(&kraw);
        const T* vx = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[j * (D + 1) + d0 + e] = to_float(kx[e]);
          v_s[j * D + d0 + e] = to_float(vx[e]);
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BLOCK_T; i += THREADS) {
      const int g = i / BLOCK_T, j = i % BLOCK_T;
      const int pos = t0 + j;
      float s = NEG_INF;
      if (pos >= lo && pos <= hi) {
        const float* qg = q_s + g * D;
        const float* kj = k_s + j * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kj[d], dot);
        s = dot * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* row = s_s + g * BLOCK_T;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      // nothing visible so far: m_new stays NEG_INF and exp(0) = 1; kill it
      const bool alive = m_new > NEG_INF / 2;
      const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
      const float p0 = alive ? expf(x0 - m_new) : 0.f;
      const float p1 = alive ? expf(x1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pg = s_s + g * BLOCK_T;
      float a = acc_s[i] * a_s[g];
#pragma unroll 8
      for (int j = 0; j < BLOCK_T; ++j) a = fmaf(pg[j], v_s[j * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += THREADS) {
    const float l = l_s[i / D];
    o[i] = from_float<T>(l == 0.f ? 0.f : acc_s[i] / l);  // nothing -> 0
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.group, D);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.KV, batch);
  decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
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

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bfloat16 tensors, 0 for float32. lengths: (batch,) int32
// on the device. k and v must be 16-byte aligned.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int is_bf16,
                         int batch, int t, int h, int kv, int d, int window,
                         float softcap, void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv ||
      (reinterpret_cast<size_t>(k) | reinterpret_cast<size_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int*>(lengths), o, t, h, kv, h / kv,
           window, softcap, 1.0f / sqrtf((float)d)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_head_dim<__nv_bfloat16>(p, batch, d, st)
                 : dispatch_head_dim<float>(p, batch, d, st);
}

}  // extern "C"
