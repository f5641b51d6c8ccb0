// Ragged decode attention for Hopper (sm_90a), written by hand: one kernel
// templated over how a KV tile is addressed and read, four entry points.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention/
// decode_attention.py (body _kernel :106 with _tile_update :43 and
// _clamp_tile :95; the variants delegate to it, as these do here):
//   * decode_attention_fwd             <- decode_attention_kernel
//     (def :202, pl.pallas_call :242): dense caches (B,T,KV,D);
//   * decode_attention_quant_fwd       <- decode_attention_quant_kernel
//     (def :257, pl.pallas_call :302, body _kernel_quant :150, dequant in
//     _tile_update :61-63): int8 caches with fp32 scales (B,T,KV,1);
//   * paged_decode_attention_fwd       <- paged_decode_attention_kernel
//     (def :388, pl.pallas_call :442, body _kernel_paged :184): a shared
//     pool (P,ps,KV,D) read through a page table (B,Pmax) int32;
//   * paged_decode_attention_quant_fwd <- paged_decode_attention_quant_kernel
//     (def :457, pl.pallas_call :503, body _kernel_paged_quant :175): int8
//     pools with fp32 scale pools (P,ps,KV,1) through the same table;
//   * decode_attention_partials_fwd    <- decode_attention_partials_kernel
//     (def :317, pl.pallas_call :369, body _kernel_partials :124): one
//     sequence shard's block (B,Sl,KV,D) whose local position t is the
//     global position offset + t (row b sees t <= lengths[b] - offset,
//     and t > lengths[b] - offset - window when a window is set); it
//     writes the UNNORMALISED fp32 online-softmax state num (B,KV,G,D),
//     den (B,KV,G) and m (B,KV,G) that dist/collectives.py merges across
//     shards. A row with no local position writes the neutral
//     (0, 0, -1e30).
// They compute what the reference computes, with the same semantics:
//   * q (B,H,D) and out in bf16 or fp32; every input contiguous; query head
//     h reads kv head h / G, G = H / KV (G need not be a power of two);
//   * row b attends LOGICAL positions j <= lengths[b], and
//     j > lengths[b] - window when a window is set; a length at or past
//     the capacity (T, or Pmax * ps when paged) sees every position (what
//     the reference's clamped cache write leaves behind);
//   * int8: k = float(k_int8) * k_scale[position, kv head], the same for v;
//   * paged: logical position j of row b lives at offset j % ps of
//     physical page table[b, j / ps];
//   * s = (q . k) / sqrt(D), then softcap * tanh(s / softcap) when a cap is
//     set; an fp32 online softmax (running max, running sum, accumulator);
//   * a row with no visible position writes 0; output in q's dtype (the
//     partials entry writes its fp32 state instead, unnormalised).
//
// Design. The Pallas kernels run a (batch, kv_head, tile) grid whose last
// axis is sequential, keep (m, l, acc) in VMEM scratch across tiles, and
// clamp the tile index at the row's last valid tile so dead tiles cost no
// DMA; the paged ones make a tile one page and resolve it through the
// scalar-prefetched table in the index map. Here one thread block owns one
// (batch row, kv head) and loops over 64-position tiles of its own row from
// the first visible one to min(lengths[b], capacity - 1): the loop bound is
// the per-row early exit that _clamp_tile gives on the TPU. The tile stays
// 64 positions whatever the page size (a tile of one page would be 16
// positions at the serving default, and the loads would shrink with it):
// before each tile, the block resolves every position's physical row
// (table[b, pos / ps], pos % ps) and, for int8, its two scales into shared
// memory. A position's D values are contiguous within a (page, offset, kv
// head), so the 16-byte loads stay as they are; rows sharing prefix pages
// read the same physical pages. All G query heads of the kv head are
// processed together, so each K/V tile is read from memory once for the
// whole group (GQA as rows, as the MXU does it). 128 threads: each tile is
// loaded 16 bytes a thread at a time (8 bf16 or 16 int8 values), all loads
// of the tile in flight together, dequantized in registers and staged as
// fp32 in shared memory (K as [64][D+1], padded against bank conflicts; V
// as [64][D]); scores are spread over (head, position) pairs; each warp
// runs the online-softmax update of some heads with shuffles; the
// accumulator [G][D] lives in shared memory, each entry owned by one
// thread.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3, 67 TFLOP/s fp32 FMA):
// decode attention does 4 * H * D FLOPs per visible position and must read
// its K and V rows: 4 * D * KV bytes per visible position in bf16,
// (D + 4) * 2 * KV in int8 (0.516x at D = 128), so it is bound by bytes.
// At the serving path's shape (B=8, H=28, KV=4, D=128, a few hundred
// visible positions a row) that is about 1.2 us a layer in bf16 and 0.6 us
// in int8. This simple version launches only B * KV blocks (32 at B=8 on
// 132 SMs), does not overlap a tile's loads with the previous tile's
// arithmetic (no cp.async/TMA double buffering), and runs on the CUDA
// cores in fp32; splitting the sequence over more blocks (the partials
// kernel's (num, den, m) merge) is later work. The partials entry is the
// dense bf16/fp32 loop with the lengths shifted by the shard's offset and
// the state written out, so at one shard it does the dense kernel's
// arithmetic bit for bit; its bound is the shard's visible K/V plus the
// fp32 outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BLOCK_T = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // per block on sm_90

struct Params {
  const void* q;
  const void* k;        // caches (B,T,KV,D) or pools (P,ps,KV,D)
  const void* v;
  const float* k_scale;  // int8: (B,T,KV,1) or (P,ps,KV,1); else null
  const float* v_scale;
  const int* lengths;
  const int* table;  // paged: (B,Pmax); else null
  void* o;
  int T;  // logical capacity of a row: T, or Pmax * ps when paged
  int H, KV, group;
  int page_size, pmax, n_pages;  // paged only
  int window;     // <= 0: no window
  float softcap;  // <= 0: no cap
  float scale;    // 1 / sqrt(D)
  // partials only: the block's first global position; fp32 outputs
  int offset = 0;
  float* num = nullptr;  // (B,KV,G,D)
  float* den = nullptr;  // (B,KV,G)
  float* mx = nullptr;   // (B,KV,G)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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
                          BLOCK_T * d + g * BLOCK_T + 3 * g + 3 * BLOCK_T);
}

// T: q and output type; KVT: cache type (T, or int8_t with scales);
// PAGED: positions resolve through the page table; PARTIALS: one shard's
// block, unnormalised (num, den, m) out (dense, unquantized caches only).
template <typename T, typename KVT, bool PAGED, int D, bool PARTIALS>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  static_assert(BLOCK_T == 64, "the softmax step gives each lane 2 columns");
  constexpr bool QUANT = std::is_same<KVT, int8_t>::value;
  static_assert(!PARTIALS || (!PAGED && !QUANT),
                "partials run over a dense block of q's dtype");
  static_assert(QUANT || std::is_same<KVT, T>::value,
                "a non-int8 cache has q's dtype");
  constexpr bool RESOLVE = PAGED || QUANT;  // per-tile row/scale prelude
  constexpr int VEC = 16 / sizeof(KVT);  // elements per 16-byte load
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
  int* row_s = reinterpret_cast<int*>(a_s + G);  // [BLOCK_T] physical rows
  float* ks_s = a_s + G + BLOCK_T;       // [BLOCK_T] int8: k scales
  float* vs_s = ks_s + BLOCK_T;          // [BLOCK_T] int8: v scales

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long kv_stride = (long)p.KV * D;  // elements between positions
  const T* q = static_cast<const T*>(p.q) +
               ((long)b * p.H + (long)kvh * G) * D;
  // a physical row r (b * T + pos dense; page * ps + offset paged) holds
  // its KV heads' values at r * kv_stride + kvh * D and scales at
  // r * KV + kvh
  const KVT* k = static_cast<const KVT*>(p.k) + (long)kvh * D;
  const KVT* v = static_cast<const KVT*>(p.v) + (long)kvh * D;
  T* o = static_cast<T*>(p.o) + ((long)b * p.H + (long)kvh * G) * D;

  // visible positions of this row, local to the block: [lo, hi] (a
  // shard's partials shift the length by the block's offset; a row the
  // shard holds nothing of has hi < lo and runs no tile)
  const int len = p.lengths[b] - (PARTIALS ? p.offset : 0);
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
    if constexpr (RESOLVE) {  // physical rows (and scales) of the tile
      if (tid < n) {
        const int pos = t0 + tid;
        int r;
        if constexpr (PAGED) {
          int page = p.table[(long)b * p.pmax + pos / p.page_size];
          page = min(max(page, 0), p.n_pages - 1);  // never out of the pool
          r = page * p.page_size + pos % p.page_size;
        } else {
          r = b * p.T + pos;
        }
        row_s[tid] = r;
        if constexpr (QUANT) {
          ks_s[tid] = p.k_scale[(long)r * p.KV + kvh];
          vs_s[tid] = p.v_scale[(long)r * p.KV + kvh];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < LOAD_ROUNDS; ++r) {  // 16-byte loads, all in flight
      const int i = tid + r * THREADS;
      if (i < BLOCK_T * DV) {
        const int j = i / DV, d0 = (i % DV) * VEC;
        uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;
        if (j < n) {
          long row;
          if constexpr (RESOLVE) {
            row = row_s[j];
          } else {
            row = (long)b * p.T + t0 + j;
          }
          const long off = row * kv_stride + d0;
          kraw = *reinterpret_cast<const uint4*>(k + off);
          vraw = *reinterpret_cast<const uint4*>(v + off);
        }
        const KVT* kx = reinterpret_cast<const KVT*>(&kraw);
        const KVT* vx = reinterpret_cast<const KVT*>(&vraw);
        if constexpr (QUANT) {  // dequantize: float(int8) * scale
          const float ksc = j < n ? ks_s[j] : 0.f;
          const float vsc = j < n ? vs_s[j] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            k_s[j * (D + 1) + d0 + e] = to_float(kx[e]) * ksc;
            v_s[j * D + d0 + e] = to_float(vx[e]) * vsc;
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            k_s[j * (D + 1) + d0 + e] = to_float(kx[e]);
            v_s[j * D + d0 + e] = to_float(vx[e]);
          }
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

  if constexpr (PARTIALS) {  // the state as it stands: nothing -> (0,0,-1e30)
    const long head0 = ((long)b * p.KV + kvh) * G;
    for (int i = tid; i < G * D; i += THREADS) p.num[head0 * D + i] = acc_s[i];
    for (int g = tid; g < G; g += THREADS) {
      p.den[head0 + g] = l_s[g];
      p.mx[head0 + g] = m_s[g];
    }
  } else {
    for (int i = tid; i < G * D; i += THREADS) {
      const float l = l_s[i / D];
      o[i] = from_float<T>(l == 0.f ? 0.f : acc_s[i] / l);  // nothing -> 0
    }
  }
}

template <typename T, typename KVT, bool PAGED, int D, bool PARTIALS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.group, D);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, KVT, PAGED, D, PARTIALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.KV, batch);
  decode_kernel<T, KVT, PAGED, D, PARTIALS><<<grid, THREADS, smem, stream>>>(
      p);
  return (int)cudaGetLastError();
}

template <typename T, typename KVT, bool PAGED, bool PARTIALS = false>
int dispatch_head_dim(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, KVT, PAGED, 16, PARTIALS>(p, batch, s);
    case 32: return launch<T, KVT, PAGED, 32, PARTIALS>(p, batch, s);
    case 64: return launch<T, KVT, PAGED, 64, PARTIALS>(p, batch, s);
    case 128: return launch<T, KVT, PAGED, 128, PARTIALS>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool misaligned(const void* a, const void* b) {
  return (reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b)) % 16;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* lengths, const void* table, void* o, int t,
                   int h, int kv, int d, int page_size, int pmax,
                   int n_pages, int window, float softcap) {
  return Params{q, k, v, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(lengths),
                static_cast<const int*>(table), o, t, h, kv, h / kv,
                page_size, pmax, n_pages, window, softcap,
                1.0f / sqrtf((float)d)};
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success). is_bf16: 1 for bfloat16 q (and, unquantized, caches), 0 for
// float32. lengths: (batch,) int32, page_table: (batch, pmax) int32, both
// on the device. k and v must be 16-byte aligned.

int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int is_bf16,
                         int batch, int t, int h, int kv, int d, int window,
                         float softcap, void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, nullptr, nullptr, lengths, nullptr,
                               o, t, h, kv, d, 0, 0, 0, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, false>(
                   p, batch, d, st)
             : dispatch_head_dim<float, float, false>(p, batch, d, st);
}

// k, v: int8 (batch, t, kv, d); k_scale, v_scale: float32 (batch, t, kv, 1).
int decode_attention_quant_fwd(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* lengths, void* o, int is_bf16,
                               int batch, int t, int h, int kv, int d,
                               int window, float softcap, void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, k_scale, v_scale, lengths, nullptr,
                               o, t, h, kv, d, 0, 0, 0, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16, int8_t, false>(p, batch, d,
                                                                st)
             : dispatch_head_dim<float, int8_t, false>(p, batch, d, st);
}

// k, v: pools (n_pages, page_size, kv, d) of q's dtype.
int paged_decode_attention_fwd(const void* q, const void* k, const void* v,
                               const void* lengths, const void* table,
                               void* o, int is_bf16, int batch, int n_pages,
                               int page_size, int pmax, int h, int kv, int d,
                               int window, float softcap, void* stream) {
  if (batch <= 0 || n_pages <= 0 || page_size <= 0 || pmax <= 0 ||
      kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(q, k, v, nullptr, nullptr, lengths, table, o,
                  pmax * page_size, h, kv, d, page_size, pmax, n_pages,
                  window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, true>(
                   p, batch, d, st)
             : dispatch_head_dim<float, float, true>(p, batch, d, st);
}

// k, v: int8 pools (n_pages, page_size, kv, d); k_scale, v_scale: float32
// pools (n_pages, page_size, kv, 1).
int paged_decode_attention_quant_fwd(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, const void* table, void* o,
    int is_bf16, int batch, int n_pages, int page_size, int pmax, int h,
    int kv, int d, int window, float softcap, void* stream) {
  if (batch <= 0 || n_pages <= 0 || page_size <= 0 || pmax <= 0 ||
      kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(q, k, v, k_scale, v_scale, lengths, table, o,
                  pmax * page_size, h, kv, d, page_size, pmax, n_pages,
                  window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16, int8_t, true>(p, batch, d,
                                                               st)
             : dispatch_head_dim<float, int8_t, true>(p, batch, d, st);
}

// One sequence shard's block: k, v (batch, t, kv, d) of q's dtype whose
// local position 0 is global position `offset`; lengths (batch,) int32
// global; num (batch, kv, h / kv, d), den and m (batch, kv, h / kv)
// float32, written unnormalised.
int decode_attention_partials_fwd(const void* q, const void* k, const void* v,
                                  const void* lengths, void* num, void* den,
                                  void* m, int is_bf16, int batch, int t,
                                  int h, int kv, int d, int offset,
                                  int window, float softcap, void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, nullptr, nullptr, lengths, nullptr,
                         nullptr, t, h, kv, d, 0, 0, 0, window, softcap);
  p.offset = offset;
  p.num = static_cast<float*>(num);
  p.den = static_cast<float*>(den);
  p.mx = static_cast<float*>(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16, __nv_bfloat16, false, true>(
                   p, batch, d, st)
             : dispatch_head_dim<float, float, false, true>(p, batch, d, st);
}

}  // extern "C"
