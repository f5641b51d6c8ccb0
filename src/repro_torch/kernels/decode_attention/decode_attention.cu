// Ragged decode attention for Hopper (sm_90a), written by hand: one kernel
// templated over how a KV tile is addressed and read, five entry points.
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
// What bounds it on an H100 SXM (3.35 TB/s HBM3, NVIDIA's data sheet at
// the 700 W limit): decode attention does 4 * H * D FLOPs per visible
// position and must read that position's K and V rows, 4 * D * KV bytes in
// bf16 and (D + 4) * 2 * KV in int8, so it is bound by bytes. At the
// serving path's shape (B=8, H=28, KV=4, D=128, lengths 72-500: 1 898
// visible positions) that is 7.8 MB, 1.2 us a layer in bf16 and 0.6 us in
// int8. What held the earlier design far above that was not the bytes but
// its serial loop: one block per (row, kv head), 32 blocks on 132 SMs, each
// walking its row's tiles one after the other with a 128-long FMA chain a
// score.
//
// Design. The Pallas kernels run a (batch, kv_head, tile) grid whose last
// axis is sequential and keep (m, l, acc) in VMEM scratch across tiles.
// Here a (row, kv head) is worked by a thread-block CLUSTER of n_split
// blocks (grid (KV * n_split, B), cluster (n_split, 1, 1); the wrapper
// picks n_split from B * KV, the SM count and the longest range a row can
// see, at most the portable cluster size of 8):
//   * block r of the cluster takes the r-th contiguous chunk of whole
//     64-position tiles of the row's own visible range [lo, hi], so the
//     split balances whatever the capacity; a chunk past hi is empty and
//     keeps the neutral state (0, 0, -1e30), which drops out of the merge;
//   * within a block, 256 threads stream their chunk's tiles through two
//     shared-memory stages by cp.async, 16 bytes a lane (8 bf16 or 16 int8
//     values), so the next tile's copy overlaps the current tile's math.
//     Paged rows resolve each position through the table as its copy is
//     issued (rows sharing prefix pages read the same physical pages), and
//     int8 scales arrive beside the data and are applied in registers;
//   * all G query heads of the kv head are processed together, so each K/V
//     tile is read from memory once for the group. A warp takes a head:
//     each lane holds 16 bytes of q and of a K row (48 at D = 192, where a
//     row's 24 parts are split over 8 lanes), the D reduction runs across
//     D / 8 (bf16, D <= 128) lanes with warp shuffles, and the warp then runs
//     the head's online-softmax update over the tile; then every thread
//     accumulates P V for (head, 8 bytes of D) items. Eight warps rather
//     than four: with about two blocks an SM, the warps of a block are what
//     hides each other's load and shuffle latency;
//   * the merge stays inside the cluster: after cluster.sync(), the block
//     of cluster rank 0 reads the other blocks' (acc, l, m) through
//     distributed shared memory (map_shared_rank), takes M = max m, scales
//     by exp(m_r - M) and sums; the dense, int8 and paged entries divide
//     and write q's dtype, the partials entry writes (num, den, M). No
//     second launch and no global scratch. A second cluster.sync() keeps
//     every block's shared memory alive until rank 0 has read it.
// The dense and the partials entries split a row the same way and merge in
// the same order, so at one shard (offset 0, the same n_split) the
// partials state divided by torch gives the dense kernel's output bit for
// bit. Entry-specific arithmetic stays behind the PAGED / QUANT / PARTIALS
// template flags.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK_T = 64;      // positions per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;
constexpr int MAX_SPLIT = 8;     // the portable cluster size
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
  int n_split;    // blocks (one cluster) per (row, kv head)
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// lanes that share a row's dot product: the largest power of two that
// divides the row's 16-byte parts, at most a warp (a row of 24 parts, bf16
// at D = 192, takes 8 lanes of 3 parts each)
__host__ __device__ constexpr int lanes_per_row(int parts) {
  int lanes = 1;
  while (lanes < 32 && parts % (2 * lanes) == 0) lanes *= 2;
  return lanes;
}

template <typename KVT>
size_t smem_bytes(int g, int d) {
  const size_t kv_tile = (size_t)BLOCK_T * d * sizeof(KVT);
  return sizeof(float) * ((size_t)2 * g * d + (size_t)g * BLOCK_T +
                          (size_t)(MAX_SPLIT + 4) * g) +
         2 * STAGES * kv_tile + sizeof(float) * 2 * STAGES * BLOCK_T;
}

// T: q and output type; KVT: cache type (T, or int8_t with scales);
// PAGED: positions resolve through the page table; PARTIALS: one shard's
// block, unnormalised (num, den, m) out (dense, unquantized caches only).
template <typename T, typename KVT, bool PAGED, int D, bool PARTIALS>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  constexpr bool QUANT = std::is_same<KVT, int8_t>::value;
  static_assert(!PARTIALS || (!PAGED && !QUANT),
                "partials run over a dense block of q's dtype");
  static_assert(QUANT || std::is_same<KVT, T>::value,
                "a non-int8 cache has q's dtype");
  constexpr int VEC = 16 / sizeof(KVT);  // elements per 16-byte load
  static_assert(D % VEC == 0, "rows are loaded 16 bytes at a time");
  constexpr int NPART = D / VEC;         // 16-byte parts a row
  constexpr int LPP = lanes_per_row(NPART);  // lanes a row, a power of 2
  constexpr int PPL = NPART / LPP;       // parts a lane (3 at D = 192)
  constexpr int PPS = 32 / LPP;          // positions a warp step
  constexpr int STEPS = BLOCK_T / PPS;   // warp steps a tile
  constexpr int PVV = VEC / 2;           // elements of a P V item (8 bytes)
  constexpr int KV_TILE = BLOCK_T * D;   // elements of one K or V tile

  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = p.group;
  KVT* k_s = reinterpret_cast<KVT*>(smem_raw);      // [STAGES][BLOCK_T][D]
  KVT* v_s = k_s + STAGES * KV_TILE;                // [STAGES][BLOCK_T][D]
  float* ks_s = reinterpret_cast<float*>(v_s + STAGES * KV_TILE);
  float* vs_s = ks_s + STAGES * BLOCK_T;  // int8: [STAGES][BLOCK_T] scales
  float* q_s = vs_s + STAGES * BLOCK_T;   // [G][D]
  float* acc_s = q_s + G * D;             // [G][D]
  float* s_s = acc_s + G * D;             // [G][BLOCK_T] scores, then probs
  float* m_s = s_s + G * BLOCK_T;         // [G] running max
  float* l_s = m_s + G;                   // [G] running sum
  float* a_s = l_s + G;  // [G] this tile's rescale factor; rank 0's merge
                         // scratch, [MAX_SPLIT + 2][G]

  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.x / p.n_split, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long kv_stride = (long)p.KV * D;  // elements between positions
  const T* q = static_cast<const T*>(p.q) +
               ((long)b * p.H + (long)kvh * G) * D;
  // a physical row r (b * T + pos dense; page * ps + offset paged) holds
  // its KV heads' values at r * kv_stride + kvh * D and scales at
  // r * KV + kvh
  const KVT* k = static_cast<const KVT*>(p.k) + (long)kvh * D;
  const KVT* v = static_cast<const KVT*>(p.v) + (long)kvh * D;

  // visible positions of this row, local to the block: [lo, hi] (a
  // shard's partials shift the length by the block's offset; a row the
  // shard holds nothing of has hi < lo)
  const int len = p.lengths[b] - (PARTIALS ? p.offset : 0);
  const int hi = min(len, p.T - 1);
  const int lo = p.window > 0 ? max(0, len - p.window + 1) : 0;
  // this block's chunk: whole tiles [t_first, t_end) of [lo, hi]
  const int n_tiles = hi >= lo ? (hi - lo) / BLOCK_T + 1 : 0;
  const int per = (n_tiles + p.n_split - 1) / p.n_split;
  const int t_first = min(rank * per, n_tiles);
  const int t_end = min(t_first + per, n_tiles);
  const int my_tiles = t_end - t_first;

  // copies tile t of the chunk into `stage`: 16 bytes per (position, part);
  // positions past hi are not read
  auto load_tile = [&](int t, int stage) {
    const int t0 = lo + (t_first + t) * BLOCK_T;
    const int n = min(BLOCK_T, hi + 1 - t0);
    KVT* kd = k_s + stage * KV_TILE;
    KVT* vd = v_s + stage * KV_TILE;
    for (int c = tid; c < BLOCK_T * NPART; c += THREADS) {
      const int j = c / NPART, part = c % NPART;
      if (j >= n) continue;
      const int pos = t0 + j;
      long row;
      if constexpr (PAGED) {
        int page = p.table[(long)b * p.pmax + pos / p.page_size];
        page = min(max(page, 0), p.n_pages - 1);  // never out of the pool
        row = (long)page * p.page_size + pos % p.page_size;
      } else {
        row = (long)b * p.T + pos;
      }
      const long off = row * kv_stride + part * VEC;
      cp_async16(kd + j * D + part * VEC, k + off);
      cp_async16(vd + j * D + part * VEC, v + off);
      if constexpr (QUANT) {
        if (part == 0) {
          cp_async4(ks_s + stage * BLOCK_T + j, p.k_scale + row * p.KV + kvh);
          cp_async4(vs_s + stage * BLOCK_T + j, p.v_scale + row * p.KV + kvh);
        }
      }
    }
    cp_async_commit();
  };

  if (my_tiles > 0) load_tile(0, 0);
  if (my_tiles > 1) load_tile(1, 1);
  for (int i = tid; i < G * D; i += THREADS) {  // while the copies fly
    q_s[i] = to_float(q[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  for (int t = 0; t < my_tiles; ++t) {
    const int stage = t % STAGES;
    if (t + 1 < my_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // tile t landed; init and the last tile's P V done
    const int t0 = lo + (t_first + t) * BLOCK_T;
    const int n = min(BLOCK_T, hi + 1 - t0);
    const KVT* kt = k_s + stage * KV_TILE;
    const KVT* vt = v_s + stage * KV_TILE;
    const float* kst = ks_s + stage * BLOCK_T;
    const float* vst = vs_s + stage * BLOCK_T;

    // scores and the online-softmax update, one head a warp. A lane holds
    // PPL 16-byte parts of q (parts part, part + LPP, ...) and reads the
    // same parts of each of STEPS K rows; the partial dots are all formed
    // first, then reduced across the LPP lanes of a row, so neither the
    // loads nor the shuffles wait on each other.
    for (int g = warp; g < G; g += WARPS) {
      const int part = lane % LPP, grp = lane / LPP;
      float qr[PPL * VEC];
#pragma unroll
      for (int pp = 0; pp < PPL; ++pp)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          qr[pp * VEC + e] = q_s[g * D + (part + pp * LPP) * VEC + e];
      float dots[STEPS];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {  // rows past n read what is there
        const int j = st * PPS + grp;
        float dot = 0.f;
#pragma unroll
        for (int pp = 0; pp < PPL; ++pp) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kt + j * D + (part + pp * LPP) * VEC);
          const KVT* kx = reinterpret_cast<const KVT*>(&raw);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(qr[pp * VEC + e], to_float(kx[e]), dot);
        }
        dots[st] = dot;
      }
#pragma unroll
      for (int off = LPP / 2; off > 0; off >>= 1)
#pragma unroll
        for (int st = 0; st < STEPS; ++st)
          dots[st] += __shfl_xor_sync(0xffffffffu, dots[st], off);
      float* row_s = s_s + g * BLOCK_T;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {  // the LPP lanes take turns
        if (part == st % LPP) {
          const int j = st * PPS + grp;
          float s = NEG_INF;
          if (j < n) {
            float dot = dots[st];
            if constexpr (QUANT) dot *= kst[j];
            s = dot * p.scale;
            if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
          }
          row_s[j] = s;
        }
      }
      __syncwarp();
      const float x0 = row_s[lane], x1 = row_s[lane + 32];
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
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if constexpr (QUANT) {  // v's scale folds into the probability
        row_s[lane] = lane < n ? p0 * vst[lane] : 0.f;
        row_s[lane + 32] = lane + 32 < n ? p1 * vst[lane + 32] : 0.f;
      } else {
        row_s[lane] = p0;
        row_s[lane + 32] = p1;
      }
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, one (head, 8 bytes of D) item a thread
    for (int it = tid; it < G * (D / PVV); it += THREADS) {
      const int g = it / (D / PVV), d0 = (it % (D / PVV)) * PVV;
      const float* pg = s_s + g * BLOCK_T;
      float a[PVV];
      const float alpha = a_s[g];
#pragma unroll
      for (int e = 0; e < PVV; ++e) a[e] = acc_s[g * D + d0 + e] * alpha;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float pj = pg[j];
        const uint2 raw = *reinterpret_cast<const uint2*>(vt + j * D + d0);
        const KVT* vx = reinterpret_cast<const KVT*>(&raw);
#pragma unroll
        for (int e = 0; e < PVV; ++e) a[e] = fmaf(pj, to_float(vx[e]), a[e]);
      }
#pragma unroll
      for (int e = 0; e < PVV; ++e) acc_s[g * D + d0 + e] = a[e];
    }
    __syncthreads();  // stage t % STAGES and s_s are free again
    if (t + STAGES < my_tiles) load_tile(t + STAGES, stage);
  }

  // merge the cluster's states in rank 0 (every block reaches both syncs):
  // per head M = max m_r, weights w_r = exp(m_r - M) (0 for an empty
  // chunk) and den = sum w_r l_r, then num = sum w_r acc_r over 4-float
  // items, ranks in order
  cluster.sync();
  if (rank == 0) {
    float* w_s = a_s;  // [MAX_SPLIT][G] weights, then [G] den (local)
    float* den_s = w_s + MAX_SPLIT * G;
    float* mall_s = den_s + G;
    for (int g = tid; g < G; g += THREADS) {
      float m_r[MAX_SPLIT];
      float m_all = NEG_INF;
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < p.n_split) {
          m_r[r] = cluster.map_shared_rank(m_s, r)[g];
          m_all = fmaxf(m_all, m_r[r]);
        }
      }
      float den = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < p.n_split) {
          const float w = m_r[r] > NEG_INF / 2 ? expf(m_r[r] - m_all) : 0.f;
          w_s[r * G + g] = w;
          den += w * cluster.map_shared_rank(l_s, r)[g];
        }
      }
      den_s[g] = den;
      mall_s[g] = m_all;
    }
    __syncthreads();
    const long head0 = ((long)b * p.KV + kvh) * G;
    for (int i = tid * 4; i < G * D; i += THREADS * 4) {
      const int g = i / D;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r) {
        if (r < p.n_split) {
          const float w = w_s[r * G + g];
          const float4 a = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(acc_s, r) + i);
          num.x += w * a.x;
          num.y += w * a.y;
          num.z += w * a.z;
          num.w += w * a.w;
        }
      }
      const float den = den_s[g];
      if constexpr (PARTIALS) {  // nothing visible -> (0, 0, -1e30)
        *reinterpret_cast<float4*>(p.num + head0 * D + i) = num;
        if (i % D == 0) {
          p.den[head0 + g] = den;
          p.mx[head0 + g] = mall_s[g];
        }
      } else {
        T* o = static_cast<T*>(p.o) + ((long)b * p.H + (long)kvh * G) * D;
        const float x[4] = {num.x, num.y, num.z, num.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)  // nothing visible -> 0
          o[i + e] = from_float<T>(den == 0.f ? 0.f : x[e] / den);
      }
    }
  }
  cluster.sync();  // the other blocks' shared memory outlives rank 0's reads
}

// Raises the kernel's dynamic shared-memory limit on the current device
// when a launch needs more than it was last given (once per kernel and
// device, not on every launch).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

template <typename T, typename KVT, bool PAGED, int D, bool PARTIALS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<KVT>(p.group, D);
  if (smem > MAX_SMEM || p.n_split < 1 || p.n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  constexpr auto kernel = decode_kernel<T, KVT, PAGED, D, PARTIALS>;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.KV * p.n_split, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename KVT, bool PAGED, bool PARTIALS = false>
int dispatch_head_dim(const Params& p, int batch, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, KVT, PAGED, 16, PARTIALS>(p, batch, s);
    case 32: return launch<T, KVT, PAGED, 32, PARTIALS>(p, batch, s);
    case 64: return launch<T, KVT, PAGED, 64, PARTIALS>(p, batch, s);
    case 128: return launch<T, KVT, PAGED, 128, PARTIALS>(p, batch, s);
    case 192: return launch<T, KVT, PAGED, 192, PARTIALS>(p, batch, s);
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
                   int n_pages, int window, float softcap, int n_split) {
  return Params{q, k, v, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(lengths),
                static_cast<const int*>(table), o, t, h, kv, h / kv,
                page_size, pmax, n_pages, window, softcap,
                1.0f / sqrtf((float)d), n_split};
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success). is_bf16: 1 for bfloat16 q (and, unquantized, caches), 0 for
// float32. lengths: (batch,) int32, page_table: (batch, pmax) int32, both
// on the device. k and v must be 16-byte aligned. n_split: blocks of one
// cluster per (row, kv head), 1 .. 8.

int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int is_bf16,
                         int batch, int t, int h, int kv, int d, int window,
                         float softcap, int n_split, void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, nullptr, nullptr, lengths, nullptr,
                               o, t, h, kv, d, 0, 0, 0, window, softcap,
                               n_split);
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
                               int window, float softcap, int n_split,
                               void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, k_scale, v_scale, lengths, nullptr,
                               o, t, h, kv, d, 0, 0, 0, window, softcap,
                               n_split);
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
                               int window, float softcap, int n_split,
                               void* stream) {
  if (batch <= 0 || n_pages <= 0 || page_size <= 0 || pmax <= 0 ||
      kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(q, k, v, nullptr, nullptr, lengths, table, o,
                  pmax * page_size, h, kv, d, page_size, pmax, n_pages,
                  window, softcap, n_split);
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
    int kv, int d, int window, float softcap, int n_split, void* stream) {
  if (batch <= 0 || n_pages <= 0 || page_size <= 0 || pmax <= 0 ||
      kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(q, k, v, k_scale, v_scale, lengths, table, o,
                  pmax * page_size, h, kv, d, page_size, pmax, n_pages,
                  window, softcap, n_split);
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
                                  int window, float softcap, int n_split,
                                  void* stream) {
  if (batch <= 0 || t <= 0 || kv <= 0 || h % kv || misaligned(k, v))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, nullptr, nullptr, lengths, nullptr,
                         nullptr, t, h, kv, d, 0, 0, 0, window, softcap,
                         n_split);
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
