// Fused forward attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel flash_attention_kernel of
//   src/repro/kernels/flash_attention/flash_attention.py
//   (def :87, pl.pallas_call :105, body _kernel :29)
// and computes what its body computes, with the same semantics:
//   * q (B,S,H,D), k/v (B,T,KV,D), all contiguous; GQA kv_head = h / (H/KV);
//   * s = (q . k) / sqrt(D), then softcap * tanh(s / softcap) when a cap is
//     set, then the masks from global row/column positions:
//     cols < t_valid, causal cols <= rows, window cols > rows - window;
//   * an fp32 online softmax (running max, running sum, accumulator);
//   * a row with no visible key writes 0; the output has q's dtype;
//   * k tiles that no row of a q tile can see (past t_valid, above the
//     causal diagonal, before the window) are skipped; the Pallas kernel
//     runs them masked, which adds nothing to the sums.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
// NVIDIA's data sheet at the 700 W limit):
//   * the offline main path (B=32, S=T=512, H=12, D=64, bf16,
//     bidirectional) does 4*B*H*S*T*D = 25.8 GFLOP (26.1 us at the tensor
//     cores' peak) and must move q, k, v and o once: 100.7 MB (30.0 us);
//     on the CUDA cores' 67 TFLOP/s fp32 FMA the FLOPs alone take 385 us;
//   * a qwen2-7b prefill admission (q (1,512,28,128), k/v (1,512,4,128),
//     causal, GQA 7) does 4*H*D*131328 visible pairs = 1.88 GFLOP (1.9 us)
//     and moves 8.4 MB (2.5 us).
// Both are bound by bytes once the products run on the tensor cores.
//
// Design, bf16 (the path every model takes): the products run on wgmma,
// fed by TMA.
//   * One block owns one (batch, head, q tile). NWG warpgroups own 64 q
//     rows each.
//   * Thread 0 loads the block's Q once and the first K/V tiles; the
//     visible 64-key tiles of K and V then stream through a ring of
//     STAGES = 2 shared-memory stages. Each stage has a "full" mbarrier
//     (TMA's byte count completes it) and an "empty" one (each warp arrives
//     once it has read the stage); warp 0 waits for "empty" and refills
//     the stage with the tile two ahead, so the copy of tile i+1 overlaps
//     the arithmetic on tile i. There is no producer warp: its registers
//     go to the warpgroups (below).
//   * The tensor maps (made on the host, passed as __grid_constant__
//     parameters) view q as (B, S, H*D) and k/v as (B, T, KV*D); a box is
//     64 rows of min(D, 64) columns with the swizzle of that width (128 B
//     for D >= 64, so D = 128 is two boxes). TMA writes exactly the
//     swizzled layout wgmma's shared-memory descriptors read, and zero-fills
//     rows past S or T: a ragged S or T needs no padding copy.
//   * S = Q K^T is wgmma m64n64k16 with Q and K both from shared memory
//     (K-major, 16 columns of D a step). The fp32 accumulator stays in
//     registers; the mask (t_valid, causal, window: only on tiles that cross
//     a boundary) and the softcap are applied per fragment element from its
//     row and column, and the online softmax (ex2.approx.ftz with the
//     scale folded in) reduces a row over the four lanes that hold it.
//   * P is rounded to bf16 in registers and fed back as wgmma's A operand
//     from registers (the accumulator fragment of S is the A fragment of
//     P V), with V from shared memory as a transposed (MN-major) B:
//     O += P V is m64nDk16, 4 steps a tile. D = 16, 32, 64, 128 and 192
//     all run this body. At D = 192 (nemotron-4-340b) a tile is three
//     64-column boxes: shared memory is 1 KB + NWG x 24 KB of Q + 2 x 2 x
//     24 KB of K/V (145 KB at NWG = 2), and O takes 96 fp32 registers a
//     thread beside S's 32, so one block an SM, as at D = 128.
//   * Each warpgroup runs S, softmax and P V of a tile in turn; what
//     overlaps is the copies (the ring) and the other warpgroups on the SM.
//     So the kernel wants many warpgroups an SM: at D <= 64 two 256-thread
//     blocks share an SM, at up to 128 registers a thread (fewer make ptxas
//     serialize the wgmma chain, and a producer warp would cost the
//     blocks 16 of them); at D = 128 one block does.
//   * Filling the card: with 128-row tiles (NWG = 2) the main path has
//     4 * 12 * 32 = 1536 blocks; a qwen2-7b prefill admission would have
//     only 4 * 28 = 112 on 132 SMs, so when 128-row tiles give fewer than
//     two blocks an SM the kernel runs 64-row tiles (NWG = 1, 224 blocks
//     there). Causal q tiles are launched heaviest first.
//
// fp32 inputs keep the earlier CUDA-core body (flash_fwd_fma_kernel):
// wgmma takes bf16 operands, which cannot meet the fp32 tolerance (2e-5).
// There a 256-thread block owns a 64-row q tile and loops over 64-key
// tiles staged as fp32 in shared memory; S and T are padded by the wrapper
// to multiples of 64.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

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

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (2 * d * QK_STRIDE + BLOCK_K * d + BLOCK_Q * P_STRIDE);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_fma_kernel(Params p) {
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

  const float* q = static_cast<const float*>(p.q) +
               ((long)b * p.S + row0) * q_stride + (long)h * D;
  const float* k = static_cast<const float*>(p.k) +
               (long)b * p.T * kv_stride + (long)kvh * D;
  const float* v = static_cast<const float*>(p.v) +
               (long)b * p.T * kv_stride + (long)kvh * D;
  float* o = static_cast<float*>(p.o) + ((long)b * p.S + row0) * q_stride +
         (long)h * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, d = i % D;
    q_t[d * QK_STRIDE + r] = q[r * q_stride + d];
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
      k_t[d * QK_STRIDE + c] = k[kbase + c * kv_stride + d];
      v_s[c * D + d] = v[kbase + c * kv_stride + d];
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
      o[r * q_stride + tx + 16 * e] = acc[i][e] / denom;
  }
}


// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;   // q rows per consumer warpgroup

struct BfParams {
  void* o;
  int S, T, H, group;
  int t_valid;
  int causal;
  int window;      // <= 0: no window
  float softcap;   // <= 0: no cap
  float scale;     // 1 / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all >> 4), swizzle mode in bits 62-63 (1: 128 B, 2: 64 B,
// 3: 32 B).
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from reading accumulators before wgmma_wait_all
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

// 2^x on the exp unit, flushing denormal results to 0 (they are far below
// bf16's resolution of P), without exp2f's denormal handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct Geometry {
  static constexpr int SW = D >= 64 ? 128 : 2 * D;   // swizzle bytes
  static constexpr int BOX = SW / 2;                 // columns in a box
  static constexpr int NBOX = D / BOX;
  static constexpr int TILE_K = 64;                  // keys per K/V tile
  static constexpr int STAGES = 2;                   // K/V ring depth
  // blocks an SM at NWG = 2: two for D <= 64 (128 registers a thread)
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  static constexpr int Q_BYTES = WG_ROWS * D * 2;    // one warpgroup's Q
  static constexpr int QBOX_BYTES = WG_ROWS * SW;    // its rows of one box
  static constexpr int KV_BYTES = TILE_K * D * 2;    // one K or V tile
  static constexpr int KVBOX_BYTES = TILE_K * SW;    // its rows of one box
};

template <int D, int NWG>
constexpr size_t wg_smem_bytes() {
  using G = Geometry<D>;
  return 1024 + (size_t)NWG * G::Q_BYTES + 2 * G::STAGES * G::KV_BYTES;
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128,
                                  NWG == 2 ? Geometry<D>::MIN_BLOCKS : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           BfParams p) {
  using G = Geometry<D>;
  constexpr int SW = G::SW, TILE_K = G::TILE_K, STAGES = G::STAGES;
  constexpr int BLOCK_Q = NWG * WG_ROWS;
  constexpr float LOG2E = 1.4426950408889634f;
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle and wgmma's descriptors both work on absolute shared
  // addresses: align the tiles to the 1024-byte swizzle period
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                            // [NWG][tile]
  const uint32_t k_s = q_s + NWG * G::Q_BYTES;         // [STAGES][tile]
  const uint32_t v_s = k_s + STAGES * G::KV_BYTES;      // [STAGES][tile]
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);
  const uint32_t empty0 = smem_u32(&bars[1 + STAGES]);

  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int row0 = qt * BLOCK_Q;
  // k columns any row of this tile can see: [col_lo, col_hi)
  int col_hi = p.t_valid;
  if (p.causal) col_hi = min(col_hi, row0 + BLOCK_Q);
  const int col_lo = p.window > 0 ? max(0, row0 - p.window + 1) : 0;
  const int kt_lo = col_lo / TILE_K;
  const int kt_hi = col_hi > 0 ? (col_hi + TILE_K - 1) / TILE_K : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // copies tile i of the block's visible K/V tiles into its stage
  auto load_kv = [&](int i) {
    const int s = i % STAGES, kt = kt_lo + i;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * G::KV_BYTES);
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_3d(k_s + s * G::KV_BYTES + x * G::KVBOX_BYTES, &kmap, full,
                  kvh * D + x * G::BOX, kt * TILE_K, b);
      tma_load_3d(v_s + s * G::KV_BYTES + x * G::KVBOX_BYTES, &vmap, full,
                  kvh * D + x * G::BOX, kt * TILE_K, b);
    }
  };
  const int n_tiles = kt_hi - kt_lo;
  if (tid == 0) {  // Q, then the ring's first tiles
    mbar_expect_tx(q_full, NWG * G::Q_BYTES);
    for (int w = 0; w < NWG; ++w)
      for (int x = 0; x < G::NBOX; ++x)
        tma_load_3d(q_s + w * G::Q_BYTES + x * G::QBOX_BYTES, &qmap, q_full,
                    h * D + x * G::BOX, row0 + w * WG_ROWS, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }

  // a consumer warpgroup: rows wrow0 .. wrow0 + 63 of the q tile
  const int wg = warp / 4, wq = warp % 4, gr = lane / 4, gc = lane % 4;
  const int wrow0 = row0 + wg * WG_ROWS;
  // this thread's two rows (fragment rows gr and gr + 8 of its warp)
  const int r_a = wrow0 + wq * 16 + gr, r_b = r_a + 8;
  // scores stay in q.k units (capped: softcap/scale * tanh(q.k * scale /
  // softcap)); the scale and log2(e) fold into exp2's one FFMA
  const float scale2 = p.scale * LOG2E;
  const bool cap = p.softcap > 0.f;
  const float cap_in = cap ? p.scale / p.softcap : 0.f;
  const float cap_out = cap ? p.softcap / p.scale : 0.f;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_w = q_s + wg * G::Q_BYTES;
  mbar_wait(q_full, 0);

  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int s = i % STAGES;
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const uint32_t k_t = k_s + s * G::KV_BYTES;
    const uint32_t v_t = v_s + s * G::KV_BYTES;

    // S = Q K^T: K-major operands, 16 columns of D (32 bytes) a step
    static_assert(TILE_K == 64, "S is one m64n64 accumulator");
    float sc[TILE_K / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int x = (kk * 16) / G::BOX, off = ((kk * 16) % G::BOX) * 2;
      wgmma_ss_n64(
          sc, make_desc<SW>(q_w + x * G::QBOX_BYTES + off, 16, 8 * SW),
          make_desc<SW>(k_t + x * G::KVBOX_BYTES + off, 16, 8 * SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // cap and mask. Fragment element 4j + e is
    // row (e < 2 ? r_a : r_b), column kt*TILE_K + 8j + 2*gc + (e & 1).
    const int c0 = kt * TILE_K;
    const bool edge = c0 + TILE_K > p.t_valid ||
                      (p.causal && c0 + TILE_K - 1 > wrow0) ||
                      (p.window > 0 && c0 <= wrow0 + WG_ROWS - 1 - p.window);
#pragma unroll
    for (int j = 0; j < TILE_K / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if (cap) x = cap_out * tanhf(x * cap_in);
        if (edge) {
          const int row = e < 2 ? r_a : r_b;
          const int col = c0 + 8 * j + 2 * gc + (e & 1);
          bool visible = col < p.t_valid;
          if (p.causal) visible = visible && col <= row;
          if (p.window > 0) visible = visible && col > row - p.window;
          if (!visible) x = -INFINITY;
        }
        sc[4 * j + e] = x;
      }
    }

    // online softmax for the two rows; a row's TILE_K columns sit in the
    // four lanes of a quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TILE_K / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // nothing visible so far: keep exp2 finite and the sums at 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2((m[r] - m_use) * scale2);
      const float m2 = m_use * scale2;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TILE_K / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = ex2(fmaf(sc[4 * j + 2 * r + e], scale2, -m2));
          sc[4 * j + 2 * r + e] = pv;
          sum += pv;
        }
      }
      l[r] = l[r] * alpha[r] + sum;  // this lane's share; reduced at the end
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V: P's bf16 A fragments straight from S's accumulator (all
    // packed before the fence), V an MN-major B (16 key rows a step; the
    // next BOX columns of D at LBO)
    uint32_t a[TILE_K / 16][4];
#pragma unroll
    for (int kk = 0; kk < TILE_K / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        a[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE_K / 16; ++kk)
      wgmma_rs<D>(o, a[kk],
                  make_desc<SW>(v_t + kk * 16 * SW, G::KVBOX_BYTES, 8 * SW));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with s
    if (warp == 0 && i + STAGES < n_tiles) {  // refill s once all are done
      mbar_wait(empty0 + 8 * s, (i / STAGES) & 1);
      if (lane == 0) load_kv(i + STAGES);
      __syncwarp();
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;  // no visible key -> 0
    const int row = r == 0 ? r_a : r_b;
    if (row < p.S) {
      __nv_bfloat16* dst =
          out + (((long)b * p.S + row) * p.H + h) * (long)D + 2 * gc;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raises the kernel's dynamic shared-memory limit on the current device
// once (not on every launch).
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

template <int D>
int launch_fma(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = allow_smem<flash_fwd_fma_kernel<D>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.S / BLOCK_Q, p.H, batch);
  flash_fwd_fma_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (batch, rows, cols) row-major tensor, read in boxes of `box_rows`
// rows by `box` columns with the swizzle of that width; out-of-range rows
// read 0.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows,
              int cols, int box_rows, int box, int swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t boxes[3] = {(cuuint32_t)box, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, boxes, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const BfParams& p, int kv, int batch, cudaStream_t stream) {
  using G = Geometry<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, batch, p.S, p.H * D, WG_ROWS, G::BOX, G::SW) ||
      !make_map(&kmap, k, batch, p.T, kv * D, G::TILE_K, G::BOX, G::SW) ||
      !make_map(&vmap, v, batch, p.T, kv * D, G::TILE_K, G::BOX, G::SW))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes<D, NWG>();
  cudaError_t err = allow_smem<flash_fwd_wgmma_kernel<D, NWG>>(smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BLOCK_Q = NWG * WG_ROWS;
  dim3 grid((p.S + BLOCK_Q - 1) / BLOCK_Q, p.H, batch);
  flash_fwd_wgmma_kernel<D, NWG><<<grid, NWG * 128, smem, stream>>>(
      qmap, kmap, vmap, p);
  return (int)cudaGetLastError();
}

// 128-row q tiles (two consumer warpgroups) when they still give at least
// two blocks an SM; else 64-row tiles, so a small grid fills the card
template <int D>
int dispatch_wgmma(const void* q, const void* k, const void* v,
                   const BfParams& p, int kv, int batch, cudaStream_t s) {
  const long blocks128 = (long)((p.S + 127) / 128) * p.H * batch;
  return blocks128 >= 2L * sm_count()
             ? launch_wgmma<D, 2>(q, k, v, p, kv, batch, s)
             : launch_wgmma<D, 1>(q, k, v, p, kv, batch, s);
}

}  // namespace

extern "C" {

// fp32 only: rows of q per block and columns of k per tile, the multiples
// the wrapper pads S and T to. bf16 takes any S and T.
int flash_attention_block_q() { return BLOCK_Q; }
int flash_attention_block_k() { return BLOCK_K; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bfloat16 tensors (q, k, v 16-byte aligned), 0 for float32
// (S and T padded to the multiples above).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int is_bf16, int batch, int s, int t, int h, int kv,
                        int d, int t_valid, int causal, int window,
                        float softcap, void* stream) {
  if (batch <= 0 || s <= 0 || t <= 0 || kv <= 0 || h % kv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)d);
  if (is_bf16) {
    if ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
         reinterpret_cast<size_t>(v)) % 16)
      return (int)cudaErrorInvalidValue;
    const BfParams p{o, s, t, h, h / kv, t_valid, causal, window, softcap,
                     scale};
    switch (d) {
      case 16: return dispatch_wgmma<16>(q, k, v, p, kv, batch, st);
      case 32: return dispatch_wgmma<32>(q, k, v, p, kv, batch, st);
      case 64: return dispatch_wgmma<64>(q, k, v, p, kv, batch, st);
      case 128: return dispatch_wgmma<128>(q, k, v, p, kv, batch, st);
      case 192: return dispatch_wgmma<192>(q, k, v, p, kv, batch, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (s % BLOCK_Q || t % BLOCK_K) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, s, t, h, kv, h / kv, t_valid, causal, window,
                 softcap, scale};
  switch (d) {
    case 16: return launch_fma<16>(p, batch, st);
    case 32: return launch_fma<32>(p, batch, st);
    case 64: return launch_fma<64>(p, batch, st);
    case 128: return launch_fma<128>(p, batch, st);
    case 192: return launch_fma<192>(p, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
