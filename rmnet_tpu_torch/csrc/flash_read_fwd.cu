// Block-sparse regional memory read, forward (flash style), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rmnet_tpu/ops/flash_attention.py::_kernel
// (launched by _flash_fwd_impl, pallas_call at flash_attention.py:226).
//
// What it computes, per object row n and query q:
//   out[n, q] = sum_m softmax_m(q . k_m * scale + bias_m) v_m,   lse[n, q]
// where bias_m is 0 on valid slots and -1e30 on invalid ones. Only the memory
// tiles in the row's compacted active list are read. The z valid positions
// of the skipped tiles hold k = v = 0 (memorize masks k/v by the box raster),
// so each adds exp(0 - m) to the denominator and nothing to the numerator:
// that mass is added in closed form at the end. A row with no valid position
// writes out = 0 and lse = +inf.
//
// Bound. Work is 2 N Q M_active (Ck + Cv) FLOP against the K/V bytes of the
// active tiles read once: at the main-path shapes (Q = 1620, Ck = 128,
// Cv = 512) about 1600 FLOP per byte, far above the H100's ridge (about 295
// in bf16), so the read is bound by the tensor cores' rate. What keeps the
// kernel from it: a tile's positions outside the boxes are computed all the
// same, each block streams every active tile's 80 KB of K and V through
// shared memory for only 64 query rows, and a warpgroup runs a tile's S,
// softmax and P V in turn.
//
// Design. The Pallas grid (N, tiles) carries m / l / acc in VMEM from one
// grid step to the next over all Qp query rows; Hopper blocks run unordered
// and a block holds at most 227 KB. Here two kernels run one after the other:
//   (1) main: one block per (64 query rows, split, n) owns all Cv = 512 value
//       columns of its rows and walks a fixed contiguous share of the row's
//       active list, order[n, counts[n] * split / splits ..
//       counts[n] * (split + 1) / splits), keeping the online-softmax state
//       in registers; S = Q K^T is computed per (query block, tile), never
//       per value slice narrower than 256. It writes its partial
//       (m, l, acc) in f32 to a scratch of (N, splits, Qp, Cv + 2); a split
//       with no tile writes m = -1e30, l = 0, acc = 0. The splits give the
//       grid enough blocks at small N (the engine reads N = 2 rows); the
//       wrapper picks their count from the shapes and the SM count, so the
//       launch needs no host sync.
//   (2) merge: one block per (query row, n) combines the splits in a fixed
//       order, adds the skipped tiles' z exp(-m) once, applies the
//       all-invalid guard and writes out (input type) and lse.
// No atomics: two calls give bit-identical results.
//
// bf16 (the engine's type): warp-specialised, 3 warpgroups (mma_bf16.cuh).
// A producer warp keeps each tile's K (2 boxes of 64 positions x 64
// channels) and V (8 boxes) in flight into a two-stage ring in shared memory
// with TMA, on per-stage mbarriers, and writes the tile's valid flags beside
// them; the bank's positions are one axis of a 3-D tensor map (channel,
// position, row), so a tile that straddles two slots is one box and
// positions past M read as zeros. The tensor maps are encoded on the host
// at each launch (no CUDA call) and passed as __grid_constant__ parameters,
// so a CUDA graph records the launch alone. Two consumer warpgroups, which
// take the producer's registers (setmaxnreg), each compute the tile's 64 x
// 64 S with wgmma from shared memory (2 Ck + Cv of products per position
// against Ck + Cv of useful work: measured faster than one S passed as P
// through shared memory), then P V over 256 value columns with wgmma
// m64n256k16, P rounded to bf16 in registers as the TPU kernel does
// (p.astype(v.dtype)); m, l and lse stay f32. Their products and softmaxes
// overlap on the SM; a stage is refilled once both are done with it.
//
// f32 (the training read): 3xTF32 mma.sync (mma_tf32.cuh), one stage of Q,
// K, V and P (f32) in shared memory. S is split over two depth halves (warps
// 0-3 and 4-7, summed in a fixed order) and computed once; P passes through
// shared memory in f32; each warp then accumulates 32 rows x 128 value
// columns of P V. V's copy overlaps S and the softmax, the next K's copy
// overlaps P V.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_read_fwd.so flash_read_fwd.cu
// Bound from Python with ctypes (rmnet_tpu_torch/ops/flash_attention.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per block
constexpr int BM = 64;        // memory positions per kernel tile
constexpr int CK = 128;       // key width
constexpr int CV = 512;       // value width
constexpr int NTHREADS = 256; // 8 warps
constexpr int MAX_SPLITS = 8;
constexpr float NEG = -1e30f;

// bf16 kernel: two consumer warpgroups and a producer warpgroup, whose
// registers setmaxnreg hands to the consumers (128 x 40 + 256 x 232 of the
// SM's 65536). Shared memory (bytes, from a 1024-aligned base): Q, a ring of
// STAGES K tiles and V tiles, each a row of 64-channel TMA boxes of 64 rows
// (128-byte swizzle), the valid flags of each stage and the mbarriers (Q;
// K, V and free per stage).
constexpr int WG_THREADS = 128;
constexpr int BF16_THREADS = 3 * WG_THREADS;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 2;
constexpr int PANEL = 64;                          // bf16 channels in a 128-byte row
constexpr int BOX_BYTES = BM * PANEL * 2;          // one TMA box: 64 rows x 128 bytes
constexpr int Q_BYTES = (CK / PANEL) * BOX_BYTES;
constexpr int K_BYTES = (CK / PANEL) * BOX_BYTES;
constexpr int V_BYTES = (CV / PANEL) * BOX_BYTES;
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
constexpr int MASK_OFF = V_OFF + STAGES * V_BYTES;
constexpr int BAR_OFF = MASK_OFF + STAGES * 8;
constexpr int SMEM_BF16_BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;  // + alignment
static_assert(BQ == BM && CK % PANEL == 0 && CV == 2 * 4 * PANEL, "tile shapes");
static_assert(K_OFF % 1024 == 0 && V_OFF % 1024 == 0, "1024-byte swizzle atoms");

// f32 shared memory (floats): strides 4 mod 32 for depth-contiguous operands
// and 8 mod 32 for row-contiguous ones (mma_tf32.cuh)
constexpr int LDK_F = CK + 4;  // Q and K rows, depth-contiguous
constexpr int LDV_F = CV + 8;  // V rows, row-contiguous
constexpr int LDP_F = BM + 4;  // S / P rows, depth-contiguous
constexpr int SMEM_F32_BYTES = (2 * BQ * LDK_F + BM * LDV_F + BQ * LDP_F + BM + 3 * BQ) * 4;
constexpr int SMEM_MAX_BYTES = SMEM_BF16_BYTES > SMEM_F32_BYTES ? SMEM_BF16_BYTES : SMEM_F32_BYTES;
static_assert(SMEM_MAX_BYTES <= 232448, "a block has at most 227 KB of shared memory");
static_assert(NTHREADS == 4 * BQ, "the f32 softmax takes 4 threads per query row");

using mma_bf16::cp_async16;

// Copy 64 memory rows (positions tile * BM + r, zeros past M) of W channels
// into shared memory at row stride LD elements, as 16-byte cp.async.
template <typename T, int W, int LD>
__device__ __forceinline__ void stage_memory_rows(T* dst, const T* base, int tile, int M, int hw,
                                                  long long s_slot, long long s_pos) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = W / VEC;
  for (int e = threadIdx.x; e < BM * PER_ROW; e += NTHREADS) {
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * VEC;
    const int p = tile * BM + r;
    const bool in = p < M;
    const int slot = in ? p / hw : 0;
    const T* src = in ? base + slot * s_slot + (p - slot * hw) * s_pos + c : base;
    cp_async16(dst + r * LD + c, src, in);
  }
}

// Copy query rows q0 .. q0 + 63 (zeros past Q) of a contiguous (Q, CK) matrix.
template <typename T, int LD>
__device__ __forceinline__ void stage_query_rows(T* dst, const T* qn, int q0, int Q) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = CK / VEC;
  for (int e = threadIdx.x; e < BQ * PER_ROW; e += NTHREADS) {
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * VEC;
    const bool in = q0 + r < Q;
    cp_async16(dst + r * LD + c, in ? qn + (long long)(q0 + r) * CK + c : qn, in);
  }
}

// 1 for the valid positions of a tile, 0 for invalid slots and past M.
__device__ __forceinline__ void stage_valid(float* dst, const uint8_t* valid_n, int tile, int M,
                                            int hw) {
  if (threadIdx.x < BM) {
    const int p = tile * BM + threadIdx.x;
    dst[threadIdx.x] = (p < M && valid_n[p / hw]) ? 1.f : 0.f;
  }
}

// This split's contiguous share [begin, end) of the row's active list.
__device__ __forceinline__ void split_share(int count, int& begin, int& end) {
  begin = static_cast<int>(static_cast<long long>(count) * blockIdx.y / gridDim.y);
  end = static_cast<int>(static_cast<long long>(count) * (blockIdx.y + 1) / gridDim.y);
}

// One tile's scores of rows r and r + 8 (the quad's lanes hold a row's 64
// columns): scaled, invalid positions masked, the online softmax's running
// max m and sum l updated; the scores become P in place, alpha the rescale
// of what was summed before, pa P rounded to bf16 as the A fragments of the
// 4 depth steps of P V (the TPU kernel's p.astype(v.dtype)).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint64_t mask, int qd, float scale,
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], uint32_t (&pa)[4][4]) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = (mask >> (8 * j + 2 * qd + e)) & 1;
      sc[4 * j + e] = ok ? sc[4 * j + e] * scale : NEG;
      sc[4 * j + 2 + e] = ok ? sc[4 * j + 2 + e] * scale : NEG;
      mx[0] = fmaxf(mx[0], sc[4 * j + e]);
      mx[1] = fmaxf(mx[1], sc[4 * j + 2 + e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = expf(m_r[h] - mx[h]);
    m_r[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = expf(sc[4 * j + e] - mx[e >> 1]);
      sum[e >> 1] += sc[4 * j + e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
  for (int kk = 0; kk < BM / 16; ++kk) {
    pa[kk][0] = mma_bf16::pack(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = mma_bf16::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = mma_bf16::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = mma_bf16::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// (1), bf16: partial (m, l, acc) of 64 query rows over this split's tiles.
// Warpgroups 0 and 1 consume: each computes the tile's 64 x 64 S = Q K^T
// itself and owns value columns 256 c .. +255 of P V (128 accumulator
// registers a thread). Warpgroup 2 produces: one warp walks the split's
// tiles, waits for a free stage, writes the tile's valid flags and starts
// its K and V boxes. Each consumer runs S, the softmax and P V of a tile in
// turn; the two warpgroups' products and softmaxes overlap on the SM.
__global__ void __launch_bounds__(BF16_THREADS, 1) flash_read_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ slot_valid,
    const int32_t* __restrict__ order, const int32_t* __restrict__ counts,
    float* __restrict__ part_acc, float2* __restrict__ part_ml, int S, int hw, int nt,
    float scale) {
  using namespace mma_bf16;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte atoms
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_addr(base);
  const uint32_t s_q = s_base + Q_OFF;
  uint64_t* mask_s = reinterpret_cast<uint64_t*>(base + MASK_OFF);
  const uint32_t bar_q = s_base + BAR_OFF;
  auto s_k = [&](int i) { return s_base + K_OFF + (i % STAGES) * K_BYTES; };
  auto s_v = [&](int i) { return s_base + V_OFF + (i % STAGES) * V_BYTES; };
  auto bar_k = [&](int i) { return bar_q + 8 * (1 + i % STAGES); };
  auto bar_v = [&](int i) { return bar_q + 8 * (1 + STAGES + i % STAGES); };
  auto bar_free = [&](int i) { return bar_q + 8 * (1 + 2 * STAGES + i % STAGES); };
  auto phase = [](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };

  const int n = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int begin, end;
  split_share(counts[n], begin, end);
  const int count = end - begin;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_free(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != 8 || count == 0) return;
    const int M = S * hw;
    const uint8_t* valid_n = slot_valid + n * S;
    const int32_t* order_n = order + n * nt + begin;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, Q_BYTES);
      for (int p = 0; p < CK / PANEL; ++p)
        tma_load_3d(s_q + p * BOX_BYTES, &tm_q, p * PANEL, q0, n, bar_q);
    }
    for (int i = 0; i < count; ++i) {
      const int p0 = order_n[i] * BM;
      const int a = p0 + lane, b = a + 32;
      const uint32_t lo = __ballot_sync(0xffffffffu, a < M && valid_n[a / hw]);
      const uint32_t hi = __ballot_sync(0xffffffffu, b < M && valid_n[b / hw]);
      mbar_wait(bar_free(i), phase(i) ^ 1);
      if (lane == 0) {
        mask_s[i % STAGES] = (static_cast<uint64_t>(hi) << 32) | lo;  // published by the arrival
        mbar_arrive_expect_tx(bar_k(i), K_BYTES);
        for (int p = 0; p < CK / PANEL; ++p)
          tma_load_3d(s_k(i) + p * BOX_BYTES, &tm_k, p * PANEL, p0, n, bar_k(i));
        mbar_arrive_expect_tx(bar_v(i), V_BYTES);
        for (int p = 0; p < CV / PANEL; ++p)
          tma_load_3d(s_v(i) + p * BOX_BYTES, &tm_v, p * PANEL, p0, n, bar_v(i));
      }
      __syncwarp();
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;           // value columns 256 wg .. 256 wg + 255
  const int wr = (warp & 3) * 16;     // the warp's 16 rows
  const int g = lane >> 2;
  const int qd = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_r[2] = {NEG, NEG};  // rows wr + g, wr + g + 8
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums

  uint32_t pa[4][4];  // P, the A fragments of the 4 depth steps of P V
  float alpha[2];
  if (count > 0) mbar_wait(bar_q, 0);
  for (int i = 0; i < count; ++i) {
    // S = Q K^T: 64 x 64 over depth 128, both operands K-major
    mbar_wait(bar_k(i), phase(i));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_m64n64k16_ss(sc, desc_sw128(s_q + off, 16, 1024), desc_sw128(s_k(i) + off, 16, 1024),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    softmax_tile(sc, mask_s[i % STAGES], qd, scale, m_r, l_r, alpha, pa);
#pragma unroll
    for (int j = 0; j < CV / 16; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // acc += P V: V MN-major, this warpgroup's 4 boxes
    mbar_wait(bar_v(i), phase(i));
    wgmma_fence();
    const uint32_t v0 = s_v(i) + wg * (CV / 2 / PANEL) * BOX_BYTES;
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_m64n256k16_rs(acc, pa[kk], desc_sw128(v0 + kk * 2048, BOX_BYTES, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);  // the products read pa until here
    if (lane == 0 && (warp & 3) == 0) mbar_arrive(bar_free(i));  // one arrival a warpgroup
  }

  // partial state of this split, rows past Q included (the merge skips them)
  const int Qp = gridDim.x * BQ;
  const long long row0 = ((long long)n * gridDim.y + blockIdx.y) * Qp + q0 + wr;
  float* out = part_acc + row0 * CV + wg * (CV / 2);
#pragma unroll
  for (int j = 0; j < CV / 16; ++j) {
    const int c = 8 * j + 2 * qd;
    *reinterpret_cast<float2*>(out + g * CV + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (g + 8) * CV + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (wg == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    }
    if (qd == 0) {
      part_ml[row0 + g] = make_float2(m_r[0], l_r[0]);
      part_ml[row0 + g + 8] = make_float2(m_r[1], l_r[1]);
    }
  }
}

// (1), f32: partial (m, l, acc) of 64 query rows over this split's tiles.
__global__ void __launch_bounds__(NTHREADS, 1) flash_read_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ slot_valid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int Q, int S, int hw, int nt, long long sk_n,
    long long sk_slot, long long sk_pos, long long sv_n, long long sv_slot, long long sv_pos,
    float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LDK_F
  float* Ks = Qs + BQ * LDK_F;                   // BM x LDK_F
  float* Vs = Ks + BM * LDK_F;                   // BM x LDV_F
  float* Ps = Vs + BM * LDV_F;                   // BQ x LDP_F: scores, then probabilities
  float* valid_s = Ps + BQ * LDP_F;              // BM
  float* m_s = valid_s + BM;                     // BQ: running max
  float* l_s = m_s + BQ;                         // BQ: running sum
  float* alpha_s = l_s + BQ;                     // BQ: this tile's rescale

  const int n = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int M = S * hw;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* kn = k + n * sk_n;
  const float* vn = v + n * sv_n;
  const uint8_t* valid_n = slot_valid + n * S;
  const int32_t* order_n = order + n * nt;
  int begin, end;
  split_share(counts[n], begin, end);

  // S: warp w computes the 32 x 32 tile (rows sr, positions sc) over depth half sd
  const int sr = (warp & 2) * 16;
  const int sc = (warp & 1) * 32;
  const int sd = (warp >> 2) * (CK / 2);
  // P V: warp w accumulates rows pr, value columns pc .. pc + 127
  const int pr = (warp & 1) * 32;
  const int pc = (warp >> 1) * 128;

  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  stage_query_rows<float, LDK_F>(Qs, q + (long long)n * Q * CK, q0, Q);
  if (begin < end) {
    stage_memory_rows<float, CK, LDK_F>(Ks, kn, order_n[begin], M, hw, sk_slot, sk_pos);
    stage_valid(valid_s, valid_n, order_n[begin], M, hw);
  }
  mma_bf16::cp_async_commit();

  float acc[4][2][4][4] = {};  // 4 tiles of 32 x 32 at columns pc + 32 j
  for (int it = begin; it < end; ++it) {
    const int tile = order_n[it];
    stage_memory_rows<float, CV, LDV_F>(Vs, vn, tile, M, hw, sv_slot, sv_pos);
    mma_bf16::cp_async_commit();
    mma_bf16::cp_async_wait<1>();  // Q, this tile's K and flags have landed
    __syncthreads();

    float sp[2][4][4] = {};
    mma_tf32::warp_tile_32x32<true, true, false, false, CK / 2>(sp, Qs + sd, LDK_F, Ks + sd,
                                                                LDK_F, sr, sc);
    // depth half 1 parks its partial in Ps; half 0 adds it, scales and masks
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if ((pass == 0) == (sd != 0)) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = sr + 16 * mi + 8 * h + g;
              const int c = sc + 8 * nj + 2 * t;
              float2* dst = reinterpret_cast<float2*>(Ps + r * LDP_F + c);
              float2 val = make_float2(sp[mi][nj][2 * h], sp[mi][nj][2 * h + 1]);
              if (pass == 1) {
                const float2 other = *dst;
                val.x = valid_s[c] > 0.f ? (val.x + other.x) * scale : NEG;
                val.y = valid_s[c + 1] > 0.f ? (val.y + other.y) * scale : NEG;
              }
              *dst = val;
            }
      }
      __syncthreads();
    }

    // online softmax: 4 threads per row, 16 positions each
    {
      const int row = tid >> 2;
      float4* prow = reinterpret_cast<float4*>(Ps + row * LDP_F + 16 * (tid & 3));
      float sv[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = prow[i];
        sv[4 * i] = x.x;
        sv[4 * i + 1] = x.y;
        sv[4 * i + 2] = x.z;
        sv[4 * i + 3] = x.w;
      }
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < 16; ++i) mx = fmaxf(mx, sv[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sv[i] = expf(sv[i] - m_new);
        sum += sv[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        prow[i] = make_float4(sv[4 * i], sv[4 * i + 1], sv[4 * i + 2], sv[4 * i + 3]);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the quad has read m_s[row]
      if ((tid & 3) == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();  // P and alpha are in place; K and the flags are free

    if (it + 1 < end) {
      stage_memory_rows<float, CK, LDK_F>(Ks, kn, order_n[it + 1], M, hw, sk_slot, sk_pos);
      stage_valid(valid_s, valid_n, order_n[it + 1], M, hw);
    }
    mma_bf16::cp_async_commit();
    mma_bf16::cp_async_wait<1>();  // this tile's V has landed
    __syncthreads();

    float al[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) al[mi][h] = alpha_s[pr + 16 * mi + 8 * h + g];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][mi][nj][e] *= al[mi][e >> 1];
      mma_tf32::warp_tile_32x32<true, false, false, false, BM>(acc[j], Ps, LDP_F, Vs, LDV_F, pr,
                                                               pc + 32 * j);
    }
    __syncthreads();  // P V's reads of Ps and Vs are done
  }
  mma_bf16::cp_async_wait<0>();
  __syncthreads();

  const int Qp = gridDim.x * BQ;
  const long long row0 = ((long long)n * gridDim.y + blockIdx.y) * Qp + q0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = pr + 16 * mi + 8 * h + g;
          const int c = pc + 32 * j + 8 * nj + 2 * t;
          *reinterpret_cast<float2*>(part_acc + (row0 + r) * CV + c) =
              make_float2(acc[j][mi][nj][2 * h], acc[j][mi][nj][2 * h + 1]);
        }
  if (tid < BQ) part_ml[row0 + tid] = make_float2(m_s[tid], l_s[tid]);
}

// Store 4 consecutive floats as the output type.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// (2) The splits of one query row, merged in order: the closed-form mass of
// the skipped valid zero-score positions, the all-invalid guard, output and
// log-sum-exp (flash_attention.py:98-114).
template <typename T>
__global__ void __launch_bounds__(CV / 4) flash_read_fwd_merge_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    const int32_t* __restrict__ zs, T* __restrict__ out, float* __restrict__ lse, int Q,
    int splits, int Qp) {
  const int row = blockIdx.x;
  const int n = blockIdx.y;
  const int c = threadIdx.x * 4;
  const long long base = (long long)n * splits * Qp + row;  // split s at base + s * Qp
  float mx = NEG;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[base + (long long)s * Qp].x);
  const float z = static_cast<float>(zs[n]);
  const float m2 = z > 0.f ? fmaxf(mx, 0.f) : mx;
  float l_raw = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const long long r = base + (long long)s * Qp;
    const float2 ml = part_ml[r];
    const float w = expf(ml.x - m2);
    l_raw += w * ml.y;
    const float4 a = *reinterpret_cast<const float4*>(part_acc + r * CV + c);
    o.x += w * a.x;
    o.y += w * a.y;
    o.z += w * a.z;
    o.w += w * a.w;
  }
  l_raw += z * expf(-m2);
  const float l = l_raw > 0.f ? l_raw : 1.f;
  store4(out + ((long long)n * Q + row) * CV + c,
         make_float4(o.x / l, o.y / l, o.z / l, o.w / l));
  if (threadIdx.x == 0)
    lse[(long long)n * Q + row] = l_raw > 0.f ? m2 + logf(l) : INFINITY;
}

// CUDA's tensor-map encoder, resolved from libcuda once at load time
// (the library links the runtime only); encoding is host work, so a launch
// under CUDA graph capture records the launch alone.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
EncodeTiled encode_tiled = nullptr;

// A bf16 tensor map over (rows, n) rows of ``width`` channels, row and n
// strides in elements, cut into boxes of 64 rows x 64 channels with the
// 128-byte swizzle; rows past ``rows`` read as zeros.
bool bf16_map(CUtensorMap* map, const void* ptr, int width, long long rows, int n,
              long long row_stride, long long n_stride) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(n > 1 ? n_stride : rows * row_stride) * 2};
  const cuuint32_t box[3] = {PANEL, BM, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* slot_valid,
           const int32_t* order, const int32_t* counts, const int32_t* zs, void* out, float* lse,
           float* part_acc, float2* part_ml, int N, int Q, int S, int hw, int nt, int splits,
           long long sk_n, long long sk_slot, long long sk_pos, long long sv_n,
           long long sv_slot, long long sv_pos, float scale, cudaStream_t stream) {
  const dim3 grid((Q + BQ - 1) / BQ, splits, N);
  if constexpr (std::is_same<T, bf16>::value) {
    // the tensor maps read a bank's positions as one axis across its slots
    const long long M = static_cast<long long>(S) * hw;
    if (encode_tiled == nullptr) return static_cast<int>(cudaErrorInitializationError);
    if (S > 1 && (sk_slot != hw * sk_pos || sv_slot != hw * sv_pos))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tm_q, tm_k, tm_v;
    if (!bf16_map(&tm_q, q, CK, Q, N, CK, static_cast<long long>(Q) * CK) ||
        !bf16_map(&tm_k, k, CK, M, N, sk_pos, sk_n) || !bf16_map(&tm_v, v, CV, M, N, sv_pos, sv_n))
      return static_cast<int>(cudaErrorInvalidValue);
    flash_read_fwd_bf16_kernel<<<grid, BF16_THREADS, SMEM_BF16_BYTES, stream>>>(
        tm_q, tm_k, tm_v, slot_valid, order, counts, part_acc, part_ml, S, hw, nt, scale);
  } else {
    flash_read_fwd_f32_kernel<<<grid, NTHREADS, SMEM_F32_BYTES, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        slot_valid, order, counts, part_acc, part_ml, Q, S, hw, nt, sk_n, sk_slot, sk_pos, sv_n,
        sv_slot, sv_pos, scale);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_read_fwd_merge_kernel<T><<<dim3(Q, N), CV / 4, 0, stream>>>(
      part_acc, part_ml, zs, static_cast<T*>(out), lse, Q, splits, grid.x * BQ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and out are contiguous (N, Q, C); K/V
// strides are in elements, channels contiguous (bf16: slots one after the
// other, sk_slot = hw * sk_pos); Cv must be 512. part_acc / part_ml are f32
// scratch of (N, splits, Qp, 512) / (N, splits, Qp, 2), Qp = Q rounded up to
// 64, written by the main kernel before the merge reads them. Returns the
// first CUDA error of the two launches.
extern "C" int flash_read_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* slot_valid,
    const void* order, const void* counts, const void* zs, void* out, void* lse, void* part_acc,
    void* part_ml, int N, int Q, int S, int hw, int Cv, int nt, int splits,
    long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale, void* stream) {
  if (Cv != CV || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sv = static_cast<const uint8_t*>(slot_valid);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* ct = static_cast<const int32_t*>(counts);
  const auto* z = static_cast<const int32_t*>(zs);
  auto* l = static_cast<float*>(lse);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float2*>(part_ml);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, sv, od, ct, z, out, l, pa, pm, N, Q, S, hw, nt, splits, sk_n,
                         sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale, st);
  if (dtype == 1)
    return launch<bf16>(q, k, v, sv, od, ct, z, out, l, pa, pm, N, Q, S, hw, nt, splits, sk_n,
                        sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Once, when the library is loaded: resolves the tensor-map encoder and opts
// the main kernels into their dynamic shared memory on the current device,
// so that a launch makes no other CUDA call and a CUDA graph captures it as
// it is.
extern "C" int flash_read_fwd_init() {
  void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  if (libcuda != nullptr)
    encode_tiled = reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
  if (encode_tiled == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_read_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      flash_read_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32_BYTES));
}

// Compile-time constants the Python wrapper checks against and reports.
extern "C" int flash_read_fwd_tile() { return BM; }
extern "C" int flash_read_fwd_smem_bytes() { return SMEM_MAX_BYTES; }
