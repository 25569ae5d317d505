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
// in bf16), so the read is bound by the tensor cores' rate.
//
// Design. The Pallas grid (N, tiles) carries m / l / acc in VMEM from one
// grid step to the next over all Qp query rows; Hopper blocks run unordered
// and a block holds at most 227 KB. Here two kernels run one after the other:
//   (1) main: one block per (64 query rows, split, n) owns all Cv = 512 value
//       columns of its rows and walks a fixed contiguous share of the row's
//       active list, order[n, counts[n] * split / splits ..
//       counts[n] * (split + 1) / splits), keeping the online-softmax state
//       in registers. S = Q K^T is computed once per (query block, tile) on
//       the tensor cores and never per value slice. It writes its partial
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
// bf16 (the engine's type), 8 warps: warp w owns query rows 16 (w % 4) ..
// +15 and value columns 256 (w / 4) .. +255, so each pair of warps computes
// the same 16 x 64 S (2 Ck + Cv against Ck + Cv of useful work per position)
// and no exchange through shared memory is needed. mma.sync m16n8k16 bf16
// with f32 accumulation (mma_bf16.cuh), fragments through ldmatrix. P is
// rounded to bf16 in registers for P V, as the TPU kernel does
// (p.astype(v.dtype)); m, l and lse stay f32. K and V stay bf16 in shared
// memory, in a two-stage ring filled with 16-byte cp.async, so that tile
// it + 1 loads while tile it is computed.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// bf16 shared memory (elements): rows padded by 16 bytes for ldmatrix
constexpr int LDK_H = CK + 8;                     // Q and K rows
constexpr int LDV_H = CV + 8;                     // V rows
constexpr int STAGE_H = BM * LDK_H + BM * LDV_H;  // one ring stage: K, then V
constexpr int SMEM_BF16_BYTES = (BQ * LDK_H + 2 * STAGE_H) * 2 + 2 * BM * 4;

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

// (1), bf16: partial (m, l, acc) of 64 query rows over this split's tiles.
__global__ void __launch_bounds__(NTHREADS, 1) flash_read_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ slot_valid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int Q, int S, int hw, int nt, long long sk_n,
    long long sk_slot, long long sk_pos, long long sv_n, long long sv_slot, long long sv_pos,
    float scale) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);                  // BQ x LDK_H
  bf16* ring = Qs + BQ * LDK_H;                                // 2 stages of STAGE_H
  float* valid_s = reinterpret_cast<float*>(ring + 2 * STAGE_H);  // 2 x BM

  const int n = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int M = S * hw;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = (warp & 3) * 16;        // the warp's query rows
  const int wc = (warp >> 2) * (CV / 2); // the warp's value columns
  const bf16* kn = k + n * sk_n;
  const bf16* vn = v + n * sv_n;
  const uint8_t* valid_n = slot_valid + n * S;
  const int32_t* order_n = order + n * nt;
  int begin, end;
  split_share(counts[n], begin, end);

  auto stage_tile = [&](int it, int buf) {
    const int tile = order_n[it];
    bf16* Ks = ring + buf * STAGE_H;
    stage_memory_rows<bf16, CK, LDK_H>(Ks, kn, tile, M, hw, sk_slot, sk_pos);
    stage_memory_rows<bf16, CV, LDV_H>(Ks + BM * LDK_H, vn, tile, M, hw, sv_slot, sv_pos);
    stage_valid(valid_s + buf * BM, valid_n, tile, M, hw);
  };

  stage_query_rows<bf16, LDK_H>(Qs, q + (long long)n * Q * CK, q0, Q);
  if (begin < end) stage_tile(begin, 0);
  mma_bf16::cp_async_commit();

  float acc[CV / 16][4] = {};           // 16 rows x 256 columns: C fragments
  float m_r[2] = {NEG, NEG};            // rows wr + g, wr + g + 8
  float l_r[2] = {0.f, 0.f};            // this thread's share of the row sums

  for (int it = begin; it < end; ++it) {
    const int buf = (it - begin) & 1;
    if (it + 1 < end) stage_tile(it + 1, buf ^ 1);
    mma_bf16::cp_async_commit();
    mma_bf16::cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const bf16* Ks = ring + buf * STAGE_H;
    const bf16* Vs = Ks + BM * LDK_H;
    const float* vf = valid_s + buf * BM;

    // S = Q K^T: 16 rows x 64 positions, eight 16 x 8 tiles
    float s[BM / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      uint32_t a[4];
      mma_bf16::ldmatrix_x4(a, Qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDK_H +
                                   16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        uint32_t b[4];
        mma_bf16::ldmatrix_x4(b, Ks + (16 * j + (lane & 7) + 8 * (lane >> 4)) * LDK_H +
                                     16 * kk + 8 * ((lane >> 3) & 1));
        mma_bf16::mma(s[2 * j], a, b[0], b[1]);
        mma_bf16::mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    // online softmax; a row's 64 scores sit in the 4 lanes of one quad
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = vf[8 * j + 2 * t + e] > 0.f;
        s[j][e] = ok ? s[j][e] * scale : NEG;
        s[j][2 + e] = ok ? s[j][2 + e] * scale : NEG;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
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
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
    for (int j = 0; j < CV / 16; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P V: P rounded to bf16 from the S fragments, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t a[4];
      a[0] = mma_bf16::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = mma_bf16::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = mma_bf16::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = mma_bf16::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < CV / 32; ++j) {
        uint32_t b[4];
        mma_bf16::ldmatrix_x4_trans(b, Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                                LDV_H + wc + 16 * j + 8 * (lane >> 4));
        mma_bf16::mma(acc[2 * j], a, b[0], b[1]);
        mma_bf16::mma(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  mma_bf16::cp_async_wait<0>();

  // partial state of this split, rows past Q included (the merge skips them)
  const int Qp = gridDim.x * BQ;
  const long long row0 = ((long long)n * gridDim.y + blockIdx.y) * Qp + q0 + wr;
  float* pa = part_acc + row0 * CV + wc;
#pragma unroll
  for (int j = 0; j < CV / 16; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(pa + g * CV + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(pa + (g + 8) * CV + c) = make_float2(acc[j][2], acc[j][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  if (wc == 0 && t == 0) {
    part_ml[row0 + g] = make_float2(m_r[0], l_r[0]);
    part_ml[row0 + g + 8] = make_float2(m_r[1], l_r[1]);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* slot_valid,
           const int32_t* order, const int32_t* counts, const int32_t* zs, void* out, float* lse,
           float* part_acc, float2* part_ml, int N, int Q, int S, int hw, int nt, int splits,
           long long sk_n, long long sk_slot, long long sk_pos, long long sv_n,
           long long sv_slot, long long sv_pos, float scale, cudaStream_t stream) {
  const dim3 grid((Q + BQ - 1) / BQ, splits, N);
  if constexpr (std::is_same<T, bf16>::value) {
    flash_read_fwd_bf16_kernel<<<grid, NTHREADS, SMEM_BF16_BYTES, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        slot_valid, order, counts, part_acc, part_ml, Q, S, hw, nt, sk_n, sk_slot, sk_pos, sv_n,
        sv_slot, sv_pos, scale);
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
// strides are in elements, channels contiguous; Cv must be 512. part_acc /
// part_ml are f32 scratch of (N, splits, Qp, 512) / (N, splits, Qp, 2), Qp =
// Q rounded up to 64, written by the main kernel before the merge reads them.
// Returns the first CUDA error of the two launches.
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

// Opts the main kernels into their dynamic shared memory on the current
// device, once, when the library is loaded: a launch then makes no other CUDA
// call, so that a CUDA graph captures it as it is.
extern "C" int flash_read_fwd_init() {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_read_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      flash_read_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32_BYTES));
}

// Compile-time constants the Python wrapper checks against and reports.
extern "C" int flash_read_fwd_tile() { return BM; }
extern "C" int flash_read_fwd_smem_bytes() { return SMEM_MAX_BYTES; }
