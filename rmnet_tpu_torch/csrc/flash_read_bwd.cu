// Block-sparse regional memory read, backward (flash style), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rmnet_tpu/ops/flash_attention.py::_bwd_kernel
// (launched by _flash_bwd_impl, pallas_call at flash_attention.py:335).
//
// What it computes, per object row n, over the row's listed active memory
// tiles only, from the forward's lse and D = rowsum(dO * O) (computed by the
// caller, as flash_attention.py:309-311 does outside the Pallas kernel):
//   s  = q . k_m * scale + bias_m          p = exp(s - lse)
//   dV = p^T dO                            dS = p * (dO V^T - D)
//   dK = dS^T q * scale                    dQ = dS K * scale
// bias_m is 0 on valid slots and -inf on invalid ones; positions past M and
// query rows past Q take p = 0. Rows with lse = +inf (no valid position) give
// p = exp(-inf) = 0 and so zero gradients, with no NaN. The skipped tiles'
// closed-form dK/dV and the merge stay in torch (flash_attention.py:346-372).
//
// Design. The Pallas grid (N, tiles) walks a row's tiles in order with the
// whole (Qp, Ck) dQ accumulator in VMEM; Hopper blocks run unordered. Here
// three kernels run one after the other on the stream, each a tiled product
// on the tensor cores (mma.sync m16n8k8 TF32, mma_tf32.cuh), deterministic
// and without atomics: every output element is written by one block, which
// sums in a fixed order.
//   (1) ds:   one block per (64 query rows, compacted tile index it, row n).
//             s = q K^T and dP = dO V^T (depth Ck + Cv, streamed through
//             shared memory in 64-column chunks), then p and dS, written as
//             float32 to the scratch P, dS of shape (N, nt, Qp, 64) at
//             [n, it]. s and dP are computed here once per (query block,
//             tile), and nowhere else.
//   (2) dkdv: one block per (it, 128-column output slice, n): Cv / 128
//             slices of dV and one of dK. It loops over the query blocks,
//             acc += P^T dO[:, slice] or dS^T q, and writes its tile's slice
//             once (dK scaled).
//   (3) dq:   one block per (64 query rows, n). It loops over the row's
//             listed tiles, acc += dS K_tile, and writes scale * acc.
// Blocks past counts[n] return at once, so the launch needs no host sync.
// Executed work per (query block, active tile): 2 * 64 * 64 * (Ck + Cv) FLOP
// for s and dP in (1), 2 * 64 * 64 * (Cv + Ck) for dV and dK in (2) and
// 2 * 64 * 64 * Ck for dQ in (3): 2 * 64 * 64 * (3 Ck + 2 Cv), 11.5 MFLOP at
// Ck = 128, Cv = 512 (chip_bwd_probe.py counts the mma instructions on the
// card against this). The scratch is read back once per dV slice (P) and
// twice (dS), for the listed tiles only.
//
// Precision. Inputs are f32 or bf16, widened to f32 as they are staged. An
// f32 product takes three TF32 passes (3xTF32: float32 accuracy); a widened
// bf16 operand is exact in TF32, so s and dP from bf16 inputs take one pass,
// and the products of P or dS (f32, never rounded) with bf16 operands two.
// The gradients are stored in the input type.
//
// Bound. Work is 2 N Q M_active (3 Ck + 2 Cv) FLOP against the active K/V
// bytes (read, and their gradients written, once) plus q, dO, dQ, lse, D: at
// the training read (Q = 900, Ck = 128, Cv = 512) about 900 FLOP per byte,
// above the H100's ridge, so the backward is bound by operations: f32 at the
// 3xTF32 rate (495 / 3 TFLOP/s), bf16 at the TF32 rate. The scratch adds
// about 0.5 GB of traffic at the training read.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_read_bwd.so flash_read_bwd.cu
// Bound from Python with ctypes (rmnet_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block or step
constexpr int BM = 64;       // memory positions per kernel tile
constexpr int CK = 128;      // key width
constexpr int KC = 64;       // depth columns per staged chunk of s and dP in (1)
constexpr int CS = 128;      // output columns per block of (2) and (3)
constexpr int NT_DS = 128;   // (1): 4 warps, 2 x 2 tiles of 32 x 32 over (query rows, positions)
constexpr int NT_ACC = 256;  // (2), (3): 8 warps, 2 x 4 tiles of 32 x 32 over (rows, columns)
static_assert(BQ == BM, "(1) stages its row and position data with one thread each");
static_assert(CK == CS, "the dK block of (2) and the K tile of (3) take the slice layout");

// Padded row strides (floats) of the shared-memory operands: depth-contiguous
// operands take ld % 32 == 4, row-contiguous ones ld % 32 == 8 (mma_tf32.cuh).
constexpr int LD_CHUNK = KC + 4;  // (1): q / dO and K / V chunks, depth-contiguous
constexpr int LD_PT = BM + 8;     // (2): P / dS read as P^T, row-contiguous
constexpr int LD_SLICE = CS + 8;  // (2): dO / q slice; (3): K tile, row-contiguous
constexpr int LD_DS = BM + 4;     // (3): dS, depth-contiguous

constexpr int SMEM_DS_BYTES = (BQ * LD_CHUNK + BM * LD_CHUNK + BM + 2 * BQ) * 4;
constexpr int SMEM_DKDV_BYTES = (BQ * LD_PT + BQ * LD_SLICE) * 4;
constexpr int SMEM_DQ_BYTES = (BQ * LD_DS + BM * LD_SLICE) * 4;

// Load 4 consecutive elements as floats (16-byte aligned f32, 8-byte bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Store 2 consecutive floats as the output type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stage a 64 x W tile of memory rows into shared memory (row stride ld) as
// f32. Row r is memory position tile * BM + r of object row n (zero past M);
// channels c0 .. c0 + W - 1.
template <typename T, int W, int NT>
__device__ __forceinline__ void stage_memory_tile(float* dst, int ld, const T* base, int tile,
                                                  int M, int hw, long long s_slot,
                                                  long long s_pos, int c0) {
  for (int e = threadIdx.x * 4; e < BM * W; e += NT * 4) {
    const int r = e / W;
    const int c = e % W;
    const int p = tile * BM + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < M) {
      const int slot = p / hw;
      const int within = p - slot * hw;
      val = load4(base + slot * s_slot + within * s_pos + c0 + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// Stage 64 query rows q0 .. q0 + 63 (zero past Q) of a contiguous (Q, width)
// matrix, channels c0 .. c0 + W - 1, into shared memory (row stride ld) as f32.
template <typename T, int W, int NT>
__device__ __forceinline__ void stage_query_rows(float* dst, int ld, const T* base, int q0,
                                                 int Q, int width, int c0) {
  for (int e = threadIdx.x * 4; e < BQ * W; e += NT * 4) {
    const int r = e / W;
    const int c = e % W;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q) val = load4(base + (long long)(q0 + r) * width + c0 + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// Stage one contiguous 64 x 64 f32 block of the scratch (row stride ld).
template <int NT>
__device__ __forceinline__ void stage_scratch(float* dst, int ld, const float* src) {
  for (int e = threadIdx.x * 4; e < BQ * BM; e += NT * 4)
    *reinterpret_cast<float4*>(dst + (e / BM) * ld + e % BM) =
        *reinterpret_cast<const float4*>(src + e);
}

// (1) s and dP of one (query block, compacted active tile) -> P, dS scratch.
template <typename T>
__global__ void __launch_bounds__(NT_DS, 3) flash_read_bwd_ds_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ slot_valid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    float* __restrict__ pbuf, float* __restrict__ dsbuf,
    int Q, int S, int hw, int Cv, int nt,
    long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  const int it = blockIdx.y;
  const int n = blockIdx.z;
  if (it >= counts[n]) return;
  const int tile = order[n * nt + it];
  const int q0 = blockIdx.x * BQ;
  const int M = S * hw;

  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // BQ x LD_CHUNK: q or dO chunk
  float* Bs = As + BQ * LD_CHUNK;                 // BM x LD_CHUNK: K or V chunk
  float* valid_s = Bs + BM * LD_CHUNK;            // BM
  float* lse_s = valid_s + BM;                    // BQ
  float* d_s = lse_s + BQ;                        // BQ

  const int tid = threadIdx.x;
  if (tid < BM) {
    const int p = tile * BM + tid;
    valid_s[tid] = (p < M && slot_valid[n * S + p / hw]) ? 1.f : 0.f;
    const int row = q0 + tid;  // BQ == BM
    lse_s[tid] = row < Q ? lse[(long long)n * Q + row] : INFINITY;
    d_s[tid] = row < Q ? dd[(long long)n * Q + row] : 0.f;
  }

  const T* qn = q + (long long)n * Q * CK;
  const T* don = dout + (long long)n * Q * Cv;
  const T* kn = k + n * sk_n;
  const T* vn = v + n * sv_n;
  const int warp = tid >> 5;
  const int wr = (warp >> 1) * 32;  // query rows of this warp's tile
  const int wc = (warp & 1) * 32;   // memory positions of this warp's tile

  float s[2][4][4] = {}, dp[2][4][4] = {};
  for (int c0 = 0; c0 < CK; c0 += KC) {
    __syncthreads();  // the previous chunk's reads of As / Bs are done
    stage_query_rows<T, KC, NT_DS>(As, LD_CHUNK, qn, q0, Q, CK, c0);
    stage_memory_tile<T, KC, NT_DS>(Bs, LD_CHUNK, kn, tile, M, hw, sk_slot, sk_pos, c0);
    __syncthreads();
    mma_tf32::warp_tile_32x32<true, true, EXACT, EXACT, KC>(s, As, LD_CHUNK, Bs, LD_CHUNK,
                                                            wr, wc);
  }
  for (int c0 = 0; c0 < Cv; c0 += KC) {
    __syncthreads();
    stage_query_rows<T, KC, NT_DS>(As, LD_CHUNK, don, q0, Q, Cv, c0);
    stage_memory_tile<T, KC, NT_DS>(Bs, LD_CHUNK, vn, tile, M, hw, sv_slot, sv_pos, c0);
    __syncthreads();
    mma_tf32::warp_tile_32x32<true, true, EXACT, EXACT, KC>(dp, As, LD_CHUNK, Bs, LD_CHUNK,
                                                            wr, wc);
  }

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long blk = (((long long)n * nt + it) * gridDim.x * BQ + q0) * BM;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + 16 * mi + 8 * h + g;
        const int c = wc + 8 * nj + 2 * t;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // lse = +inf (no valid position, or a row past Q) gives exp(-inf) = 0
          p[e] = valid_s[c + e] > 0.f ? expf(s[mi][nj][2 * h + e] * scale - lse_s[r]) : 0.f;
          ds[e] = p[e] * (dp[mi][nj][2 * h + e] - d_s[r]);
        }
        store2(pbuf + blk + r * BM + c, p[0], p[1]);
        store2(dsbuf + blk + r * BM + c, ds[0], ds[1]);
      }
}

// (2) One 128-column slice of dV (slices 0 .. Cv/128 - 1) or dK (the last
// slice) of one compacted active tile.
template <typename T>
__global__ void __launch_bounds__(NT_ACC, 2) flash_read_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ dout, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, const float* __restrict__ pbuf,
    const float* __restrict__ dsbuf, T* __restrict__ dk, T* __restrict__ dv,
    int Q, int Cv, int nt, float scale) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  const int it = blockIdx.x;
  const int cs = blockIdx.y;
  const int n = blockIdx.z;
  if (it >= counts[n]) return;
  const int tile = order[n * nt + it];
  const bool key = cs == Cv / CS;
  const int nqb = (Q + BQ - 1) / BQ;
  const float* A = (key ? dsbuf : pbuf) + ((long long)n * nt + it) * nqb * BQ * BM;
  const T* B = key ? q + (long long)n * Q * CK : dout + (long long)n * Q * Cv;
  const int width = key ? CK : Cv;
  const int c0 = key ? 0 : cs * CS;

  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // BQ x LD_PT: P or dS, [query][position]
  float* Bs = As + BQ * LD_PT;                    // BQ x LD_SLICE: dO or q slice

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 32;  // memory positions of this warp's tile
  const int wc = (warp & 3) * 32;   // columns of this warp's tile

  float acc[2][4][4] = {};
  for (int qb = 0; qb < nqb; ++qb) {
    __syncthreads();  // the previous query block's reads of As / Bs are done
    stage_scratch<NT_ACC>(As, LD_PT, A + (long long)qb * BQ * BM);
    stage_query_rows<T, CS, NT_ACC>(Bs, LD_SLICE, B, qb * BQ, Q, width, c0);
    __syncthreads();
    mma_tf32::warp_tile_32x32<false, false, false, EXACT, BQ>(acc, As, LD_PT, Bs, LD_SLICE,
                                                              wm, wc);
  }

  T* out = key ? dk : dv;
  const int ld = key ? CK : Cv;
  const float mult = key ? scale : 1.f;
  const long long base = ((long long)n * nt + tile) * BM;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + 16 * mi + 8 * h + g;
        const int c = c0 + wc + 8 * nj + 2 * t;
        store2(out + (base + m) * ld + c, acc[mi][nj][2 * h] * mult,
               acc[mi][nj][2 * h + 1] * mult);
      }
}

// (3) dQ of 64 query rows, over the row's listed active tiles.
template <typename T>
__global__ void __launch_bounds__(NT_ACC, 2) flash_read_bwd_dq_kernel(
    const T* __restrict__ k, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, const float* __restrict__ dsbuf, T* __restrict__ dq,
    int Q, int S, int hw, int nt, long long sk_n, long long sk_slot, long long sk_pos,
    float scale) {
  constexpr bool EXACT = std::is_same<T, __nv_bfloat16>::value;
  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int Qp = gridDim.x * BQ;
  const int M = S * hw;

  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // BQ x LD_DS: dS rows
  float* Bs = As + BQ * LD_DS;                    // BM x LD_SLICE: K tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wq = (warp >> 2) * 32;  // query rows of this warp's tile
  const int wc = (warp & 3) * 32;   // channels of this warp's tile
  const T* kn = k + n * sk_n;

  float acc[2][4][4] = {};
  const int n_active = counts[n];
  for (int it = 0; it < n_active; ++it) {
    const int tile = order[n * nt + it];
    __syncthreads();  // the previous tile's reads of As / Bs are done
    stage_scratch<NT_ACC>(As, LD_DS, dsbuf + (((long long)n * nt + it) * Qp + q0) * BM);
    stage_memory_tile<T, CK, NT_ACC>(Bs, LD_SLICE, kn, tile, M, hw, sk_slot, sk_pos, 0);
    __syncthreads();
    mma_tf32::warp_tile_32x32<true, false, false, EXACT, BM>(acc, As, LD_DS, Bs, LD_SLICE,
                                                             wq, wc);
  }

  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wq + 16 * mi + 8 * h + g;
      if (row >= Q) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        store2(dq + ((long long)n * Q + row) * CK + wc + 8 * nj + 2 * t,
               acc[mi][nj][2 * h] * scale, acc[mi][nj][2 * h + 1] * scale);
    }
}

template <typename T>
cudaError_t set_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(flash_read_bwd_ds_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_DS_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_read_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKDV_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_read_bwd_dq_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ_BYTES);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* slot_valid,
           const int32_t* order, const int32_t* counts, const void* dout, const float* lse,
           const float* dd, void* dq, void* dk, void* dv, float* pbuf, float* dsbuf, int N,
           int Q, int S, int hw, int Cv, int nt, long long sk_n, long long sk_slot,
           long long sk_pos, long long sv_n, long long sv_slot, long long sv_pos, float scale,
           cudaStream_t stream) {
  cudaError_t err = set_smem_limits<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  const int nqb = (Q + BQ - 1) / BQ;
  flash_read_bwd_ds_kernel<T><<<dim3(nqb, nt, N), NT_DS, SMEM_DS_BYTES, stream>>>(
      qt, kt, vt, slot_valid, order, counts, ot, lse, dd, pbuf, dsbuf, Q, S, hw, Cv, nt,
      sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_read_bwd_dkdv_kernel<T><<<dim3(nt, Cv / CS + 1, N), NT_ACC, SMEM_DKDV_BYTES, stream>>>(
      qt, ot, order, counts, pbuf, dsbuf, static_cast<T*>(dk), static_cast<T*>(dv), Q, Cv, nt,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_read_bwd_dq_kernel<T><<<dim3(nqb, N), NT_ACC, SMEM_DQ_BYTES, stream>>>(
      kt, order, counts, dsbuf, static_cast<T*>(dq), Q, S, hw, nt, sk_n, sk_slot, sk_pos,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout, dq are contiguous (N, Q, C);
// dk / dv are contiguous (N, nt * 64, C) and only the listed active tiles'
// rows are written. pbuf / dsbuf are f32 scratch of (N, nt, Qp, 64), Qp = Q
// rounded up to 64; the kernels write them before they read them. K/V
// strides are in elements, channels contiguous. Cv must be 128, 256 or 512.
// Returns the first CUDA error of the three launches.
extern "C" int flash_read_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* slot_valid,
    const void* order, const void* counts, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv, void* pbuf, void* dsbuf,
    int N, int Q, int S, int hw, int Cv, int nt,
    long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale, void* stream) {
  if (Cv != 128 && Cv != 256 && Cv != 512) return static_cast<int>(cudaErrorInvalidValue);
  const auto* sv = static_cast<const uint8_t*>(slot_valid);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* ct = static_cast<const int32_t*>(counts);
  const auto* ls = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dd);
  auto* pb = static_cast<float*>(pbuf);
  auto* db = static_cast<float*>(dsbuf);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, sv, od, ct, dout, ls, d, dq, dk, dv, pb, db, N, Q, S, hw, Cv,
                         nt, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sv, od, ct, dout, ls, d, dq, dk, dv, pb, db, N, Q,
                                 S, hw, Cv, nt, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Compile-time constants the Python wrapper checks against and reports.
extern "C" int flash_read_bwd_tile() { return BM; }
extern "C" int flash_read_bwd_smem_bytes() {
  const int a = SMEM_DS_BYTES > SMEM_DKDV_BYTES ? SMEM_DS_BYTES : SMEM_DKDV_BYTES;
  return a > SMEM_DQ_BYTES ? a : SMEM_DQ_BYTES;
}
