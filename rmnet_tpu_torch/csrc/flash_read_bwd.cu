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
// whole (Qp, Ck) dQ accumulator in VMEM; Hopper blocks run unordered, so the
// work is split into two kernels, both deterministic and without atomics:
//   (a) dK/dV: one block per (compacted active tile, 128-column value slice,
//       row n). It loops over blocks of 64 query rows, recomputes s and p
//       from lse, and writes its tile's dV slice and a 1/(Cv/128) share of
//       the tile's dK columns once. dS needs dP = dO V^T reduced over all Cv
//       columns, so each block loops over the Cv slices for dP (staged
//       through shared memory) and keeps only its own slice's dV in
//       registers: s and dP are recomputed once per value slice.
//   (b) dQ: one block per (64 query rows, row n), looping over the row's
//       active tiles with the 64 x 128 dQ accumulator in registers.
// Blocks past counts[n] return at once, so the launch needs no host sync.
// Inputs are f32 or bf16, widened to f32 as they are staged; shared memory
// and all arithmetic are f32, so one code path serves both types; the
// gradients are stored in the input type.
//
// Bound. Work is 2 N Q M_active (3 Ck + 2 Cv) FLOP against the active K/V
// bytes (read, and their gradients written, once) plus q, dO, dQ, lse, D: at
// the training read (Q = 900, Ck = 128, Cv = 512) the intensity is about
// Q = 900 FLOP per byte, above the H100's ridge, so the backward is bound by
// operations. This first version uses CUDA-core FMA and executes about 3x
// the minimal FLOP of its tiles (s and dP recomputed per value slice and
// again in (b));
// tensor-core mma/wgmma with TMA staging is the known next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_read_bwd.so flash_read_bwd.cu
// Bound from Python with ctypes (rmnet_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per step
constexpr int BM = 64;        // memory positions per kernel tile
constexpr int CK = 128;       // key width
constexpr int CVB = 128;      // value columns per slice
constexpr int NTHREADS = 256; // 16 x 16 thread grid
constexpr int RS = CK + 4;    // padded row stride (floats) of the 128-wide buffers
constexpr int PS = BM + 4;    // padded row stride (floats) of the P / dS buffers

// (a): K tile, q block, dO slice, V slice, P, dS, valid, lse, D
constexpr int SMEM_A_FLOATS = BM * RS + BQ * RS + BQ * RS + BM * RS + 2 * BQ * PS + BM + 2 * BQ;
// (b): q block, K tile, dO slice, V slice, dS, valid, lse, D
constexpr int SMEM_B_FLOATS = BQ * RS + BM * RS + BQ * RS + BM * RS + BQ * PS + BM + 2 * BQ;
constexpr int SMEM_A_BYTES = SMEM_A_FLOATS * 4;
constexpr int SMEM_B_BYTES = SMEM_B_FLOATS * 4;

// Load 4 consecutive elements as floats (16-byte aligned f32, 8-byte bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Store 8 consecutive floats as the output type.
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162 t;
  t = __floats2bfloat162_rn(v[0], v[1]); raw.x = *reinterpret_cast<uint32_t*>(&t);
  t = __floats2bfloat162_rn(v[2], v[3]); raw.y = *reinterpret_cast<uint32_t*>(&t);
  t = __floats2bfloat162_rn(v[4], v[5]); raw.z = *reinterpret_cast<uint32_t*>(&t);
  t = __floats2bfloat162_rn(v[6], v[7]); raw.w = *reinterpret_cast<uint32_t*>(&t);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Stage a 64 x 128 tile of memory rows into shared memory as f32. Row r is
// memory position tile * BM + r of object row n (zero past M); channels
// c0 .. c0 + 127.
template <typename T>
__device__ __forceinline__ void stage_memory_tile(
    float* dst, const T* base, int tile, int M, int hw,
    long long s_slot, long long s_pos, int c0) {
  for (int e = threadIdx.x * 4; e < BM * 128; e += NTHREADS * 4) {
    const int r = e >> 7;
    const int c = e & 127;
    const int p = tile * BM + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < M) {
      const int slot = p / hw;
      const int within = p - slot * hw;
      val = load4(base + slot * s_slot + within * s_pos + c0 + c);
    }
    *reinterpret_cast<float4*>(dst + r * RS + c) = val;
  }
}

// Stage 64 query rows q0 .. q0 + 63 (zero past Q) of a contiguous (Q, width)
// matrix, channels c0 .. c0 + 127, into shared memory as f32.
template <typename T>
__device__ __forceinline__ void stage_query_rows(
    float* dst, const T* base, int q0, int Q, int width, int c0) {
  for (int e = threadIdx.x * 4; e < BQ * 128; e += NTHREADS * 4) {
    const int r = e >> 7;
    const int c = e & 127;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q) val = load4(base + (long long)(q0 + r) * width + c0 + c);
    *reinterpret_cast<float4*>(dst + r * RS + c) = val;
  }
}

// acc[i][j] += sum_c A[ty + 16 i][c] * B[tx + 16 j][c] over 128 channels.
__device__ __forceinline__ void row_dot_128(float acc[4][4], const float* A, const float* B,
                                            int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < 128; kk += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * RS + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * RS + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z + a[i].w * b[j].w;
  }
}

// Stage the query-side row data of one block: lse (+inf past Q) and D.
__device__ __forceinline__ void stage_row_stats(float* lse_s, float* d_s, const float* lse,
                                                const float* dd, int q0, int Q) {
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < Q ? lse[row] : INFINITY;
    d_s[threadIdx.x] = row < Q ? dd[row] : 0.f;
  }
}

// s (scaled scores) and dP for rows ty + 16 i, positions tx + 16 j of one
// (query block, memory tile) pair -> p and dS, written to Ps / dSs (Ps may
// be null). Qs and Ks hold the query block and K tile; dO and V slices are
// staged through Ab / Bb, ending with the value slice `last`.
template <typename T>
__device__ __forceinline__ void probs_and_dscores(
    const float* Qs, const float* Ks, float* Ab, float* Bb, float* Ps, float* dSs,
    const float* valid_s, const float* lse_s, const float* d_s,
    const T* don, const T* vn, int q0, int Q, int Cv, int tile, int M, int hw,
    long long sv_slot, long long sv_pos, int last, float scale, int ty, int tx) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  row_dot_128(s, Qs, Ks, ty, tx);

  const int ns = Cv / CVB;
  for (int u = 0; u < ns; ++u) {
    const int sl = (last + 1 + u) % ns;
    if (u > 0) __syncthreads();  // previous slice's reads of Ab / Bb are done
    stage_query_rows(Ab, don, q0, Q, Cv, sl * CVB);
    stage_memory_tile(Bb, vn, tile, M, hw, sv_slot, sv_pos, sl * CVB);
    __syncthreads();
    row_dot_128(dp, Ab, Bb, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      // lse = +inf (no valid position, or a row past Q) gives exp(-inf) = 0
      const float p = valid_s[c] > 0.f ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * PS + c] = p;
      dSs[r * PS + c] = p * (dp[i][j] - d_s[r]);
    }
  }
}

// (a) dK / dV of one compacted active tile, one value slice.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) flash_read_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ slot_valid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    T* __restrict__ dk, T* __restrict__ dv,
    int Q, int S, int hw, int Cv, int nt,
    long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale) {
  const int it = blockIdx.x;
  const int cs = blockIdx.y;
  const int n = blockIdx.z;
  if (it >= counts[n]) return;
  const int tile = order[n * nt + it];

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // BM x RS
  float* Qs = Ks + BM * RS;                       // BQ x RS
  float* Ab = Qs + BQ * RS;                       // BQ x RS (dO slice)
  float* Bb = Ab + BQ * RS;                       // BM x RS (V slice)
  float* Ps = Bb + BM * RS;                       // BQ x PS
  float* dSs = Ps + BQ * PS;                      // BQ x PS
  float* valid_s = dSs + BQ * PS;                 // BM
  float* lse_s = valid_s + BM;                    // BQ
  float* d_s = lse_s + BQ;                        // BQ

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int M = S * hw;
  const int ns = Cv / CVB;
  const int kw = CK / ns;          // dK columns of this block: cs * kw .. + kw - 1
  const int kpos = tid >> 2;       // dK position of this thread
  const int kcol = (tid & 3) * 8;  // and its 8 columns within each 32-column chunk

  const T* qn = q + (long long)n * Q * CK;
  const T* don = dout + (long long)n * Q * Cv;
  const T* kn = k + n * sk_n;
  const T* vn = v + n * sv_n;

  stage_memory_tile(Ks, kn, tile, M, hw, sk_slot, sk_pos, 0);
  if (tid < BM) {
    const int p = tile * BM + tid;
    valid_s[tid] = (p < M && slot_valid[n * S + p / hw]) ? 1.f : 0.f;
  }

  float accv[4][8], acck[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) accv[i][c] = acck[i][c] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += BQ) {
    __syncthreads();  // the previous block's reads of Qs / Ab / Ps / dSs are done
    stage_query_rows(Qs, qn, q0, Q, CK, 0);
    stage_row_stats(lse_s, d_s, lse + (long long)n * Q, dd + (long long)n * Q, q0, Q);
    __syncthreads();
    probs_and_dscores(Qs, Ks, Ab, Bb, Ps, dSs, valid_s, lse_s, d_s, don, vn, q0, Q, Cv,
                      tile, M, hw, sv_slot, sv_pos, cs, scale, ty, tx);
    __syncthreads();  // P, dS written; Ab holds this block's dO slice

    // dV[pos ty + 16 i][tx * 8 + c] += sum_r P[r][pos] dO[r][c]
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float* orow = Ab + r * RS + tx * 8;
      const float4 o0 = reinterpret_cast<const float4*>(orow)[0];
      const float4 o1 = reinterpret_cast<const float4*>(orow)[1];
      const float oo[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[r * PS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 8; ++c) accv[i][c] += p * oo[c];
      }
    }
    // dK[kpos][cs * kw + 32 u + kcol + c] += sum_r dS[r][kpos] q[r][...]
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (32 * u >= kw) break;
      const int c0 = cs * kw + 32 * u + kcol;
      for (int r = 0; r < BQ; ++r) {
        const float ds = dSs[r * PS + kpos];
        const float4 a0 = *reinterpret_cast<const float4*>(Qs + r * RS + c0);
        const float4 a1 = *reinterpret_cast<const float4*>(Qs + r * RS + c0 + 4);
        acck[u][0] += ds * a0.x; acck[u][1] += ds * a0.y;
        acck[u][2] += ds * a0.z; acck[u][3] += ds * a0.w;
        acck[u][4] += ds * a1.x; acck[u][5] += ds * a1.y;
        acck[u][6] += ds * a1.z; acck[u][7] += ds * a1.w;
      }
    }
  }

  const long long base = (long long)n * nt * BM + (long long)tile * BM;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store8(dv + (base + ty + 16 * i) * Cv + cs * CVB + tx * 8, accv[i]);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (32 * u >= kw) break;
    float o[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) o[c] = acck[u][c] * scale;
    store8(dk + (base + kpos) * CK + cs * kw + 32 * u + kcol, o);
  }
}

// (b) dQ of 64 query rows, over the row's active tiles.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) flash_read_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ slot_valid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd, T* __restrict__ dq,
    int Q, int S, int hw, int Cv, int nt,
    long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x RS
  float* Ks = Qs + BQ * RS;                       // BM x RS
  float* Ab = Ks + BM * RS;                       // BQ x RS (dO slice)
  float* Bb = Ab + BQ * RS;                       // BM x RS (V slice)
  float* dSs = Bb + BM * RS;                      // BQ x PS
  float* valid_s = dSs + BQ * PS;                 // BM
  float* lse_s = valid_s + BM;                    // BQ
  float* d_s = lse_s + BQ;                        // BQ

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int M = S * hw;

  const T* qn = q + (long long)n * Q * CK;
  const T* don = dout + (long long)n * Q * Cv;
  const T* kn = k + n * sk_n;
  const T* vn = v + n * sv_n;

  stage_query_rows(Qs, qn, q0, Q, CK, 0);
  stage_row_stats(lse_s, d_s, lse + (long long)n * Q, dd + (long long)n * Q, q0, Q);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  const int n_active = counts[n];
  for (int it = 0; it < n_active; ++it) {
    const int tile = order[n * nt + it];
    __syncthreads();  // the previous tile's reads of Ks / dSs are done
    stage_memory_tile(Ks, kn, tile, M, hw, sk_slot, sk_pos, 0);
    if (tid < BM) {
      const int p = tile * BM + tid;
      valid_s[tid] = (p < M && slot_valid[n * S + p / hw]) ? 1.f : 0.f;
    }
    __syncthreads();
    probs_and_dscores(Qs, Ks, Ab, Bb, static_cast<float*>(nullptr), dSs, valid_s, lse_s,
                      d_s, don, vn, q0, Q, Cv, tile, M, hw, sv_slot, sv_pos, Cv / CVB - 1,
                      scale, ty, tx);
    __syncthreads();

    // dQ[ty + 16 i][tx * 8 + c] += sum_m dS[.][m] K[m][c]
#pragma unroll 4
    for (int m = 0; m < BM; ++m) {
      const float* krow = Ks + m * RS + tx * 8;
      const float4 k0 = reinterpret_cast<const float4*>(krow)[0];
      const float4 k1 = reinterpret_cast<const float4*>(krow)[1];
      const float kk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * PS + m];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] += ds * kk[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Q) {
      float o[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c] = acc[i][c] * scale;
      store8(dq + ((long long)n * Q + row) * CK + tx * 8, o);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* slot_valid,
           const int32_t* order, const int32_t* counts, const void* dout, const float* lse,
           const float* dd, void* dq, void* dk, void* dv, int N, int Q, int S, int hw,
           int Cv, int nt, long long sk_n, long long sk_slot, long long sk_pos,
           long long sv_n, long long sv_slot, long long sv_pos, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_read_bwd_dkdv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_A_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_read_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  flash_read_bwd_dkdv_kernel<T><<<dim3(nt, Cv / CVB, N), NTHREADS, SMEM_A_BYTES, stream>>>(
      qt, kt, vt, slot_valid, order, counts, ot, lse, dd, static_cast<T*>(dk),
      static_cast<T*>(dv), Q, S, hw, Cv, nt, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_read_bwd_dq_kernel<T><<<dim3((Q + BQ - 1) / BQ, N), NTHREADS, SMEM_B_BYTES, stream>>>(
      qt, kt, vt, slot_valid, order, counts, ot, lse, dd, static_cast<T*>(dq), Q, S, hw, Cv,
      nt, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout, dq are contiguous (N, Q, C);
// dk / dv are contiguous (N, nt * 64, C) and only the listed active tiles'
// rows are written. K/V strides are in elements, channels contiguous.
// Cv must be 128, 256 or 512. Returns the first CUDA error of the two launches.
extern "C" int flash_read_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* slot_valid,
    const void* order, const void* counts, const void* dout, const void* lse,
    const void* dd, void* dq, void* dk, void* dv,
    int N, int Q, int S, int hw, int Cv, int nt,
    long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale, void* stream) {
  if (Cv != 128 && Cv != 256 && Cv != 512) return static_cast<int>(cudaErrorInvalidValue);
  const auto* sv = static_cast<const uint8_t*>(slot_valid);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* ct = static_cast<const int32_t*>(counts);
  const auto* ls = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(dd);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, sv, od, ct, dout, ls, d, dq, dk, dv, N, Q, S, hw, Cv, nt,
                         sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sv, od, ct, dout, ls, d, dq, dk, dv, N, Q, S, hw,
                                 Cv, nt, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Compile-time constants the Python wrapper checks against and reports.
extern "C" int flash_read_bwd_tile() { return BM; }
extern "C" int flash_read_bwd_smem_bytes() { return SMEM_A_BYTES > SMEM_B_BYTES ? SMEM_A_BYTES : SMEM_B_BYTES; }
