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
// Design. The Pallas grid (N, tiles) carries m/l/acc in VMEM from one grid
// step to the next; Hopper blocks run unordered, so here one block owns
// (64 query rows, 128 value columns, n) and loops over the row's active
// tiles itself, keeping the online-softmax state in registers. Per tile:
// stage K through shared memory, S = Q K^T * scale + bias in f32 FMA,
// online-softmax update, stage the V slice through the same buffer,
// acc += P V. Inputs are f32 or bf16; shared memory and all arithmetic are
// f32, so one code path serves both types.
//
// Bound. Work is 2 N Q M_active (Ck + Cv) FLOP against the K/V bytes of the
// active tiles read once: at the main-path shapes (Q = 1620, Ck = 128,
// Cv = 512) the intensity is about Q = 1620 FLOP per byte, far above the
// H100's ridge (~295 in bf16), so the read is bound by operations. This
// first version uses CUDA-core FMA (and recomputes Q K^T once per value
// slice); tensor-core mma/wgmma with TMA staging is the known next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_read_fwd.so flash_read_fwd.cu
// Bound from Python with ctypes (rmnet_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BM = 64;        // memory positions per kernel tile
constexpr int CK = 128;       // key width
constexpr int CVB = 128;      // value columns per block
constexpr int NTHREADS = 256; // 16 x 16 thread grid
constexpr int RS = CK + 4;    // padded row stride (floats) of the Q and K/V buffers
constexpr int PS = BM + 4;    // padded row stride (floats) of the P buffer
constexpr float NEG = -1e30f;

constexpr int SMEM_FLOATS = BQ * RS + BM * RS + BQ * PS + BM;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

static_assert(CVB + 4 <= RS, "V slice must fit the K/V row stride");

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
// memory position tile * BM + r of object row n; channels c0 .. c0 + 127.
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) flash_read_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ slot_valid, const int32_t* __restrict__ order,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ zs,
    T* __restrict__ out, float* __restrict__ lse,
    int Q, int S, int hw, int Cv, int nt,
    long long sq_n, long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x RS
  float* KV = Qs + BQ * RS;                      // BM x RS (K, then the V slice)
  float* Ps = KV + BM * RS;                      // BQ x PS
  float* valid_s = Ps + BQ * PS;                 // BM

  const int n = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int cv0 = blockIdx.y * CVB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty + 16 i
  const int tx = tid & 15;  // S columns tx + 16 j; acc columns tx * 8 .. + 7
  const int M = S * hw;

  const T* qn = q + n * sq_n;
  const T* kn = k + n * sk_n;
  const T* vn = v + n * sv_n;

  // query block, zero rows past Q
  for (int e = tid * 4; e < BQ * CK; e += NTHREADS * 4) {
    const int r = e >> 7;
    const int c = e & 127;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q) val = load4(qn + (long long)(q0 + r) * CK + c);
    *reinterpret_cast<float4*>(Qs + r * RS + c) = val;
  }

  float m_i[4], l_i[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int n_active = counts[n];
  for (int it = 0; it < n_active; ++it) {
    const int tile = order[n * nt + it];
    __syncthreads();  // previous tile's P V reads of KV / Ps are done
    stage_memory_tile(KV, kn, tile, M, hw, sk_slot, sk_pos, 0);
    if (tid < BM) {
      const int p = tile * BM + tid;
      valid_s[tid] = (p < M && slot_valid[n * S + p / hw]) ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < CK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * RS + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(KV + (tx + 16 * j) * RS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                     a[i].w * b[j].w;
    }

    // online softmax; the 16 threads of a row sit in one half-warp
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid_s[tx + 16 * j] > 0.f ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      alpha[i] = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha[i] + sum;
      m_i[i] = m_new;
    }
    __syncthreads();  // all S reads of K done, P written

    stage_memory_tile(KV, vn, tile, M, hw, sv_slot, sv_pos, cv0);
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 i, columns tx * 8 .. + 7
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha[i];
#pragma unroll 2
    for (int mm = 0; mm < BM; mm += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + mm);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = KV + (mm + u) * RS + tx * 8;
        const float4 v0 = reinterpret_cast<const float4*>(vrow)[0];
        const float4 v1 = reinterpret_cast<const float4*>(vrow)[1];
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

  // closed-form mass of the skipped valid zero-score positions, the
  // all-invalid guard, output and log-sum-exp (flash_attention.py:98-114)
  const float z = static_cast<float>(zs[n]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float m = m_i[i];
    const float m2 = z > 0.f ? fmaxf(m, 0.f) : m;
    const float alpha = expf(m - m2);
    const float l_raw = l_i[i] * alpha + z * expf(-m2);
    const float l = l_raw > 0.f ? l_raw : 1.f;
    if (row < Q) {
      float o[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c] = acc[i][c] * alpha / l;
      store8(out + ((long long)n * Q + row) * Cv + cv0 + tx * 8, o);
      if (blockIdx.y == 0 && tx == 0)
        lse[(long long)n * Q + row] = l_raw > 0.f ? m2 + logf(l) : INFINITY;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* slot_valid,
           const int32_t* order, const int32_t* counts, const int32_t* zs,
           void* out, float* lse, int N, int Q, int S, int hw, int Cv, int nt,
           long long sq_n, long long sk_n, long long sk_slot, long long sk_pos,
           long long sv_n, long long sv_slot, long long sv_pos, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_read_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + BQ - 1) / BQ, Cv / CVB, N);
  flash_read_fwd_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      slot_valid, order, counts, zs, static_cast<T*>(out), lse, Q, S, hw, Cv, nt,
      sq_n, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; channels are
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int flash_read_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* slot_valid,
    const void* order, const void* counts, const void* zs, void* out, void* lse,
    int N, int Q, int S, int hw, int Cv, int nt,
    long long sq_n, long long sk_n, long long sk_slot, long long sk_pos,
    long long sv_n, long long sv_slot, long long sv_pos, float scale, void* stream) {
  const auto* sv = static_cast<const uint8_t*>(slot_valid);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* ct = static_cast<const int32_t*>(counts);
  const auto* z = static_cast<const int32_t*>(zs);
  auto* l = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, sv, od, ct, z, out, l, N, Q, S, hw, Cv, nt, sq_n, sk_n,
                         sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sv, od, ct, z, out, l, N, Q, S, hw, Cv, nt,
                                 sq_n, sk_n, sk_slot, sk_pos, sv_n, sv_slot, sv_pos, scale,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Compile-time constants the Python wrapper checks against and reports.
extern "C" int flash_read_fwd_tile() { return BM; }
extern "C" int flash_read_fwd_smem_bytes() { return SMEM_BYTES; }
