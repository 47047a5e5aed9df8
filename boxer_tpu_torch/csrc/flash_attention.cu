// Online-softmax attention forward: out = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel `flash_attention`
// (boxer_tpu/ops/pallas/flash_attention.py, `_flash_kernel`). Same rules:
// running max and sum in f32, an optional additive f32 key mask (BH, Lkv),
// a row whose sum is 0 outputs 0, and the output is in q's dtype. Ragged
// sequence edges are skipped by bounds checks rather than padded.
//
// What bounds it on an H100: at the decoder's shape (BH=8, L=300, D=32) the
// whole problem is 92 MFLOP over 0.6 MB, so it is neither compute- nor
// memory-bound; it is bound by the parallelism one launch exposes (80 warps
// for 132 SMs) and by the serial chain of FMAs per query row. This first
// design keeps it simple: one thread per query row with q and the f32
// accumulator in registers, K and V tiles staged in shared memory as f32 and
// read by broadcast (every lane reads the same key), scores taken 16 keys at
// a time so the rescale by the running max happens once per 16 keys. Both
// products (q k^T and p v) are FMA loops in this kernel. A later version can
// split D across lanes or use mma for the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 32;  // query rows per block (one thread each)
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, int lq, int lkv, float scale) {
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];
  __shared__ float ms[kBlockK];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < lq;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(q[(static_cast<long long>(bh) * lq + row) * D + d])
                   : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  const T* kb = k + static_cast<long long>(bh) * lkv * D;
  const T* vb = v + static_cast<long long>(bh) * lkv * D;
  for (int kv0 = 0; kv0 < lkv; kv0 += kBlockK) {
    const int n = min(kBlockK, lkv - kv0);
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D, d = i % D;
      const bool in = j < n;
      ks[j][d] = in ? to_f32(kb[static_cast<long long>(kv0 + j) * D + d]) : 0.f;
      vs[j][d] = in ? to_f32(vb[static_cast<long long>(kv0 + j) * D + d]) : 0.f;
    }
    for (int j = threadIdx.x; j < kBlockK; j += kBlockQ) {
      ms[j] = (mask != nullptr && j < n)
                  ? mask[static_cast<long long>(bh) * lkv + kv0 + j]
                  : 0.f;
    }
    __syncthreads();

    if (active) {
      for (int j0 = 0; j0 < n; j0 += kChunk) {
        float s[kChunk];
        float m_new = m_run;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          if (j0 + jj < n) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) dot += qr[d] * ks[j0 + jj][d];
            s[jj] = dot * scale + ms[j0 + jj];
            m_new = fmaxf(m_new, s[jj]);
          } else {
            s[jj] = -INFINITY;
          }
        }
        const float alpha = expf(m_run - m_new);
        l_run *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float p = expf(s[jj] - m_new);
          l_run += p;
          if (j0 + jj < n) {
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] += p * vs[j0 + jj][d];
          }
        }
        m_run = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float l_inv = l_run == 0.f ? 1.f : 1.f / l_run;
    T* o = out + (static_cast<long long>(bh) * lq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = from_f32<T>(acc[d] * l_inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int bh, int lq, int lkv, int d, float scale,
           cudaStream_t stream) {
  if (d != 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  const dim3 block(kBlockQ);
  flash_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lq, lkv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH, Lq, D), k, v: (BH, Lkv, D) in bf16 (is_bf16=1) or f32, contiguous;
// mask: (BH, Lkv) f32 or null; out: (BH, Lq, D) in q's dtype, all on card
// `device`. D must be 32, the head width of every shipped config. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const float* mask,
                                   void* out, int is_bf16, int bh, int lq,
                                   int lkv, int d, float scale, void* stream) {
  if (bh <= 0 || lq <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, mask, out, bh, lq, lkv, d, scale, s);
  }
  return launch<float>(q, k, v, mask, out, bh, lq, lkv, d, scale, s);
}
