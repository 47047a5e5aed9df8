// Fused quad-table gather + bilinear corner combine + P-tap reduce.
//
//   out[m, :] = sum_p sum_c w[p, c, m] * table[idx[t(p, m)], c*ch:(c+1)*ch]
//
// Replaces the TPU kernels `fused_combine_reduce_raw` (K1),
// `fused_combine_reduce` (K2) and `fused_combine_reduce_mmajor` (K8)
// (boxer_tpu/ops/pallas/combine_reduce.py) together with the `jnp.take`
// that feeds them (boxer_tpu/ops/box_attention.py,
// `_box_attention_qminor_folded`). On the TPU the gathered rows are a
// materialised (P*M, 4*ch) tensor in device memory; here each row is read
// straight from the quad table and never written back.
//
// Two weight modes:
//   raw: lx, ly, wt f32 in idx's shape; corner weights formed in the kernel
//        as (1-lx)(1-ly)wt, lx(1-ly)wt, (1-lx)ly wt, lx ly wt  (K1, K8)
//   w4:  precomputed w4 (P, 4, M) f32                          (K2)
// and two tap orders (raw mode only for m-major):
//   p-major: idx (P, M), t(p, m) = p*M + m                     (K1, K2)
//   m-major: idx (M, P), t(p, m) = m*P + p, the P taps of an output
//            contiguous in idx and the weights                 (K8)
// The TPU's m-major kernel exists to reduce each output's P taps inside one
// VMEM block without an accumulator carried across grid steps; on the card
// every order keeps the P-sum of an output row in one warp's registers, so
// the order changes only which index and weight addresses a warp reads.
//
// What bounds it on an H100: device-memory bytes. Each tap reads one
// 4*ch-wide table row (256 B in bf16) plus 12-16 B of index and weights,
// and does 4*ch FMAs on it, far below the card's compute line. The table
// rows are gathered at random, so the design keeps each row read whole by
// one warp (one lane per channel, 4 coalesced 64 B reads in bf16) and keeps
// the P-sum in a register, writing each output row once. A later version
// can widen the loads and spread the index/weight loads across lanes (in
// m-major order a warp's P indices and weights are contiguous, so one
// coalesced load could fetch them all).
//
// Indices are not clamped: the caller clamps them. An index outside
// [0, rows) traps, which surfaces as a launch failure at the next sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;            // channels per head; one lane each
constexpr int kWarpsPerBlock = 8;  // output rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kRaw, bool kMmajor>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quad_sample_reduce_kernel(const T* __restrict__ table, long long rows,
                          const int* __restrict__ idx,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ c,
                          float* __restrict__ out, int p_taps, int m_rows) {
  const int lane = threadIdx.x & 31;
  const long long m =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= m_rows) return;

  float acc = 0.f;
  for (int p = 0; p < p_taps; ++p) {
    const long long t = kMmajor ? m * p_taps + p
                                : static_cast<long long>(p) * m_rows + m;
    const int r = __ldg(idx + t);
    if (r < 0 || r >= rows) __trap();
    float w0, w1, w2, w3;
    if (kRaw) {
      const float lx = __ldg(a + t), ly = __ldg(b + t), wt = __ldg(c + t);
      w0 = (1.f - lx) * (1.f - ly) * wt;
      w1 = lx * (1.f - ly) * wt;
      w2 = (1.f - lx) * ly * wt;
      w3 = lx * ly * wt;
    } else {
      const long long base = static_cast<long long>(p) * 4 * m_rows + m;
      w0 = __ldg(a + base);
      w1 = __ldg(a + base + m_rows);
      w2 = __ldg(a + base + 2LL * m_rows);
      w3 = __ldg(a + base + 3LL * m_rows);
    }
    const T* row = table + static_cast<long long>(r) * (4 * kCh) + lane;
    acc += w0 * to_f32(row[0 * kCh]);
    acc += w1 * to_f32(row[1 * kCh]);
    acc += w2 * to_f32(row[2 * kCh]);
    acc += w3 * to_f32(row[3 * kCh]);
  }
  out[m * kCh + lane] = acc;
}

template <typename T>
void launch(const void* table, long long rows, const int* idx, const float* a,
            const float* b, const float* c, int raw, int mmajor, float* out,
            int p_taps, int m_rows, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((m_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* t = static_cast<const T*>(table);
  if (mmajor) {
    quad_sample_reduce_kernel<T, true, true><<<grid, block, 0, stream>>>(
        t, rows, idx, a, b, c, out, p_taps, m_rows);
  } else if (raw) {
    quad_sample_reduce_kernel<T, true, false><<<grid, block, 0, stream>>>(
        t, rows, idx, a, b, c, out, p_taps, m_rows);
  } else {
    quad_sample_reduce_kernel<T, false, false><<<grid, block, 0, stream>>>(
        t, rows, idx, a, b, c, out, p_taps, m_rows);
  }
}

}  // namespace

// table: (rows, 4*32) bf16 (table_is_bf16=1) or f32; idx: (P, M) int32, or
// (M, P) with mmajor=1. raw=1: a, b, c = lx, ly, wt f32 in idx's shape;
// raw=0: a = w4 (P, 4, M) f32 (p-major only). out: (M, 32) f32, all on card
// `device`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for m-major with raw=0.
extern "C" int quad_sample_reduce(int device, const void* table,
                                  int table_is_bf16, long long rows,
                                  const int* idx, const float* a,
                                  const float* b, const float* c, int raw,
                                  int mmajor, float* out, int p_taps,
                                  int m_rows, void* stream) {
  if (mmajor && !raw) return static_cast<int>(cudaErrorInvalidValue);
  if (m_rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_is_bf16) {
    launch<__nv_bfloat16>(table, rows, idx, a, b, c, raw, mmajor, out, p_taps,
                          m_rows, s);
  } else {
    launch<float>(table, rows, idx, a, b, c, raw, mmajor, out, p_taps, m_rows,
                  s);
  }
  return static_cast<int>(cudaGetLastError());
}
