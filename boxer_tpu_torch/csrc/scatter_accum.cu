// Quad-row cotangent scatter (the d_table of the sampling op), three modes.
//
// Weighted (the corner expansion of a 32-channel g happens in the kernel):
//
//   out[idx[p, m], c*32 + i] += w4[p, c, m] * g[grow(p, m), i]
//
//   grow(p, m) = m      when g is shared by the P taps of an output row (box
//                       attention: g is d_out, K5);
//   grow(p, m) = p*M+m  when g holds one row per tap (instance attention, K6).
//
// Rows (the payload is the whole 128-wide quad-row cotangent, K7a/K7b):
//
//   out[idx[t], j] += payload[t, j],  j in [0, 128)
//
// Replaces the TPU kernels `scatter_add_rows_weighted` (K5),
// `scatter_add_rows_pmajor_weighted` (K6), `scatter_add_rows` (K7a) and
// `scatter_add_rows_pmajor` (K7b) in boxer_tpu/ops/pallas/scatter_accum.py.
// The TPU kernels keep a whole f32 accumulator per (batch*head) slice in
// VMEM and walk the taps serially; on the card the taps run in parallel and
// meet in device memory through f32 atomics, so indices are global rows of
// the flat per-level table and the TPU's dump rows and bh-relative indexing
// are not needed. K7a and K7b differ only in the caller's index layout
// ((N,) or p-major (P, M)); both reach the rows mode with taps flattened.
//
// What bounds it on an H100: the atomics. A weighted tap reads its
// 32-channel g row (64 B in bf16, 128 B in f32), 16 B of corner weights and
// an index; a rows tap reads its 128-channel payload row (256 B in bf16,
// 512 B in f32) and an index. Either issues 4 warp-wide 128 B f32
// reductions into one 512 B table row. Random rows spread the reductions
// over L2 with little contention; rows that many taps share (neighbouring
// queries sample the same pixels) serialise there. The design keeps it
// simple: one warp per tap, each lane owning channels lane + 32*c (so every
// load and every reduction instruction is coalesced across the warp), the
// corner expansion in registers in the weighted modes (the (taps, 128)
// quad-row cotangent is never written), 4 `atomicAdd`s a lane. Sorting taps
// by row, warp aggregation, vector atomics or shared-memory staging are
// later work.
//
// An index outside [0, rows) traps, which surfaces as a launch failure at
// the next sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;            // channels per head; one lane each
constexpr int kWarpsPerBlock = 8;  // taps per block

enum Mode { kShared = 0, kPerTap = 1, kRows = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// g: (M, 32) in kShared, (P*M, 32) in kPerTap, (P*M, 128) payload in kRows;
// w4 is unused in kRows.
template <typename G, int kMode>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_accum_kernel(const int* __restrict__ idx, const G* __restrict__ g,
                     const float* __restrict__ w4, float* __restrict__ out,
                     long long rows, int p_taps, int m_rows) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= static_cast<long long>(p_taps) * m_rows) return;

  const int r = __ldg(idx + t);
  if (r < 0 || r >= rows) __trap();
  float* row = out + static_cast<long long>(r) * (4 * kCh) + lane;
  if constexpr (kMode == kRows) {
    const G* src = g + t * (4 * kCh) + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) atomicAdd(row + c * kCh, to_f32(src[c * kCh]));
  } else {
    const long long p = t / m_rows;
    const long long m = t - p * m_rows;
    const float gv = to_f32(g[(kMode == kPerTap ? t : m) * kCh + lane]);
    const float* w = w4 + p * 4 * m_rows + m;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float wc = __ldg(w + static_cast<long long>(c) * m_rows);
      atomicAdd(row + c * kCh, wc * gv);
    }
  }
}

template <typename G>
void launch(int mode, const int* idx, const void* g, const float* w4,
            float* out, long long rows, int p_taps, int m_rows,
            cudaStream_t stream) {
  const long long taps = static_cast<long long>(p_taps) * m_rows;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((taps + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const G* gp = static_cast<const G*>(g);
  if (mode == kShared) {
    scatter_accum_kernel<G, kShared><<<grid, block, 0, stream>>>(
        idx, gp, w4, out, rows, p_taps, m_rows);
  } else if (mode == kPerTap) {
    scatter_accum_kernel<G, kPerTap><<<grid, block, 0, stream>>>(
        idx, gp, w4, out, rows, p_taps, m_rows);
  } else {
    scatter_accum_kernel<G, kRows><<<grid, block, 0, stream>>>(
        idx, gp, w4, out, rows, p_taps, m_rows);
  }
}

int run(int device, int mode, const int* idx, const void* g, int g_is_bf16,
        const float* w4, float* out, long long rows, int p_taps, int m_rows,
        void* stream) {
  if (p_taps <= 0 || m_rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    launch<__nv_bfloat16>(mode, idx, g, w4, out, rows, p_taps, m_rows, s);
  } else {
    launch<float>(mode, idx, g, w4, out, rows, p_taps, m_rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Weighted modes. idx: (P, M) int32 global table rows; g: (M, 32)
// (per_tap=0) or (P*M, 32) (per_tap=1), bf16 (g_is_bf16=1) or f32; w4:
// (P, 4, M) f32; out: (rows, 4*32) f32, zeroed by the caller; all on card
// `device`. Returns cudaGetLastError() after the launch.
extern "C" int scatter_accum(int device, const int* idx, const void* g,
                             int g_is_bf16, int per_tap, const float* w4,
                             float* out, long long rows, int p_taps,
                             int m_rows, void* stream) {
  return run(device, per_tap ? kPerTap : kShared, idx, g, g_is_bf16, w4, out,
             rows, p_taps, m_rows, stream);
}

// Rows mode. idx: (n_taps,) int32 global table rows; payload: (n_taps,
// 4*32), bf16 (payload_is_bf16=1) or f32; out: (rows, 4*32) f32, zeroed by
// the caller; all on card `device`. Returns cudaGetLastError() after the
// launch.
extern "C" int scatter_rows(int device, const int* idx, const void* payload,
                            int payload_is_bf16, float* out, long long rows,
                            int n_taps, void* stream) {
  return run(device, kRows, idx, payload, payload_is_bf16, nullptr, out, rows,
             1, n_taps, stream);
}
