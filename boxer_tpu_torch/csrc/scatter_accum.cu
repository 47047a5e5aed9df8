// Quad-row cotangent scatter (the backward of sampling), two kernels.
//
// Weighted (K5, K6): the corner expansion of a 32-channel g happens in the
// kernel, and the same pass returns the corner weights' cotangent:
//
//   d_table[idx[p, m], c*32 + i] += w4[p, c, m] * g[grow(p, m), i]
//   d_w4[p, c, m]                 = sum_i table[idx[p, m], c*32 + i] *
//                                         g[grow(p, m), i]
//
//   grow(p, m) = m      when g is shared by the P taps of an output row (box
//                       attention: g is d_out, K5);
//   grow(p, m) = p*M+m  when g holds one row per tap (instance attention, K6).
//
// Rows (K7a/K7b; the payload is the whole 128-wide quad-row cotangent):
//
//   d_table[idx[t], j] += payload[t, j],  j in [0, 128)
//
// Replace the TPU kernels `scatter_add_rows_weighted` (K5),
// `scatter_add_rows_pmajor_weighted` (K6), `scatter_add_rows` (K7a) and
// `scatter_add_rows_pmajor` (K7b) in boxer_tpu/ops/pallas/scatter_accum.py,
// and, in the weighted kernel, the XLA d_w4 beside them in the backward of
// `_sample_taps_vjp` (boxer_tpu/ops/box_attention.py:260-299). The TPU
// kernels keep a whole f32 accumulator per (batch*head) slice in VMEM and
// walk the taps serially; on the card the taps run in parallel and meet in
// device memory through f32 atomics, so indices are global rows of the flat
// per-level table and the TPU's dump rows and bh-relative indexing are not
// needed. K7a and K7b differ only in the caller's index layout.
//
// What bounds the weighted kernel on an H100: device-memory bytes and the
// atomics. At the encoder's level 0 (P=4, M=161,576, a 123,624-row table)
// it must read idx (2.6 MB), f32 g (20.7 MB), w4 (10.3 MB) and the distinct
// bf16 table rows (31.6 MB), and write d_w4 (10.3 MB) and the f32 d_table
// (63.3 MB): 139 MB, 0.041 ms at 3.35 TB/s. The design:
// - one warp per tap row, each lane owning 4 consecutive channels of the
//   128-wide row (corner lane / 8), so a tap's d_table update is one
//   warp-wide 512 B vector reduction, a 16-byte `atomicAdd(float4*)` a lane
//   (compute capability 9.x), where one lane per channel needs four 128 B
//   scalar reductions;
// - a block covers 32 consecutive outputs and 4 taps of each: it loads that
//   tile of idx and of the 4 corners' w4 with coalesced 128 B reads into
//   shared memory, and a warp walks the 4 taps of one output with g[m] in
//   registers (K5) and four taps' loads in flight;
// - d_w4 in the same pass: each lane reads its 4 channels of the tap's
//   table row (8 B in bf16), multiplies them by its 4 channels of g and the
//   8 lanes of a corner sum with three shuffles; the tile's d_w4 is
//   written back coalesced from shared memory. The (taps, 4, 32) f32
//   product that a plain d_w4 forms never exists. Either output can be
//   skipped (a null pointer).
// Rows that many taps share (neighbouring queries sample neighbouring
// pixels) serialise their reductions in L2; nothing is done about that
// here.
//
// The rows kernel: one warp per tap, each lane owning channels lane + 32*c
// (every load and reduction instruction coalesced across the warp), 4
// scalar `atomicAdd`s a lane.
//
// An index outside [0, rows) traps, which surfaces as a launch failure at
// the next sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;            // channels per head
constexpr int kWarpsPerBlock = 8;  // both kernels: 256 threads
constexpr int kTileM = 32;         // weighted: outputs per block
constexpr int kTileP = 4;          // weighted: taps of each output per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive values as f32 (16 B in f32, 8 B in bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// g: (M, 32) (kPerTap false) or (P*M, 32); d_table (rows, 128) or null;
// table (rows, 128) and d_w4 (P, 4, M), or both null.
template <typename G, typename T, bool kPerTap>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_weighted_kernel(const int* __restrict__ idx, const G* __restrict__ g,
                        const float* __restrict__ w4,
                        float* __restrict__ d_table, long long rows,
                        const T* __restrict__ table,
                        float* __restrict__ d_w4, int p_taps, int m_rows) {
  __shared__ int s_idx[kTileP][kTileM];
  __shared__ float s_w[kTileP][4][kTileM];
  __shared__ float s_dw[kTileP][4][kTileM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int p0 = blockIdx.y * kTileP;
  const int pc = min(kTileP, p_taps - p0);

  for (int e = tid; e < 5 * kTileP * kTileM; e += kWarpsPerBlock * 32) {
    const int ml = e % kTileM, which = (e / kTileM) % 5;
    const int pl = e / (kTileM * 5);
    const long long m = m0 + ml, p = p0 + pl;
    const bool ok = m < m_rows && pl < pc;
    if (which == 0) {
      s_idx[pl][ml] = ok ? __ldg(idx + p * m_rows + m) : 0;
    } else {
      s_w[pl][which - 1][ml] =
          ok ? __ldg(w4 + (p * 4 + which - 1) * m_rows + m) : 0.f;
    }
  }
  __syncthreads();

  const int corner = lane >> 3, ch = (lane & 7) * 4;
  for (int ml = warp; ml < kTileM; ml += kWarpsPerBlock) {
    const long long m = m0 + ml;
    if (m >= m_rows) break;
    float4 gs = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!kPerTap) gs = load4(g + m * kCh + ch);
    int r[kTileP];
    float w[kTileP];
    float4 gv[kTileP], tv[kTileP];
#pragma unroll
    for (int pl = 0; pl < kTileP; ++pl) {
      if (pl < pc) {
        r[pl] = s_idx[pl][ml];
        if (r[pl] < 0 || r[pl] >= rows) __trap();
        w[pl] = s_w[pl][corner][ml];
        gv[pl] = kPerTap
                     ? load4(g + (static_cast<long long>(p0 + pl) * m_rows +
                                  m) * kCh + ch)
                     : gs;
        if (d_w4)
          tv[pl] = load4(table + static_cast<long long>(r[pl]) * (4 * kCh) +
                         lane * 4);
      }
    }
#pragma unroll
    for (int pl = 0; pl < kTileP; ++pl) {
      if (pl < pc) {
        if (d_table) {
          const float4 v = make_float4(w[pl] * gv[pl].x, w[pl] * gv[pl].y,
                                       w[pl] * gv[pl].z, w[pl] * gv[pl].w);
          atomicAdd(reinterpret_cast<float4*>(
                        d_table + static_cast<long long>(r[pl]) * (4 * kCh) +
                        lane * 4),
                    v);
        }
        if (d_w4) {
          float d = tv[pl].x * gv[pl].x + tv[pl].y * gv[pl].y +
                    tv[pl].z * gv[pl].z + tv[pl].w * gv[pl].w;
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          d += __shfl_xor_sync(0xffffffffu, d, 4);
          if ((lane & 7) == 0) s_dw[pl][corner][ml] = d;
        }
      }
    }
  }
  if (!d_w4) return;
  __syncthreads();
  for (int e = tid; e < kTileP * 4 * kTileM; e += kWarpsPerBlock * 32) {
    const int ml = e % kTileM, c = (e / kTileM) % 4, pl = e / (kTileM * 4);
    const long long m = m0 + ml;
    if (pl < pc && m < m_rows)
      d_w4[(static_cast<long long>(p0 + pl) * 4 + c) * m_rows + m] =
          s_dw[pl][c][ml];
  }
}

// payload: (n_taps, 128)
template <typename G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_rows_kernel(const int* __restrict__ idx, const G* __restrict__ payload,
                    float* __restrict__ out, long long rows, int n_taps) {
  const int lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= n_taps) return;

  const int r = __ldg(idx + t);
  if (r < 0 || r >= rows) __trap();
  float* row = out + static_cast<long long>(r) * (4 * kCh) + lane;
  const G* src = payload + t * (4 * kCh) + lane;
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicAdd(row + c * kCh, to_f32(src[c * kCh]));
}

template <typename G, typename T>
void launch_weighted(const int* idx, const void* g, int per_tap,
                     const float* w4, float* d_table, long long rows,
                     const void* table, float* d_w4, int p_taps, int m_rows,
                     cudaStream_t stream) {
  const dim3 grid((m_rows + kTileM - 1) / kTileM,
                  (p_taps + kTileP - 1) / kTileP);
  const dim3 block(kWarpsPerBlock * 32);
  const G* gp = static_cast<const G*>(g);
  const T* tp = static_cast<const T*>(table);
  if (per_tap) {
    scatter_weighted_kernel<G, T, true><<<grid, block, 0, stream>>>(
        idx, gp, w4, d_table, rows, tp, d_w4, p_taps, m_rows);
  } else {
    scatter_weighted_kernel<G, T, false><<<grid, block, 0, stream>>>(
        idx, gp, w4, d_table, rows, tp, d_w4, p_taps, m_rows);
  }
}

template <typename G>
void launch_weighted_g(const int* idx, const void* g, int per_tap,
                       const float* w4, float* d_table, long long rows,
                       const void* table, int table_is_bf16, float* d_w4,
                       int p_taps, int m_rows, cudaStream_t stream) {
  if (table_is_bf16) {
    launch_weighted<G, __nv_bfloat16>(idx, g, per_tap, w4, d_table, rows,
                                      table, d_w4, p_taps, m_rows, stream);
  } else {
    launch_weighted<G, float>(idx, g, per_tap, w4, d_table, rows, table,
                              d_w4, p_taps, m_rows, stream);
  }
}

}  // namespace

// Weighted modes. idx: (P, M) int32 global table rows; g: (M, 32)
// (per_tap=0) or (P*M, 32) (per_tap=1), bf16 (g_is_bf16=1) or f32; w4:
// (P, 4, M) f32; d_table: (rows, 4*32) f32 zeroed by the caller, or null
// to skip it; table: (rows, 4*32) bf16 (table_is_bf16=1) or f32 and d_w4:
// (P, 4, M) f32, or both null to skip d_w4. g, d_table and table 16-byte
// aligned; all on card `device`. Returns cudaGetLastError() after the
// launch.
extern "C" int scatter_accum(int device, const int* idx, const void* g,
                             int g_is_bf16, int per_tap, const float* w4,
                             float* d_table, long long rows,
                             const void* table, int table_is_bf16,
                             float* d_w4, int p_taps, int m_rows,
                             void* stream) {
  if (p_taps <= 0 || m_rows <= 0 || (!d_table && !d_w4))
    return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16) {
    launch_weighted_g<__nv_bfloat16>(idx, g, per_tap, w4, d_table, rows,
                                     table, table_is_bf16, d_w4, p_taps,
                                     m_rows, s);
  } else {
    launch_weighted_g<float>(idx, g, per_tap, w4, d_table, rows, table,
                             table_is_bf16, d_w4, p_taps, m_rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows mode. idx: (n_taps,) int32 global table rows; payload: (n_taps,
// 4*32), bf16 (payload_is_bf16=1) or f32; out: (rows, 4*32) f32, zeroed by
// the caller; all on card `device`. Returns cudaGetLastError() after the
// launch.
extern "C" int scatter_rows(int device, const int* idx, const void* payload,
                            int payload_is_bf16, float* out, long long rows,
                            int n_taps, void* stream) {
  if (n_taps <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n_taps + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  if (payload_is_bf16) {
    scatter_rows_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        idx, static_cast<const __nv_bfloat16*>(payload), out, rows, n_taps);
  } else {
    scatter_rows_kernel<float><<<grid, block, 0, s>>>(
        idx, static_cast<const float*>(payload), out, rows, n_taps);
  }
  return static_cast<int>(cudaGetLastError());
}
