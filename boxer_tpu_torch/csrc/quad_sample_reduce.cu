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
// Weights, by mode: raw (K1, K8) takes lx, ly, wt f32 in idx's shape and
// forms the corner weights in the kernel as (1-lx)(1-ly)wt, lx(1-ly)wt,
// (1-lx)ly wt, lx ly wt, the quad-row order of `corner_weights`; w4 (K2)
// takes them precomputed, (P, 4, M) f32. Tap order: p-major, idx (P, M),
// t(p, m) = p*M + m (K1, K2), or m-major, idx (M, P), t(p, m) = m*P + p
// (K8).
//
// What bounds them on an H100: device-memory bytes. K1 at its main-path
// shape (P=4, M=161,576, encoder level 0's 123,624-row bf16 table at
// 800x1216) must read the distinct table rows, idx, lx, ly and wt and write
// the (M, 32) f32 output: 0.0187 ms at 3.35 TB/s. K2 at P=196, M=2,400
// over the same table must read the distinct rows (31.6 MB), idx (1.9 MB)
// and w4 (7.5 MB) and write 0.3 MB: 40.5 MB, 0.0121 ms; its 470,400 row
// reads (120 MB) mostly hit the 50 MB L2. A warp walking an output's taps
// in series, one lane a channel, waits on a dependent index -> row round
// trip a tap and moves 64 bytes a warp per load: latency-bound. Three
// kernels:
//
// - direct (K1, and K2 up to 8 taps, the training forward): one template
//   over the weight mode gives each output 4 lanes (8 in f32), each owning
//   16 bytes of channels and reading them from all 4 corners with 16-byte
//   loads, two taps in flight; a raw lane forms its tap's corner weights in
//   registers from lx, ly, wt (12 bytes a tap where w4 reads 16). Corners
//   and taps sum in registers with no shuffle and no barrier, and the lane
//   stores its own channels as float4s. K1 at its main shape takes 0.0354
//   ms of device time against the warp-an-output loop's 0.0880 (H100 80GB
//   HBM3 at 700 W, `tools/bench_kernels.py`); all 4 taps in flight cost
//   41% there (fewer warps resident) for 0.4 us at M=2,400;
// - staged (K2 above 8 taps): a tap is one "group" of lanes reading its
//   whole quad row with 16-byte loads (16 lanes in bf16, 32 in f32), so a
//   warp fetches two bf16 rows per instruction, four taps' rows in flight a
//   group; kG = 2 groups share an output, each walking every 2nd tap; the
//   corners of a channel block meet across lanes with `__shfl_xor_sync`,
//   the 2 groups in shared memory. A block covers kThreads / (lanes * kG)
//   consecutive outputs and copies a (kChunk taps x outputs) tile of idx and
//   of each corner's w4 into shared memory with `cp.async`, double-buffered
//   so the next chunk's copy overlaps this chunk's gathers. The 16-lane
//   groups cost 16 shuffles an output, more than 1-4 taps repay (at P=1
//   they ran slower than a warp an output);
// - m-major (K8): one warp an output, one lane a channel, the P taps in
//   series. The TPU's m-major kernel exists to reduce each output's P taps
//   inside one VMEM block; on the card every order keeps the P-sum in a
//   register. Its P=196 shape under the m-major combine wants a staged
//   design of its own (not done).
//
// Indices are not clamped: the caller clamps them. An index outside
// [0, rows) traps, which surfaces as a launch failure at the next sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;            // channels per head
constexpr int kWarpsPerBlock = 8;  // m-major: output rows per block
constexpr int kThreads = 256;      // direct and staged: threads per block
constexpr int kChunk = 32;         // staged: taps per staged chunk
constexpr int kDirectMaxP = 8;     // w4 mode: up to it, no staging
constexpr int kG = 2;              // staged: groups an output

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quad_sample_reduce_mmajor_kernel(const T* __restrict__ table, long long rows,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ lxs,
                                 const float* __restrict__ lys,
                                 const float* __restrict__ wts,
                                 float* __restrict__ out, int p_taps,
                                 int m_rows) {
  const int lane = threadIdx.x & 31;
  const long long m =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= m_rows) return;

  float acc = 0.f;
  for (int p = 0; p < p_taps; ++p) {
    const long long t = m * p_taps + p;
    const int r = __ldg(idx + t);
    if (r < 0 || r >= rows) __trap();
    const float lx = __ldg(lxs + t), ly = __ldg(lys + t), wt = __ldg(wts + t);
    const float w0 = (1.f - lx) * (1.f - ly) * wt, w1 = lx * (1.f - ly) * wt;
    const float w2 = (1.f - lx) * ly * wt, w3 = lx * ly * wt;
    const T* row = table + static_cast<long long>(r) * (4 * kCh) + lane;
    acc += w0 * to_f32(row[0 * kCh]);
    acc += w1 * to_f32(row[1 * kCh]);
    acc += w2 * to_f32(row[2 * kCh]);
    acc += w3 * to_f32(row[3 * kCh]);
  }
  out[m * kCh + lane] = acc;
}

// A quad row read as 16-byte vectors: kLanes lanes of kVals values each,
// lane l holding corner l / (kLanes / 4), channels (l % (kLanes / 4)) *
// kVals onwards.
template <typename T>
struct Row;

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kLanes = 16, kVals = 8;
  static __device__ __forceinline__ void fma(float* acc, uint4 v, float w) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
    }
  }
};

template <>
struct Row<float> {
  static constexpr int kLanes = 32, kVals = 4;
  static __device__ __forceinline__ void fma(float* acc, uint4 v, float w) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
};

// 4-byte asynchronous copy into shared memory; zero-fills when !ok (src is
// then not read).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// P > 8: kG groups an output, idx and w4 staged
template <typename T>
__global__ void __launch_bounds__(kThreads)
quad_sample_reduce_w4_kernel(const T* __restrict__ table, long long rows,
                             const int* __restrict__ idx,
                             const float* __restrict__ w4,
                             float* __restrict__ out, int p_taps,
                             int m_rows) {
  constexpr int kLanes = Row<T>::kLanes, kVals = Row<T>::kVals;
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kTile = kGroups / kG;  // outputs per block
  __shared__ int s_idx[2][kChunk][kTile];
  __shared__ float s_w[2][kChunk][4][kTile];
  __shared__ float s_red[kGroups][kCh];

  const int tid = threadIdx.x;
  const int group = tid / kLanes, lane = tid % kLanes;
  const int mo = group / kG, sub = group % kG;  // output in tile, tap phase
  const int corner = lane / (kLanes / 4);
  const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
  const int n_chunks = (p_taps + kChunk - 1) / kChunk;

  // chunk k's (taps x outputs) tile of idx and the 4 corners' w4 -> buffer b
  auto stage = [&](int k, int b) {
    const int pc = min(kChunk, p_taps - k * kChunk);
    for (int e = tid; e < pc * 5 * kTile; e += kThreads) {
      const int ml = e % kTile, which = (e / kTile) % 5, pl = e / (kTile * 5);
      const long long p = static_cast<long long>(k) * kChunk + pl;
      const long long m = m0 + ml;
      const bool ok = m < m_rows;
      if (which == 0) {
        cp_async4(&s_idx[b][pl][ml], idx + (ok ? p * m_rows + m : 0), ok);
      } else {
        cp_async4(&s_w[b][pl][which - 1][ml],
                  w4 + (ok ? (p * 4 + which - 1) * m_rows + m : 0), ok);
      }
    }
  };

  const uint4* rows16 = reinterpret_cast<const uint4*>(table);
  constexpr int kRow16 = 4 * kCh * sizeof(T) / 16;  // 16-byte vectors a row
  auto load = [&](int b, int pl, float& w) {
    const int r = s_idx[b][pl][mo];
    if (r < 0 || r >= rows) __trap();
    w = s_w[b][pl][corner][mo];
    return __ldg(rows16 + static_cast<long long>(r) * kRow16 + lane);
  };

  float acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;

  if (n_chunks > 0) stage(0, 0);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int b = k & 1;
    if (k + 1 < n_chunks) {
      stage(k + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pc = min(kChunk, p_taps - k * kChunk);
    int pl = sub;
    // four taps' rows in flight, then their products
    for (; pl + 3 * kG < pc; pl += 4 * kG) {
      uint4 v[4];
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = load(b, pl + u * kG, w[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) Row<T>::fma(acc, v[u], w[u]);
    }
    for (; pl < pc; pl += kG) {
      float w;
      const uint4 v = load(b, pl, w);
      Row<T>::fma(acc, v, w);
    }
    __syncthreads();  // buffer b is restaged by the next iteration
  }

  // the 4 corners of a channel block sit kLanes / 4 lanes apart
#pragma unroll
  for (int s = kLanes / 4; s < kLanes; s *= 2) {
#pragma unroll
    for (int i = 0; i < kVals; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], s);
  }
  if (corner == 0) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) s_red[group][lane * kVals + i] = acc[i];
  }
  __syncthreads();
  // the kG groups of each output, one thread per output channel
  for (int t = tid; t < kTile * kCh; t += kThreads) {
    const int o = t / kCh, c = t % kCh;
    const long long m = m0 + o;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kG; ++s) sum += s_red[o * kG + s][c];
    if (m < m_rows) out[m * kCh + c] = sum;
  }
}

// direct: kLanes = 4 lanes an output (8 in f32), each owning 16 bytes of
// channels and reading them from all four corners, so the corners and taps
// sum in its registers and it writes its channels itself. kRaw: wa, wb, wc
// = lx, ly, wt (P, M), the corner weights formed only after the taps' row
// loads are issued (formed as lx, ly, wt arrived, they stalled the warp
// ahead of those loads: 0.0410 against 0.0354 ms of device time at P=4,
// M=161,576); else wa = w4 (P, 4, M)
template <typename T, bool kRaw>
__global__ void __launch_bounds__(kThreads)
quad_sample_reduce_direct_kernel(const T* __restrict__ table, long long rows,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ wa,
                                 const float* __restrict__ wb,
                                 const float* __restrict__ wc,
                                 float* __restrict__ out, int p_taps,
                                 int m_rows) {
  constexpr int kVals = 16 / sizeof(T);  // channels a lane
  constexpr int kLanes = kCh / kVals;    // lanes an output
  constexpr int kRow16 = 4 * kCh * sizeof(T) / 16;
  constexpr int kU = 2;                  // taps in flight
  const int lane = threadIdx.x % kLanes;
  const long long m = static_cast<long long>(blockIdx.x) *
                          (kThreads / kLanes) + threadIdx.x / kLanes;
  if (m >= m_rows) return;
  const uint4* rows16 = reinterpret_cast<const uint4*>(table);
  float acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
  for (int p = 0; p < p_taps; p += kU) {
    int r[kU];
    float w[kU][4];
    uint4 v[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (p + u < p_taps) {
        const long long t = static_cast<long long>(p + u) * m_rows + m;
        r[u] = __ldg(idx + t);
        if (kRaw) {
          w[u][0] = __ldg(wa + t);
          w[u][1] = __ldg(wb + t);
          w[u][2] = __ldg(wc + t);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[u][k] = __ldg(wa + (static_cast<long long>(p + u) * 4 + k) *
                                     m_rows + m);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (p + u < p_taps) {
        if (r[u] < 0 || r[u] >= rows) __trap();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = __ldg(rows16 + static_cast<long long>(r[u]) * kRow16 +
                          k * kLanes + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (p + u < p_taps) {
        if (kRaw) {
          const float lx = w[u][0], ly = w[u][1], wt = w[u][2];
          w[u][0] = (1.f - lx) * (1.f - ly) * wt;
          w[u][1] = lx * (1.f - ly) * wt;
          w[u][2] = (1.f - lx) * ly * wt;
          w[u][3] = lx * ly * wt;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) Row<T>::fma(acc, v[u][k], w[u][k]);
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out + m * kCh + lane * kVals);
#pragma unroll
  for (int j = 0; j < kVals / 4; ++j)
    o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                       acc[4 * j + 3]);
}

template <typename T>
void launch(const void* table, long long rows, const int* idx, const float* a,
            const float* b, const float* c, int raw, int mmajor, float* out,
            int p_taps, int m_rows, cudaStream_t stream) {
  const T* t = static_cast<const T*>(table);
  if (mmajor) {
    const dim3 grid((m_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    quad_sample_reduce_mmajor_kernel<T><<<grid, kWarpsPerBlock * 32, 0,
                                          stream>>>(t, rows, idx, a, b, c,
                                                    out, p_taps, m_rows);
  } else if (!raw && p_taps > kDirectMaxP) {
    constexpr int kTile = kThreads / Row<T>::kLanes / kG;
    const dim3 grid(static_cast<unsigned>((m_rows + kTile - 1) / kTile));
    quad_sample_reduce_w4_kernel<T><<<grid, kThreads, 0, stream>>>(
        t, rows, idx, a, out, p_taps, m_rows);
  } else {
    constexpr int kOuts = kThreads * 16 / (kCh * sizeof(T));  // a block
    const dim3 grid(static_cast<unsigned>((m_rows + kOuts - 1) / kOuts));
    if (raw) {
      quad_sample_reduce_direct_kernel<T, true><<<grid, kThreads, 0,
                                                  stream>>>(
          t, rows, idx, a, b, c, out, p_taps, m_rows);
    } else {
      quad_sample_reduce_direct_kernel<T, false><<<grid, kThreads, 0,
                                                   stream>>>(
          t, rows, idx, a, b, c, out, p_taps, m_rows);
    }
  }
}

}  // namespace

// table: (rows, 4*32) bf16 (table_is_bf16=1) or f32, 16-byte aligned; idx:
// (P, M) int32, or (M, P) with mmajor=1. raw=1: a, b, c = lx, ly, wt f32 in
// idx's shape; raw=0: a = w4 (P, 4, M) f32 (p-major only). out: (M, 32)
// f32, all on card `device`. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for m-major with raw=0.
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
