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
// trip a tap and moves 64 bytes a warp per load: latency-bound (K8 ran so
// until it joined the two kernels below: 0.0801 ms at P=4, M=161,576, 4.3x
// its bound). Two kernels, each templated over the weight mode and the tap
// order:
//
// - direct (K1, K2 up to 8 taps, the training forward, and K8 up to 8
//   taps): each output gets 4 lanes (8 in f32), each owning 16 bytes of
//   channels and reading them from all 4 corners with 16-byte loads, two
//   taps in flight; a raw lane forms its tap's corner weights in registers
//   from lx, ly, wt (12 bytes a tap where w4 reads 16). Corners and taps sum
//   in registers with no shuffle and no barrier, and the lane stores its
//   own channels as float4s. K1 at its main shape takes 0.0354 ms of device
//   time against the warp-an-output loop's 0.0880 (H100 80GB HBM3 at 700 W,
//   `tools/bench_kernels.py`); all 4 taps in flight cost 41% there (fewer
//   warps resident) for 0.4 us at M=2,400. In the m-major order an output's
//   taps are contiguous, so where P % 4 == 0 one 16-byte load each of idx,
//   lx, ly and wt brings 4 taps;
// - staged (K2 and K8 above 8 taps): a tap is one "group" of lanes reading
//   its whole quad row with 16-byte loads (16 lanes in bf16, 32 in f32), so
//   a warp fetches two bf16 rows per instruction, four taps' rows in flight
//   a group; kG = 2 groups share an output, each walking every 2nd tap; the
//   corners of a channel block meet across lanes with `__shfl_xor_sync`,
//   the 2 groups in shared memory. A block covers kThreads / (lanes * kG)
//   consecutive outputs and copies a (kChunk taps x outputs) tile of idx and
//   of the weights into shared memory with `cp.async`, double-buffered so
//   the next chunk's copy overlaps this chunk's gathers: w4's 4 corners
//   (16 bytes a tap), or, raw, lx, ly, wt (12 bytes), each lane forming its
//   corner's weight after its row load is issued. The m-major tile is kept
//   output by output and, where P % 4 == 0, copied 16 bytes at a time. The
//   16-lane groups cost 16 shuffles an output, more than 1-4 taps repay (at
//   P=1 they ran slower than a warp an output).
//
// The TPU's m-major kernel exists to reduce each output's P taps inside one
// VMEM block; on the card every order keeps the P-sum in registers, and the
// order changes only the addresses of idx and the weights.
//
// Indices are not clamped: the caller clamps them. An index outside
// [0, rows) traps, which surfaces as a launch failure at the next sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;            // channels per head
constexpr int kThreads = 256;      // threads per block
constexpr int kChunk = 32;         // staged: taps per staged chunk
constexpr int kDirectMaxP = 8;     // w4 and m-major: up to it, no staging
constexpr int kG = 2;              // staged: groups an output

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

// corner c's weight from the raw lx, ly, wt: x's factor by bit 0, y's by
// bit 1, in the order (and rounding) of `corner_weights`
__device__ __forceinline__ float corner_weight(int c, float lx, float ly,
                                               float wt) {
  return ((c & 1) ? lx : 1.f - lx) * ((c & 2) ? ly : 1.f - ly) * wt;
}

// component i of a 4-vector (i a constant after unrolling)
template <typename V>
__device__ __forceinline__ auto lane_of(const V& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 4- or 16-byte asynchronous copy into shared memory; zero-fills when !ok
// (src is then not read).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// P > 8: kG groups an output, idx and the weights staged. kRaw: wa, wb, wc
// = lx, ly, wt in idx's shape, 3 staged planes, each lane forming its
// corner's weight; else wa = w4 (P, 4, M), 4 planes. kMmajor: idx (M, P),
// the staged tile kept output by output; kVec (m-major, P % 4 == 0, the
// inputs 16-byte aligned): 16-byte copies of 4 taps of an output.
template <typename T, bool kRaw, bool kMmajor, bool kVec>
__global__ void __launch_bounds__(kThreads)
quad_sample_reduce_staged_kernel(const T* __restrict__ table, long long rows,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ wa,
                                 const float* __restrict__ wb,
                                 const float* __restrict__ wc,
                                 float* __restrict__ out, int p_taps,
                                 int m_rows) {
  constexpr int kLanes = Row<T>::kLanes, kVals = Row<T>::kVals;
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kTile = kGroups / kG;  // outputs per block
  constexpr int kPlanes = kRaw ? 3 : 4;
  __shared__ __align__(16) int s_idx[2][kChunk * kTile];
  __shared__ __align__(16) float s_w[2][kPlanes][kChunk * kTile];
  __shared__ float s_red[kGroups][kCh];

  const int tid = threadIdx.x;
  const int group = tid / kLanes, lane = tid % kLanes;
  const int mo = group / kG, sub = group % kG;  // output in tile, tap phase
  const int corner = lane / (kLanes / 4);
  const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
  const int n_chunks = (p_taps + kChunk - 1) / kChunk;

  // tap pl of output ml in a staged tile
  auto at = [](int pl, int ml) {
    return kMmajor ? ml * kChunk + pl : pl * kTile + ml;
  };
  // plane w (-1: idx) of tap p of output m in device memory
  auto src = [&](int w, long long p, long long m) -> const void* {
    const long long t = kMmajor ? m * p_taps + p : p * m_rows + m;
    if (w < 0) return idx + t;
    if (kRaw) return (w == 0 ? wa : w == 1 ? wb : wc) + t;
    return wa + (p * 4 + w) * m_rows + m;
  };
  auto dst = [&](int b, int w, int j) -> void* {
    return w < 0 ? static_cast<void*>(&s_idx[b][j])
                 : static_cast<void*>(&s_w[b][w][j]);
  };
  // chunk k's (taps x outputs) tile of idx and the weight planes -> buffer b
  auto stage = [&](int k, int b) {
    const int pc = min(kChunk, p_taps - k * kChunk);
    const long long p0 = static_cast<long long>(k) * kChunk;
    if (kVec) {
      const int quads = pc / 4;
      for (int e = tid; e < (kPlanes + 1) * kTile * quads; e += kThreads) {
        const int q = e % quads, ml = (e / quads) % kTile;
        const int w = e / (quads * kTile) - 1;
        const long long m = m0 + ml;
        const bool ok = m < m_rows;
        cp_async16(dst(b, w, at(4 * q, ml)), src(w, p0 + 4 * q, ok ? m : 0),
                   ok);
      }
    } else {
      for (int e = tid; e < (kPlanes + 1) * kTile * pc; e += kThreads) {
        int pl, ml, w;
        if (kMmajor) {  // consecutive threads on an output's consecutive taps
          pl = e % pc;
          ml = (e / pc) % kTile;
          w = e / (pc * kTile) - 1;
        } else {        // on consecutive outputs of a tap
          ml = e % kTile;
          w = (e / kTile) % (kPlanes + 1) - 1;
          pl = e / (kTile * (kPlanes + 1));
        }
        const long long m = m0 + ml;
        const bool ok = m < m_rows;
        cp_async4(dst(b, w, at(pl, ml)), src(w, p0 + pl, ok ? m : 0), ok);
      }
    }
  };

  const uint4* rows16 = reinterpret_cast<const uint4*>(table);
  constexpr int kRow16 = 4 * kCh * sizeof(T) / 16;  // 16-byte vectors a row
  // the row load is issued before the weight is formed
  auto load = [&](int b, int pl, float& w) {
    const int j = at(pl, mo);
    const int r = s_idx[b][j];
    if (r < 0 || r >= rows) __trap();
    const uint4 v = __ldg(rows16 + static_cast<long long>(r) * kRow16 + lane);
    w = kRaw ? corner_weight(corner, s_w[b][0][j], s_w[b][1][j],
                             s_w[b][2][j])
             : s_w[b][corner][j];
    return v;
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
// = lx, ly, wt in idx's shape, the corner weights formed only after the
// taps' row loads are issued (formed as lx, ly, wt arrived, they stalled
// the warp ahead of those loads: 0.0410 against 0.0354 ms of device time at
// P=4, M=161,576); else wa = w4 (P, 4, M). kMmajor: idx (M, P); kVec
// (m-major, P % 4 == 0, idx, lx, ly, wt 16-byte aligned): one 16-byte load
// each of idx, lx, ly and wt brings 4 taps of the output.
template <typename T, bool kRaw, bool kMmajor, bool kVec>
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
  // taps u < n of r, w (raw: lx, ly, wt in w[.][0..2]): rows, then sums
  auto taps = [&](const int (&r)[kU], float (&w)[kU][4], int n) {
    uint4 v[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (u < n) {
        if (r[u] < 0 || r[u] >= rows) __trap();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[u][k] = __ldg(rows16 + static_cast<long long>(r[u]) * kRow16 +
                          k * kLanes + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (u < n) {
        if (kRaw) {
          const float lx = w[u][0], ly = w[u][1], wt = w[u][2];
#pragma unroll
          for (int k = 0; k < 4; ++k) w[u][k] = corner_weight(k, lx, ly, wt);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) Row<T>::fma(acc, v[u][k], w[u][k]);
      }
    }
  };
  if (kVec) {
    for (int p = 0; p < p_taps; p += 4) {
      const long long t = m * p_taps + p;
      const int4 r4 = __ldg(reinterpret_cast<const int4*>(idx + t));
      const float4 a = __ldg(reinterpret_cast<const float4*>(wa + t));
      const float4 b = __ldg(reinterpret_cast<const float4*>(wb + t));
      const float4 c = __ldg(reinterpret_cast<const float4*>(wc + t));
#pragma unroll
      for (int h = 0; h < 4; h += kU) {
        int r[kU];
        float w[kU][4];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          r[u] = lane_of(r4, h + u);
          w[u][0] = lane_of(a, h + u);
          w[u][1] = lane_of(b, h + u);
          w[u][2] = lane_of(c, h + u);
        }
        taps(r, w, kU);
      }
    }
  } else {
    for (int p = 0; p < p_taps; p += kU) {
      int r[kU];
      float w[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (p + u < p_taps) {
          const long long t = kMmajor ? m * p_taps + p + u
                                      : static_cast<long long>(p + u) *
                                                m_rows + m;
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
      taps(r, w, p_taps - p);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + m * kCh + lane * kVals);
#pragma unroll
  for (int j = 0; j < kVals / 4; ++j)
    o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                       acc[4 * j + 3]);
}

template <typename T, bool kRaw, bool kMmajor, bool kVec>
void run_direct(const T* t, long long rows, const int* idx, const float* a,
                const float* b, const float* c, float* out, int p_taps,
                int m_rows, cudaStream_t stream) {
  constexpr int kOuts = kThreads * 16 / (kCh * sizeof(T));  // a block
  const dim3 grid(static_cast<unsigned>((m_rows + kOuts - 1) / kOuts));
  quad_sample_reduce_direct_kernel<T, kRaw, kMmajor, kVec>
      <<<grid, kThreads, 0, stream>>>(t, rows, idx, a, b, c, out, p_taps,
                                      m_rows);
}

template <typename T, bool kRaw, bool kMmajor, bool kVec>
void run_staged(const T* t, long long rows, const int* idx, const float* a,
                const float* b, const float* c, float* out, int p_taps,
                int m_rows, cudaStream_t stream) {
  constexpr int kTile = kThreads / Row<T>::kLanes / kG;
  const dim3 grid(static_cast<unsigned>((m_rows + kTile - 1) / kTile));
  quad_sample_reduce_staged_kernel<T, kRaw, kMmajor, kVec>
      <<<grid, kThreads, 0, stream>>>(t, rows, idx, a, b, c, out, p_taps,
                                      m_rows);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T>
void launch(const void* table, long long rows, const int* idx, const float* a,
            const float* b, const float* c, int raw, int mmajor, float* out,
            int p_taps, int m_rows, cudaStream_t stream) {
  const T* t = static_cast<const T*>(table);
  if (mmajor) {
    const bool vec = p_taps % 4 == 0 && aligned16(idx) && aligned16(a) &&
                     aligned16(b) && aligned16(c);
    if (p_taps <= kDirectMaxP) {
      (vec ? run_direct<T, true, true, true> : run_direct<T, true, true, false>)(
          t, rows, idx, a, b, c, out, p_taps, m_rows, stream);
    } else {
      (vec ? run_staged<T, true, true, true> : run_staged<T, true, true, false>)(
          t, rows, idx, a, b, c, out, p_taps, m_rows, stream);
    }
  } else if (!raw && p_taps > kDirectMaxP) {
    run_staged<T, false, false, false>(t, rows, idx, a, b, c, out, p_taps,
                                       m_rows, stream);
  } else {
    (raw ? run_direct<T, true, false, false>
         : run_direct<T, false, false, false>)(t, rows, idx, a, b, c, out,
                                               p_taps, m_rows, stream);
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
