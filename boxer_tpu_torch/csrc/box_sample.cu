// Box attention's inference sampling (K9): one launch a call takes the
// projected value and the query-minor sampling grid and writes the output,
//
//   out[b, q, h, :] = sum_{l, p} sum_c w_c(l, p) * value[b, s_c(l, p), h, :]
//
// where, for the tap (l, p) of output (b, h, q), x = gx*W_l - 0.5 and
// y = gy*H_l - 0.5, x0 = floor(x), y0 = floor(y), lx = x - x0,
// ly = y - y0 (`ops/combine_reduce.py:tap_rows`), the corners c are the
// pixels (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) of level l, in that
// order, and w_c = `corner_weights(lx, ly, wt)`, with wt the attention
// weight where x0 lies in [-1, W_l-1] and y0 in [-1, H_l-1] and 0
// elsewhere. A corner outside its level reads as zero.
//
// Replaces, on the inference path (`box_attention_qminor(fold=True)` with
// the p-major combine), the TPU kernels `fused_combine_reduce_raw` (K1) and
// `fused_combine_reduce` (K2) of boxer_tpu/ops/pallas/combine_reduce.py
// together with what feeds them in `_box_attention_qminor_folded`
// (boxer_tpu/ops/box_attention.py): the quad-table build (a 2x2
// neighbourhood a row, 4x the value's bytes), the tap preparation around
// `jnp.take` (p-major copies of the grid, rows, fractions, corner weights)
// and the per-level f32 sums. On the card those were ~25 torch passes and
// about 1 GB of intermediates a call at batch 16; here each tap's corner
// offsets and weights are formed once, into shared memory, the 2x2
// neighbours are read straight from the (B, S, H, 32) value, and the sums
// stay in registers.
//
// Sampling convention: the multiply and the subtract of x and y are two
// roundings (__fmul_rn, __fsub_rn, as torch computes them and as K4 does in
// `csrc/instance_sample.cu`): a fused multiply-add would move floor() at a
// cell edge and pick other corners. The range tests are made on the floats,
// before any conversion to int, so that a tap however far off reads
// nothing; box sizes, and so taps, are unbounded.
//
// What bounds it on an H100: device-memory bytes, each once: the value
// (B, S, H, 32) read, gx, gy and the weights (f32) read, the output written
// (`benchmark/counts:box_attention_bytes`): at the segm cell's shapes
// (batch 16 of 800x1216, bf16) 0.83 GB an encoder call (P 4, L 4, LQ
// 20,197), 0.247 ms at 3.35 TB/s, and 0.53 GB a decoder call (P 196, LQ
// 300), 0.158 ms. The rows themselves are read once per tap and corner, 4 x
// 64 bytes a tap in bf16 (10.6 GB an encoder call, 7.7 GB a decoder call),
// and come through L2 and L1: neighbouring queries, and a query's
// neighbouring taps, read neighbouring pixels, and an image's value (10.3
// MB in bf16) fits in the 50 MB L2. So the gather's instructions and
// latency bound it, not bytes: with every row read an L1 hit the kernel
// took as long, and with no row reads at all a half to two thirds of its
// time (`PERF.md`, the K9 sweep).
//
// Design: a block of 8 warps takes n_out consecutive outputs (b, h, q),
// consecutive q of one (b, h) but at a (b, h) edge, and walks their taps
// in chunks. For a chunk, each thread stages the taps of one output: it
// reads gx, gy and the weight (consecutive threads, consecutive q, so the
// reads are whole sectors), and forms the tap's fractions, its four corner
// weights (zero for a corner outside the level) and the offsets of its two
// rows once, into shared memory; one barrier. Then an output gets kLanes
// lanes (4 in bf16, 8 in f32), each owning 16 bytes of its 32 channels:
// per tap it reads the staged entry (a broadcast) and the 16 bytes of each
// corner whose weight is not zero with one 16-byte load, and sums in f32
// registers, so corners and taps meet with no shuffle. The taps of an
// output are split over `split` warps, each walking every split-th tap of a
// chunk, a power of two chosen from the taps an output has (L x P): 1 up to
// kChunk = 16 taps (the encoder's P 4 at 4 levels: one chunk, a warp walks
// all 16), 8 at the segm decoder's 784 (7 chunks of 128); the warps of an
// output then meet in shared memory and the first sums them in warp order,
// so two launches give bitwise-equal outputs. The output is written once,
// in the value's dtype, in the (B, LQ, H, 32) layout, whose (B, H, LQ, 32)
// view the op returns. Every sum is in f32; the value is read in its dtype.
//
// Tuning (H100, `PERF.md`, the K9 sweep): staging the taps halved the time of
// lanes that each formed their own taps (2.35 -> 1.26 ms an encoder call,
// 1.58 -> 0.85 a decoder call); the gather takes two taps a loop and at
// most 64 registers a thread, 4 blocks an SM (1.32 -> 1.21 and 0.93 ->
// 0.84 in one sweep); more taps in flight (more registers, fewer warps) and
// chunks of 8 taps (two warps an encoder output) were slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;          // channels a head
constexpr int kWarps = 8;        // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLevels = 8;
constexpr int kChunk = 16;       // taps a warp a chunk; the split's target
constexpr int kBlocksPerSm = 4;  // at most 64 registers a thread
constexpr int kEntries = kWarps * 8 * kChunk;  // the stage, at 8 outputs a warp

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// a (B, H, L, P, LQ) f32 tensor by its strides, in elements
struct Grid {
  const float* p;
  long long sb, sh, sl, sp, sq;
};

// 16 bytes of channels: kN values, summed into f32 and packed back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void fma(float* acc, const uint4& v,
                                             float w) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // channel 2i is the low half of word i
  static __device__ __forceinline__ void fma(float* acc, const uint4& v,
                                             float w) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u),
                            acc[2 * i + 1]);
    }
  }
  // round to nearest even, as torch's cast
  static __device__ __forceinline__ unsigned two(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The taps of a chunk as the gather reads them: entry j * n_out + o is tap
// j of the chunk for output o of the block, its four corner weights (zero
// for a corner outside the level) and the element offsets of its top row's
// and bottom row's left corner from the output's (b, h) pixel 0.
struct Stage {
  float4 w[kEntries];
  int2 off[kEntries];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
box_sample_kernel(const T* __restrict__ value,
                  const __grid_constant__ Levels lv, int n_levels,
                  const __grid_constant__ Grid gx,
                  const __grid_constant__ Grid gy,
                  const __grid_constant__ Grid aw, T* __restrict__ out,
                  int heads, int seq, int p_taps, int lq, long long m_rows,
                  int split) {
  constexpr int kVals = Vec<T>::kN;   // channels a lane
  constexpr int kLanes = kCh / kVals; // lanes an output
  constexpr int kOuts = 32 / kLanes;  // outputs a warp
  // entries a chunk, kChunk taps a warp for each of its outputs: the same
  // at every split
  constexpr int kChunkEntries = kWarps * kOuts * kChunk;
  constexpr int kPer = kChunkEntries / kThreads;  // entries a thread stages
  static_assert(kChunkEntries <= kEntries && kChunkEntries % kThreads == 0,
                "a chunk's entries must fit the stage and cover the block");
  __shared__ __align__(16) Stage st;
  __shared__ __align__(16) float s_red[kWarps][kOuts][kCh];

  const int tid = threadIdx.x, warp = tid / 32;
  const int sets = kWarps / split;    // output sets a block
  const int n_out = sets * kOuts;     // outputs a block
  const int set = warp % sets, phase = warp / sets;
  const int o = set * kOuts + (tid % 32) / kLanes, lane = tid % kLanes;
  const long long m0 = static_cast<long long>(blockIdx.x) * n_out;
  const long long pix = static_cast<long long>(heads) * kCh;  // a pixel
  const int taps = n_levels * p_taps;
  const int chunk_taps = kChunk * split;

  // output m = (b * H + h) * LQ + q: b, h and q
  auto split_m = [&](long long m, long long& b, long long& h, long long& q) {
    const long long bh = m / lq;
    q = m - bh * lq;
    b = bh / heads;
    h = bh - b * heads;
  };
  // 256 is a multiple of n_out, so a thread stages one output's entries:
  // output oe, taps j0, j0 + kThreads / n_out, ... of each chunk
  const int oe = tid % n_out, j0 = tid / n_out, j_step = kThreads / n_out;
  const bool staged = m0 + oe < m_rows;
  long long b, h, q;
  split_m(staged ? m0 + oe : 0, b, h, q);
  const float* g0 = gx.p + b * gx.sb + h * gx.sh + q * gx.sq;
  const float* g1 = gy.p + b * gy.sb + h * gy.sh + q * gy.sq;
  const float* g2 = aw.p + b * aw.sb + h * aw.sh + q * aw.sq;
  auto stage = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int t = t0 + j0 + k * j_step;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      int2 off = make_int2(0, 0);
      if (staged && t < taps) {
        const int l = t / p_taps, p = t - l * p_taps;
        const int hl = lv.h[l], wl = lv.w[l];
        const float fh = static_cast<float>(hl), fw = static_cast<float>(wl);
        const float wt = __ldg(g2 + l * aw.sl + p * aw.sp);
        const float x = __fsub_rn(
            __fmul_rn(__ldg(g0 + l * gx.sl + p * gx.sp), fw), 0.5f);
        const float y = __fsub_rn(
            __fmul_rn(__ldg(g1 + l * gy.sl + p * gy.sp), fh), 0.5f);
        const float x0 = floorf(x), y0 = floorf(y);
        const float lx = __fsub_rn(x, x0), ly = __fsub_rn(y, y0);
        // the corners' columns and rows inside the level, as floats
        const bool cx0 = x0 >= 0.f && x0 <= fw - 1.f;
        const bool cx1 = x0 >= -1.f && x0 <= fw - 2.f;
        const bool cy0 = y0 >= 0.f && y0 <= fh - 1.f;
        const bool cy1 = y0 >= -1.f && y0 <= fh - 2.f;
        if ((cx0 || cx1) && (cy0 || cy1)) {
          // `corner_weights`' order and rounding: x's factor, y's, weight
          const float gx0 = __fsub_rn(1.f, lx), gy0 = __fsub_rn(1.f, ly);
          w.x = cy0 && cx0 ? __fmul_rn(__fmul_rn(gx0, gy0), wt) : 0.f;
          w.y = cy0 && cx1 ? __fmul_rn(__fmul_rn(lx, gy0), wt) : 0.f;
          w.z = cy1 && cx0 ? __fmul_rn(__fmul_rn(gx0, ly), wt) : 0.f;
          w.w = cy1 && cx1 ? __fmul_rn(__fmul_rn(lx, ly), wt) : 0.f;
          // x0 and y0 lie in [-1, W-1] and [-1, H-1]; the wrapper holds
          // S * H * 32 below 2^31
          const int top = lv.start[l] + static_cast<int>(y0) * wl +
                          static_cast<int>(x0);
          off = make_int2(top * static_cast<int>(pix),
                          (top + wl) * static_cast<int>(pix));
        }
      }
      st.w[tid + k * kThreads] = w;
      st.off[tid + k * kThreads] = off;
    }
  };

  float acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
  // the output this thread sums: its (b, h) pixel 0
  const long long m = m0 + o;
  long long mb, mh, mq;
  split_m(m < m_rows ? m : 0, mb, mh, mq);
  const T* vb = value + (mb * seq * heads + mh) * kCh + lane * kVals;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int t0 = 0; t0 < taps; t0 += chunk_taps) {
    stage(t0);
    __syncthreads();
    // this warp's taps of the chunk: phase, phase + split, ...
    const int n_j = min(chunk_taps, taps - t0);
#pragma unroll 2
    for (int j = phase; j < n_j; j += split) {
      const int e = j * n_out + o;
      const float4 w = st.w[e];
      const int2 off = st.off[e];
      // a zero weight reads nothing: a corner outside the level
      const T* r0 = vb + off.x;
      const T* r1 = vb + off.y;
      const uint4 v0 = w.x != 0.f ? ldg16(r0) : zero;
      const uint4 v1 = w.y != 0.f ? ldg16(r0 + pix) : zero;
      const uint4 v2 = w.z != 0.f ? ldg16(r1) : zero;
      const uint4 v3 = w.w != 0.f ? ldg16(r1 + pix) : zero;
      Vec<T>::fma(acc, v0, w.x);
      Vec<T>::fma(acc, v1, w.y);
      Vec<T>::fma(acc, v2, w.z);
      Vec<T>::fma(acc, v3, w.w);
    }
    __syncthreads();  // the stage is restaged by the next chunk
  }

  if (split > 1) {  // uniform over the block
    const int ow = (tid % 32) / kLanes;
#pragma unroll
    for (int i = 0; i < kVals; i += 4)
      *reinterpret_cast<float4*>(&s_red[warp][ow][lane * kVals + i]) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    __syncthreads();
    if (phase == 0) {
#pragma unroll
      for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
      for (int s = 0; s < split; ++s) {
#pragma unroll
        for (int i = 0; i < kVals; ++i)
          acc[i] += s_red[s * sets + set][ow][lane * kVals + i];
      }
    }
  }
  if (phase == 0 && m < m_rows) {
    T* dst = out + ((mb * lq + mq) * heads + mh) * kCh + lane * kVals;
    *reinterpret_cast<uint4*>(dst) = Vec<T>::pack(acc);
  }
}

// warps that share an output: the least power of two that leaves a warp at
// most kChunk of the output's taps, at most kWarps
int split_for(int taps) {
  int split = 1;
  while (split < kWarps && split * kChunk < taps) split *= 2;
  return split;
}

template <typename T>
cudaError_t launch(const void* value, const Levels& lv, int n_levels,
                   const Grid& gx, const Grid& gy, const Grid& aw, void* out,
                   int batch, int heads, int seq, int p_taps, int lq,
                   cudaStream_t stream) {
  constexpr int kOuts = 32 / (kCh / Vec<T>::kN);
  const long long m_rows = static_cast<long long>(batch) * heads * lq;
  const int split = split_for(n_levels * p_taps);
  const long long per_block = static_cast<long long>(kWarps / split) * kOuts;
  const long long blocks = (m_rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  box_sample_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const T*>(value), lv, n_levels, gx, gy, aw,
      static_cast<T*>(out), heads, seq, p_taps, lq, m_rows, split);
  return cudaGetLastError();
}

}  // namespace

// value: (batch, seq, heads, 32) bf16 (is_bf16=1) or f32, contiguous and
// 16-byte aligned; level_hw: host array (H_0, W_0, H_1, W_1, ...) of
// n_levels levels, which tile the seq axis in order; gx, gy, aw: (batch,
// heads, n_levels, p_taps, lq) f32 given by a pointer and five strides in
// elements each (host arrays of 5); out: (batch, lq, heads, 32) in the
// value's dtype, 16-byte aligned; all on card `device`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// n_levels outside 1..8, p_taps < 1, levels that do not tile seq, or
// seq * heads * 32 elements of 2^31 or more.
extern "C" int box_sample_reduce(int device, int is_bf16, const void* value,
                                 const int* level_hw, int n_levels,
                                 const float* gx, const long long* gx_strides,
                                 const float* gy, const long long* gy_strides,
                                 const float* aw, const long long* aw_strides,
                                 void* out, int batch, int heads, int seq,
                                 int p_taps, int lq, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || p_taps < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  long long start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = static_cast<int>(start);
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != seq || start * heads * kCh > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || lq <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto grid = [](const float* p, const long long* s) {
    return Grid{p, s[0], s[1], s[2], s[3], s[4]};
  };
  const Grid g0 = grid(gx, gx_strides), g1 = grid(gy, gy_strides),
             g2 = grid(aw, aw_strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, lv, n_levels, g0, g1, g2, out,
                                      batch, heads, seq, p_taps, lq, s)
              : launch<float>(value, lv, n_levels, g0, g1, g2, out, batch,
                              heads, seq, p_taps, lq, s);
  return static_cast<int>(err);
}
