// Instance attention's dual-output sampling (K4): one pass over the taps of
// the last decoder layer's k x k RoI gives both sums of
// `instance_attention_qminor`'s inference branch,
//
//   out[b, h, q, :]                 = sum_{l,p} sw[b,h,l,p,q] * sample(l, p)
//   mask[b, q, p, h*32:(h+1)*32]    = sum_l     lw[b,h,l,p,q] * sample(l, p)
//
// where sample(l, p) is the bilinear sample of level l's quad table at
// (gx, gy)[b,h,l,p,q], zero when the tap lies outside the level. Replaces
// the JAX package's XLA formulation, `instance_attention_qminor`
// (boxer_tpu/ops/box_attention.py:639, through `_sample_taps_vjp`, :221),
// which reaches no Pallas kernel: there one gather a level materialises the
// (P*M, 4*ch) quad rows and the (P*M, ch) taps in device memory; here each
// quad row is read straight from its table and each sample lives only in
// registers until both sums have taken it.
//
// Sampling convention (`ops/combine_reduce.py:tap_rows`): x = gx*W - 0.5
// rounded as torch's separate multiply and subtract (__fmul_rn, __fsub_rn:
// a fused multiply-add would move floor() at a cell edge and flip the tap's
// row and validity), x0 = floor(x), lx = x - x0, the same for y; the tap is
// valid when x0 in [-1, W-1] and y0 in [-1, H-1]; it reads quad row
// bh*(H+1)*(W+1) + clamp(y0+1, 0, H)*(W+1) + clamp(x0+1, 0, W), whose four
// corners combine with the weights of `corner_weights(lx, ly, valid)`.
//
// What bounds it on an H100: device-memory bytes. At the segm shape (B 1,
// H 8, LQ 300, P 196, 4 levels at 100x152 .. 13x19, bf16 tables) it must
// read the tables once (42.3 MB), gx, gy, sw and lw (30.1 MB f32) and write
// the bf16 mask (30.1 MB) and the output: about 103 MB, 0.031 ms at 3.35
// TB/s; its 1.9 M row reads mostly hit the 50 MB L2.
//
// Design (the first, simple version): a block takes one query (b, q) with
// one warp a head; lane c owns channel c, so each corner read is 64 bytes
// (bf16) or 128 bytes (f32) of one quad row, coalesced, and each warp's
// store of a tap's mask slice is the contiguous h*32..h*32+31 of the (q, p)
// row, the block's warps together writing whole rows of the final (B, LQ,
// k, k, H*32) layout (no permute afterwards). The taps go 32 at a time:
// lane j forms tap j's row, corner weights, sw and lw for every level in
// registers (one load each of gx, gy, sw, lw), and the warp walks the 32
// taps, taking each tap's values from lane j with `__shfl_sync`; for a tap
// it issues the 16 corner loads of the 4 levels, then sums the levels in
// f32, keeping the mask value in a register until its one store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;          // channels per head
constexpr int kMaxLevels = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  const void* table[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// One tap of one level as lane j holds it: its quad row, the four corner
// weights (zero for a tap outside the level), and its two sum weights.
struct Tap {
  int row;
  float w[4];
  float sw, lw;
};

template <typename T>
__global__ void instance_sample_reduce_kernel(
    Levels lv, int n_levels, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ sw,
    const float* __restrict__ lw, T* __restrict__ out, T* __restrict__ mask,
    int heads, int p_taps, int lq) {
  const int lane = threadIdx.x % 32;
  const int h = threadIdx.x / 32;
  const int q = blockIdx.x;
  const long long b = blockIdx.y;
  const long long bh = b * heads + h;
  const long long tap_stride = static_cast<long long>(heads) * kCh;
  T* mrow = mask + (b * lq + q) * p_taps * tap_stride + h * kCh + lane;

  float acc = 0.f;
  for (int p0 = 0; p0 < p_taps; p0 += 32) {
    const int np = min(32, p_taps - p0);
    Tap mine[kMaxLevels];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      Tap& t = mine[l];
      t.row = 0;
      t.w[0] = t.w[1] = t.w[2] = t.w[3] = t.sw = t.lw = 0.f;
      if (l < n_levels && lane < np) {
        const int hl = lv.h[l], wl = lv.w[l];
        const long long at =
            ((bh * n_levels + l) * p_taps + p0 + lane) * lq + q;
        const float x = __fsub_rn(__fmul_rn(__ldg(gx + at),
                                            static_cast<float>(wl)), 0.5f);
        const float y = __fsub_rn(__fmul_rn(__ldg(gy + at),
                                            static_cast<float>(hl)), 0.5f);
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
        // clamped into [-2, W] first, so that a far tap cannot overflow
        // xi + 1; validity and the clamped row are the same either way
        const int xi = static_cast<int>(fminf(fmaxf(x0, -2.f), wl));
        const int yi = static_cast<int>(fminf(fmaxf(y0, -2.f), hl));
        const float valid = (xi >= -1 && xi <= wl - 1 && yi >= -1 &&
                             yi <= hl - 1) ? 1.f : 0.f;
        const int xq = min(max(xi + 1, 0), wl), yq = min(max(yi + 1, 0), hl);
        t.row = static_cast<int>((bh * (hl + 1) + yq) * (wl + 1) + xq);
        // `corner_weights`' order and rounding: x's factor, y's, validity
        const float gx0 = __fsub_rn(1.f, fx), gy0 = __fsub_rn(1.f, fy);
        t.w[0] = __fmul_rn(__fmul_rn(gx0, gy0), valid);
        t.w[1] = __fmul_rn(__fmul_rn(fx, gy0), valid);
        t.w[2] = __fmul_rn(__fmul_rn(gx0, fy), valid);
        t.w[3] = __fmul_rn(__fmul_rn(fx, fy), valid);
        t.sw = __ldg(sw + at);
        t.lw = __ldg(lw + at);
      }
    }
    for (int j = 0; j < np; ++j) {
      float v[kMaxLevels][4];
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l < n_levels) {
          const int r = __shfl_sync(kFull, mine[l].row, j);
          const T* src = static_cast<const T*>(lv.table[l]) +
                         static_cast<long long>(r) * 4 * kCh + lane;
#pragma unroll
          for (int c = 0; c < 4; ++c) v[l][c] = to_f32(__ldg(src + c * kCh));
        }
      }
      float m = 0.f;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l < n_levels) {
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s = fmaf(v[l][c], __shfl_sync(kFull, mine[l].w[c], j), s);
          acc = fmaf(s, __shfl_sync(kFull, mine[l].sw, j), acc);
          m = fmaf(s, __shfl_sync(kFull, mine[l].lw, j), m);
        }
      }
      mrow[(p0 + j) * tap_stride] = from_f32<T>(m);
    }
  }
  out[(bh * lq + q) * kCh + lane] = from_f32<T>(acc);
}

template <typename T>
void launch(const Levels& lv, int n_levels, const float* gx, const float* gy,
            const float* sw, const float* lw, void* out, void* mask,
            int batch, int heads, int p_taps, int lq, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(lq), static_cast<unsigned>(batch));
  instance_sample_reduce_kernel<T><<<grid, heads * 32, 0, stream>>>(
      lv, n_levels, gx, gy, sw, lw, static_cast<T*>(out),
      static_cast<T*>(mask), heads, p_taps, lq);
}

}  // namespace

// tables t0..t3 (the first n_levels used): level l's quad table (batch *
// heads * (H_l+1) * (W_l+1), 4*32) bf16 (is_bf16=1) or f32; level_hw: host
// array (H_0, W_0, H_1, W_1, ...); gx, gy, sw, lw: (batch, heads, n_levels,
// p_taps, lq) f32; out: (batch, heads, lq, 32) and mask: (batch, lq, p_taps,
// heads*32), in the tables' dtype; all on card `device`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// n_levels outside 1..4, heads outside 1..32, or p_taps < 1.
extern "C" int instance_sample_reduce(
    int device, int is_bf16, const void* t0, const void* t1, const void* t2,
    const void* t3, const int* level_hw, int n_levels, const float* gx,
    const float* gy, const float* sw, const float* lw, void* out, void* mask,
    int batch, int heads, int p_taps, int lq, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || heads < 1 || heads > 32 ||
      p_taps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || lq <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Levels lv{{t0, t1, t2, t3}, {}, {}};
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(lv, n_levels, gx, gy, sw, lw, out, mask, batch,
                          heads, p_taps, lq, s);
  } else {
    launch<float>(lv, n_levels, gx, gy, sw, lw, out, mask, batch, heads,
                  p_taps, lq, s);
  }
  return static_cast<int>(cudaGetLastError());
}
