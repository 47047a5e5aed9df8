// The pillar net at inference (K10): one launch takes the voxelizer's
// (V, P, 5) f32 points, their counts and their pillars' coordinates, and
// writes each pillar's (128,) feature, the output of
// `nn/point_pillar.py:PillarFeatureNet` at num_filters (64, 128):
//
//   decoration: each point's 5 features, its offset from the pillar's point
//     mean (x, y, z: the sum over the P rows over max(count, 1)) and from
//     the pillar's centre (x, y: coordinate * voxel size + offset); rows at
//     or past the count zeroed;
//   layer 1, in f32: the 10 -> 32 Linear, GroupNorm of 32 one-channel
//     groups with statistics per pillar over its P rows (padding rows
//     included) in two passes, eps 1e-6, affine, ReLU, the max over the
//     valid rows (-1e9 where there is none); each row's 64 inputs to
//     layer 2 are [the row's features (0 on padding rows), the max],
//     rounded to the weights' type;
//   layer 2: the 64 -> 128 product (bf16 operands on the tensor cores,
//     `mma.sync` m16n8k16 with f32 sums; f32 weights: f32 on the CUDA
//     cores), GroupNorm of 32 groups of 4 channels over the P rows in two
//     passes in f32, affine, ReLU, the max over the valid rows, rounded
//     once to the weights' type.
//
// Replaces no TPU kernel: the JAX package's pillar net
// (boxer_tpu/nn/point_pillar.py) is XLA. On the card the torch version of
// the same forward is some 20 passes over (V, 20, 128) intermediates, 2.5
// GB each in f32 at the pp3d.infer_b4 cell's 240,000 pillars a batch, and
// its two-pass norm holds several of them at once (12.6 GiB).
//
// What bounds it on an H100, at that cell's shape (V 240,000, P 20): the
// points read (96 MB f32), the counts and coordinates (4.8 MB) and the
// output written (61 MB bf16), 0.05 ms at 3.35 TB/s; and layer 2's product,
// 2 x 240,000 x 20 x 64 x 128 = 78.6 GFLOP, 0.08 ms at 989 TFLOP/s in bf16
// (layer 1's 3.1 GFLOP in f32 is below either). So about 0.08-0.1 ms.
//
// Design: a warp owns a pillar at a time and keeps everything of it on
// chip, so no (V, P, C) intermediate reaches device memory: the block's
// warps walk the pillars (a persistent grid, pillar = warp, warp + all
// warps, ...), the points of the next pillar loaded while this one is
// computed. Lane r decorates point r into the warp's shared rows (the
// pillar's sums by shuffles); then lane c holds layer 1's channel c over
// the P rows in registers, takes its statistics, ReLU and max there, and
// writes layer 2's input rows, padded to 32 (two m16 tiles; rows at or
// past P stay zero). Layer 2's weight (128 x 64) is loaded into shared
// memory once a block and read as each 8-channel tile's B fragments; the
// A fragments of the pillar's 32 rows stay in registers across the 16
// tiles. A tile's f32 sums stay in registers too: its two groups of 4
// channels are spread over lanes that share bit 1 of the lane id, so each
// group's sum, its centred squares and the channels' maxima over the rows
// are shuffles, with no pass over shared memory. The pillar's 128 outputs
// are staged in shared memory and stored once, 256 bytes in bf16. Every
// sum has a fixed order, so two launches give bitwise-equal outputs.
//
// Rounding: the decoration, layer 1 and the norms round as the torch
// version writes them (a product and a sum are two roundings, no fused
// multiply-add), but the sums over k and over rows go in another order.
// Layer 2's product is not rounded to the weights' type before its norm,
// where the torch version rounds it: a higher precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps a block, a pillar each
constexpr int kThreads = kWarps * 32;
constexpr int kF = 5;                // raw features a point
constexpr int kD = kF + 5;           // decorated features
constexpr int kC1 = 32;              // layer 1's channels, one a group
constexpr int kK2 = 2 * kC1;         // layer 2's inputs
constexpr int kC2 = 128;             // layer 2's channels, 4 a group
constexpr int kTiles = kC2 / 8;      // layer 2's 8-channel tiles
constexpr int kRows = 32;            // rows of a pillar in the product
constexpr int kMT = kRows / 16;      // its m16 tiles
constexpr float kMasked = -1e9f;     // the max where no row is valid

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  // a row of 64 inputs padded to 72: the fragments' reads, 8 rows x 4
  // words, meet 32 banks
  static constexpr int kLd = kK2 + 8;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's cast
  }
};

template <>
struct Traits<float> {
  // 68: the float4 reads of 8 rows meet 32 banks
  static constexpr int kLd = kK2 + 4;
  static __device__ __forceinline__ float load(const float* p) {
    return *p;
  }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

template <typename T>
struct Smem {
  static constexpr int kLd = Traits<T>::kLd;
  T w2[kC2][kLd];           // layer 2's kernel, (out, in)
  float g2[kC2], b2[kC2];   // its norm's weight and bias
  struct Warp {
    T x2[kRows][kLd];       // layer 2's input rows
    float xs[kRows][kD];    // the decorated points
    T out[kC2];             // the pillar's output, staged
  } warp[kWarps];
};

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// x * rstd * w + b as the torch version rounds it: three roundings
__device__ __forceinline__ float affine(float xc, float rstd, float w,
                                       float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), w), b);
}

// the sum over the lanes that share bit 1 of the lane id (the 8 rows x 2
// channel pairs of one 4-channel group in an accumulator tile)
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// the max over the 8 row groups of an accumulator tile
__device__ __forceinline__ float rows_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
  return v;
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Layer 2's product for one pillar, tile by tile: for tile j, this lane's
// sums acc[mt][i] of row 16 mt + grp + 8 (i / 2) and channel 8 j + 2 tig
// + i % 2 (the m16n8 accumulator layout), handed to `epi(j, acc)`.
template <typename T>
struct Product;

template <>
struct Product<__nv_bfloat16> {
  using S = Smem<__nv_bfloat16>;
  template <typename Epi>
  static __device__ __forceinline__ void run(const S& s, const S::Warp& sw,
                                             int grp, int tig, Epi&& epi) {
    constexpr int ldw = S::kLd / 2;  // a row in 32-bit words
    const unsigned* xw = reinterpret_cast<const unsigned*>(&sw.x2[0][0]);
    const unsigned* ww = reinterpret_cast<const unsigned*>(&s.w2[0][0]);
    unsigned a[kMT][kK2 / 16][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int ks = 0; ks < kK2 / 16; ++ks) {
        const int r = 16 * mt + grp, k = 8 * ks + tig;
        a[mt][ks][0] = xw[r * ldw + k];
        a[mt][ks][1] = xw[(r + 8) * ldw + k];
        a[mt][ks][2] = xw[r * ldw + k + 4];
        a[mt][ks][3] = xw[(r + 8) * ldw + k + 4];
      }
    }
#pragma unroll 2
    for (int j = 0; j < kTiles; ++j) {
      float acc[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
      const unsigned* wn = ww + (8 * j + grp) * ldw + tig;
#pragma unroll
      for (int ks = 0; ks < kK2 / 16; ++ks) {
        const unsigned b0 = wn[8 * ks], b1 = wn[8 * ks + 4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_bf16(acc[mt], a[mt][ks], b0, b1);
      }
      epi(j, acc);
    }
  }
};

template <>
struct Product<float> {
  using S = Smem<float>;
  template <typename Epi>
  static __device__ __forceinline__ void run(const S& s, const S::Warp& sw,
                                             int grp, int tig, Epi&& epi) {
#pragma unroll 1
    for (int j = 0; j < kTiles; ++j) {
      const int n = 8 * j + 2 * tig;
      float acc[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kK2; k += 4) {
        const float4 w0 = *reinterpret_cast<const float4*>(&s.w2[n][k]);
        const float4 w1 = *reinterpret_cast<const float4*>(&s.w2[n + 1][k]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 x = *reinterpret_cast<const float4*>(
                &sw.x2[16 * mt + grp + 8 * h][k]);
            float& c0 = acc[mt][2 * h];
            float& c1 = acc[mt][2 * h + 1];
            c0 = fmaf(x.x, w0.x, c0); c0 = fmaf(x.y, w0.y, c0);
            c0 = fmaf(x.z, w0.z, c0); c0 = fmaf(x.w, w0.w, c0);
            c1 = fmaf(x.x, w1.x, c1); c1 = fmaf(x.y, w1.y, c1);
            c1 = fmaf(x.z, w1.z, c1); c1 = fmaf(x.w, w1.w, c1);
          }
        }
      }
      epi(j, acc);
    }
  }
};

// one pillar's inputs, as a lane loads them: lane r its point r
struct Points {
  float f[kF];
  int n, cx, cy;
};

__device__ __forceinline__ Points load_points(const float* __restrict__ feats,
                                              const int* __restrict__ counts,
                                              const int* __restrict__ coors,
                                              long long v, int p, int lane) {
  Points pt;
  const float* row = feats + (v * p + lane) * kF;
#pragma unroll
  for (int i = 0; i < kF; ++i) pt.f[i] = lane < p ? __ldg(row + i) : 0.f;
  pt.n = __ldg(counts + v);
  pt.cy = __ldg(coors + 4 * v + 2);
  pt.cx = __ldg(coors + 4 * v + 3);
  return pt;
}

struct Geometry {
  float vx, vy, x_offset, y_offset, eps1, eps2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
pillar_net_kernel(const float* __restrict__ feats,
                  const int* __restrict__ counts,
                  const int* __restrict__ coors, long long n_pillars, int P,
                  const __grid_constant__ Geometry geo,
                  const T* __restrict__ w1, const T* __restrict__ g1,
                  const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ g2, const T* __restrict__ b2,
                  T* __restrict__ out) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S& s = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  typename S::Warp& sw = s.warp[warp];

  for (int i = tid; i < kC2 * kK2; i += kThreads)
    s.w2[i / kK2][i % kK2] = w2[i];
  for (int i = tid; i < kC2; i += kThreads) {
    s.g2[i] = Traits<T>::load(g2 + i);
    s.b2[i] = Traits<T>::load(b2 + i);
  }
  // rows at or past P stay zero: they add nothing to the product
  for (int i = lane; i < kRows * S::kLd; i += 32)
    (&sw.x2[0][0])[i] = Traits<T>::cast(0.f);
  // lane c: layer 1's channel c
  float wc[kD];
#pragma unroll
  for (int k = 0; k < kD; ++k) wc[k] = Traits<T>::load(w1 + lane * kD + k);
  const float gc = Traits<T>::load(g1 + lane), bc = Traits<T>::load(b1 + lane);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long v = static_cast<long long>(blockIdx.x) * kWarps + warp;
  Points next;
  if (v < n_pillars) next = load_points(feats, counts, coors, v, P, lane);
  for (; v < n_pillars; v += stride) {
    const Points pt = next;
    if (v + stride < n_pillars)
      next = load_points(feats, counts, coors, v + stride, P, lane);

    // decoration: lane r, point r
    const int n = pt.n;
    const float denom = fmaxf(static_cast<float>(n), 1.f);
    float mean[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float t = pt.f[i];
#pragma unroll
      for (int o = 16; o > 0; o /= 2) t += __shfl_xor_sync(0xffffffffu, t, o);
      mean[i] = __fdiv_rn(t, denom);
    }
    if (lane < P) {
      const bool valid = lane < n;
      const float cx = __fadd_rn(
          __fmul_rn(static_cast<float>(pt.cx), geo.vx), geo.x_offset);
      const float cy = __fadd_rn(
          __fmul_rn(static_cast<float>(pt.cy), geo.vy), geo.y_offset);
      float x[kD];
#pragma unroll
      for (int i = 0; i < kF; ++i) x[i] = pt.f[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) x[kF + i] = __fsub_rn(pt.f[i], mean[i]);
      x[kF + 3] = __fsub_rn(pt.f[0], cx);
      x[kF + 4] = __fsub_rn(pt.f[1], cy);
#pragma unroll
      for (int k = 0; k < kD; ++k) sw.xs[lane][k] = valid ? x[k] : 0.f;
    }
    __syncwarp();

    // layer 1, lane c: channel c over the P rows; each loop leaves at row
    // P (a branch the warp takes as one), so the rows stay in registers
    float h[kRows];
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r == P) break;
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < kD; ++k) t = fmaf(sw.xs[r][k], wc[k], t);
      h[r] = t;
      sum += t;
    }
    const float fp = static_cast<float>(P);
    const float mu = __fdiv_rn(sum, fp);
    float sq = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r == P) break;
      const float d = __fsub_rn(h[r], mu);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(sq, fp), geo.eps1));
    float hmax = kMasked;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r == P) break;
      h[r] = relu(affine(__fsub_rn(h[r], mu), rstd, gc, bc));
      if (r < n) hmax = fmaxf(hmax, h[r]);
    }
    const T hm = Traits<T>::cast(hmax);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r == P) break;
      sw.x2[r][lane] = Traits<T>::cast(r < n ? h[r] : 0.f);
      sw.x2[r][kC1 + lane] = hm;
    }
    __syncwarp();

    // layer 2: each tile's two groups normed, ReLU'd and maxed in registers
    const float inv_cnt = 1.f / static_cast<float>(4 * P);
    Product<T>::run(s, sw, grp, tig, [&](int j, float (&acc)[kMT][4]) {
      float t = 0.f;  // rows at or past P hold 0
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) t += acc[mt][i];
      const float mu2 = __fmul_rn(group_sum(t), inv_cnt);
      float q = 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = __fsub_rn(acc[mt][i], mu2);
          if (16 * mt + grp + 8 * (i / 2) < P) q = fmaf(d, d, q);
        }
      const float rstd2 = rsqrtf(
          __fadd_rn(__fmul_rn(group_sum(q), inv_cnt), geo.eps2));
      const int c = 8 * j + 2 * tig;
      const float w0 = s.g2[c], w1c = s.g2[c + 1];
      const float b0 = s.b2[c], b1c = s.b2[c + 1];
      float m0 = kMasked, m1 = kMasked;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (16 * mt + grp + 8 * hh < n && 16 * mt + grp + 8 * hh < P) {
            m0 = fmaxf(m0, relu(affine(__fsub_rn(acc[mt][2 * hh], mu2),
                                       rstd2, w0, b0)));
            m1 = fmaxf(m1, relu(affine(__fsub_rn(acc[mt][2 * hh + 1], mu2),
                                       rstd2, w1c, b1c)));
          }
        }
      m0 = rows_max(m0);
      m1 = rows_max(m1);
      if (grp == 0) {
        sw.out[c] = Traits<T>::cast(m0);
        sw.out[c + 1] = Traits<T>::cast(m1);
      }
    });
    __syncwarp();
    // the pillar's 128 outputs, 8 (bf16) or 16 (f32) bytes a lane
    constexpr int kPer = kC2 / 32;
    T* dst = out + v * kC2 + lane * kPer;
    if (kPer * sizeof(T) == 16)
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(&sw.out[lane * kPer]);
    else
      *reinterpret_cast<uint2*>(dst) =
          *reinterpret_cast<const uint2*>(&sw.out[lane * kPer]);
    __syncwarp();  // the warp's rows are rewritten by its next pillar
  }
}

template <typename T>
cudaError_t launch(int device, const float* feats, const int* counts,
                   const int* coors, long long n_pillars, int p,
                   const Geometry& geo, const void* const* params, void* out,
                   cudaStream_t stream) {
  auto kernel = pillar_net_kernel<T>;
  constexpr int kSmem = sizeof(Smem<T>);
  // per card: the attribute set and the blocks an SM holds
  static int blocks_per_sm[16] = {};
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  if (blocks_per_sm[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    blocks_per_sm[device] = per_sm * sms;
  }
  const long long need = (n_pillars + kWarps - 1) / kWarps;
  const long long blocks =
      need < blocks_per_sm[device] ? need : blocks_per_sm[device];
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      feats, counts, coors, n_pillars, p, geo,
      static_cast<const T*>(params[0]), static_cast<const T*>(params[1]),
      static_cast<const T*>(params[2]), static_cast<const T*>(params[3]),
      static_cast<const T*>(params[4]), static_cast<const T*>(params[5]),
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// feats: (n_pillars, points, 5) f32; counts: (n_pillars,) int32;
// coors: (n_pillars, 4) int32 [b, z, y, x]; the pillar centre's x is
// coors[.., 3] * vx + x_offset, its y coors[.., 2] * vy + y_offset. w1
// (32, 10), g1, b1 (32,): layer 1's kernel and norm; w2 (128, 64), g2, b2
// (128,): layer 2's; all six bf16 (is_bf16=1) or f32. out: (n_pillars, 128)
// in the weights' type. Every array contiguous, out 16-byte aligned, all on
// card `device`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for points outside 1..32.
extern "C" int pillar_net(int device, int is_bf16, const float* feats,
                          const int* counts, const int* coors,
                          long long n_pillars, int points, float vx, float vy,
                          float x_offset, float y_offset, float eps1,
                          float eps2, const void* w1, const void* g1,
                          const void* b1, const void* w2, const void* g2,
                          const void* b2, void* out, void* stream) {
  if (points < 1 || points > kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pillars <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Geometry geo{vx, vy, x_offset, y_offset, eps1, eps2};
  const void* params[6] = {w1, g1, b1, w2, g2, b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(device, feats, counts, coors, n_pillars,
                                      points, geo, params, out, s)
              : launch<float>(device, feats, counts, coors, n_pillars, points,
                              geo, params, out, s);
  return static_cast<int>(err);
}
