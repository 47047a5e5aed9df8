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
// What bounds it on an H100. The byte bound, at the segm shape (B 1, H 8,
// LQ 300, P 196, 4 levels at 100x152 .. 13x19): the distinct quad rows its
// taps hit once (39.5 MB in bf16), gx, gy, sw and lw (7.5 MB f32 each) and
// the mask (30.1 MB in bf16) and out: 0.0298 ms (bf16), 0.0506 (f32) at
// 3.35 TB/s. But the taps read 1.88 M quad rows (481 MB in bf16, about 12
// reads of each distinct row), each one combined in f32 at 4 levels, so
// the kernel is bound first by its instructions (per 8 bf16 channels of a
// tap and level: 32 unpacks and 48 FMAs) and by its L1 wavefronts (a warp's
// 16-byte row reads touch 8 lines in bf16, 4 in f32). On an H100 the
// kernel takes about 3x its bound in bf16 and 2.5x in f32, and two probes
// of `tools/bench_kernels.py --k4` (`PERF.md`) show where: with its row
// reads replaced by register values it keeps about two thirds of its time
// in bf16 and half in f32; with every row read an L1 hit, nearly all of it
// in bf16 and four fifths in f32.
//
// Design: a block takes a tile of TQ (kTileQ) consecutive queries of one
// (b, h) and a share of its P taps (grid: query tiles x splits, heads,
// batch; the `splits` blocks of a tile form one thread-block cluster).
// - Tap inputs are read along q: for a chunk of taps the block's threads
//   load gx, gy, sw and lw of (level, tap, TQ queries), TQ consecutive
//   floats of one (b, h, l, p) row, so a 32-byte sector is used whole at
//   TQ >= 8. The thread that loads a tap input forms that tap's row, its 4
//   corner weights (validity folded in) and its two sum weights once and
//   keeps them in shared memory (a float4, a float2 and an int an entry,
//   one array each, so a warp's reads are broadcasts of consecutive
//   entries). The next chunk's inputs are loaded into registers while the
//   current chunk is gathered; one barrier a chunk. No shuffles.
// - Work items are (q, p) pairs of the chunk, spread over every warp: a
//   group of 32/V threads takes one item, each thread V channels (16 bytes:
//   V = 8 in bf16, 4 in f32) of each of the 4 corners of the item's quad
//   row at every level, all 16 reads issued before the combine, which stays
//   in registers. A warp has 8 (bf16) or 4 (f32) items in flight per read
//   instruction. Item i of a chunk is (tap i / TQ, query i % TQ), and group
//   g takes items g, g + G, ..., so a group keeps one query for the whole
//   block (G, the block's groups, is a multiple of TQ).
// - The mask store is 16 bytes a thread: each group writes its head's
//   whole 32-channel slice (64 bytes in bf16) of the (B, LQ, k, k, H*32)
//   row, in the final layout, so no permute follows.
// - `out` is summed in f32 by each group over its own items, then over the
//   groups of a query in shared memory in group order, then over the
//   cluster's blocks in rank order (distributed shared memory). No atomics:
//   two launches give bitwise-equal outputs.
// Every sum is in f32: a level's sample by fmaf over the corners in
// corner order, the mask over the levels in level order; only `out`'s sum
// over the taps runs in the order above.
//
// Tile: kTileQ = 8 queries and kWarps = 4 warps a block (at most 128
// registers, 4 blocks an SM), S blocks a cluster. At the segm shape 8 x 4
// was the fastest of a sweep (`tools/bench_kernels.py --k4`, which builds
// the other shapes from this source: 8 x 8, 16 x 4, 16 x 8 and 32 x 8 at
// this rule's S, and 8 x 4 at 1 to 8 blocks a cluster), in bf16 and in
// f32; 16 or 32 queries a block halve the blocks and lengthen the tail,
// 8 warps hold half the blocks an SM. S is the fewest blocks a cluster
// that give the card 1.5 waves of resident blocks (3 at the segm shape's
// 38 x 8 query tiles: one block a tile, 304 blocks, left 40% of the
// card's block slots idle and ran 1.2-1.25x slower).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCh = 32;            // channels per head
constexpr int kMaxLevels = 4;
constexpr int kItemsPerGroup = 2;  // (q, p) items a group takes a chunk
constexpr int kTileQ = 8;          // queries a block
constexpr int kWarps = 4;          // warps a block
constexpr int kMaxSplits = 8;      // a portable cluster
constexpr int kMaxDevices = 64;

struct Levels {
  const void* table[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
};

// 16 bytes of a quad row's corner as f32 channels and back.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  // channel 2i is the low half of word i
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // round to nearest even, as torch's cast
  __device__ static unsigned two(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

// One 16-byte store (the compiler split the plain assignment into four).
__device__ __forceinline__ void store16(void* p, const uint4& v) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A chunk's taps as the gather reads them: entry [l][i] is level l of item
// i (tap i / TQ, query i % TQ of the tile).
template <int kItems>
struct Stage {
  float4 w[kMaxLevels][kItems];   // corner weights, zero for an invalid tap
  float2 s[kMaxLevels][kItems];   // spatial and level weight
  int row[kMaxLevels][kItems];
};

template <int kItems, int kGroups, int TQ>
struct Smem {
  union {
    Stage<kItems> st[2];       // the chunk being gathered and the next one
    float red[kGroups * kCh];  // the groups' partial `out` sums, at the end
  };
  float part[TQ * kCh];        // the block's `out` sums, read by the cluster
};

template <typename T>
struct Tile {
  static constexpr int TQ = kTileQ;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kVec = Pack<T>::kN;
  static constexpr int kTpr = kCh / kVec;           // threads a quad row
  static constexpr int kGroups = kThreads / kTpr;
  static constexpr int kItems = kItemsPerGroup * kGroups;
  static constexpr int kTaps = kItems / TQ;         // taps a chunk
  // the tap entries a thread stages a chunk
  static constexpr int kPer = kMaxLevels * kItems / kThreads;
  // a group keeps one query; the staging covers the chunk evenly
  static_assert(kGroups % TQ == 0 && (kMaxLevels * kItems) % kThreads == 0,
                "a block's item groups must cover its queries evenly");
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
instance_sample_kernel(const __grid_constant__ Levels lv, int n_levels,
                       const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ sw,
                       const float* __restrict__ lw, T* __restrict__ out,
                       T* __restrict__ mask, int heads, int p_taps, int lq) {
  using K = Tile<T>;
  constexpr int TQ = K::TQ, kVec = K::kVec, kItems = K::kItems,
                kGroups = K::kGroups;
  __shared__ __align__(16) Smem<kItems, kGroups, TQ> sm;

  // the cluster's blocks split the tile's taps by chunks
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int q0 = static_cast<int>(blockIdx.x) / splits * TQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long bh = b * heads + h;

  // the tap inputs this thread stages, loaded a chunk ahead
  float rx[K::kPer] = {}, ry[K::kPer] = {}, rs[K::kPer] = {},
        rl[K::kPer] = {};
  auto fetch = [&](int p0) {
#pragma unroll
    for (int k = 0; k < K::kPer; ++k) {
      const int e = tid + k * K::kThreads;
      const int l = e / kItems, it = e % kItems;
      const int p = p0 + it / TQ, q = q0 + it % TQ;
      if (l < n_levels && p < p_taps && q < lq) {
        const long long at = ((bh * n_levels + l) * p_taps + p) * lq + q;
        rx[k] = __ldg(gx + at);
        ry[k] = __ldg(gy + at);
        rs[k] = __ldg(sw + at);
        rl[k] = __ldg(lw + at);
      }
    }
  };
  auto stage = [&](Stage<kItems>& s, int p0) {
#pragma unroll
    for (int k = 0; k < K::kPer; ++k) {
      const int e = tid + k * K::kThreads;
      const int l = e / kItems, it = e % kItems;
      const int p = p0 + it / TQ, q = q0 + it % TQ;
      int row = 0;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f, a = 0.f, c = 0.f;
      if (l < n_levels && p < p_taps && q < lq) {
        const int hl = lv.h[l], wl = lv.w[l];
        const float x = __fsub_rn(__fmul_rn(rx[k], static_cast<float>(wl)),
                                  0.5f);
        const float y = __fsub_rn(__fmul_rn(ry[k], static_cast<float>(hl)),
                                  0.5f);
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
        // clamped into [-2, W] first, so that a far tap cannot overflow
        // xi + 1; validity and the clamped row are the same either way
        const int xi = static_cast<int>(fminf(fmaxf(x0, -2.f), wl));
        const int yi = static_cast<int>(fminf(fmaxf(y0, -2.f), hl));
        const float valid = (xi >= -1 && xi <= wl - 1 && yi >= -1 &&
                             yi <= hl - 1) ? 1.f : 0.f;
        const int xq = min(max(xi + 1, 0), wl), yq = min(max(yi + 1, 0), hl);
        row = static_cast<int>((bh * (hl + 1) + yq) * (wl + 1) + xq);
        // `corner_weights`' order and rounding: x's factor, y's, validity
        const float gx0 = __fsub_rn(1.f, fx), gy0 = __fsub_rn(1.f, fy);
        w0 = __fmul_rn(__fmul_rn(gx0, gy0), valid);
        w1 = __fmul_rn(__fmul_rn(fx, gy0), valid);
        w2 = __fmul_rn(__fmul_rn(gx0, fy), valid);
        w3 = __fmul_rn(__fmul_rn(fx, fy), valid);
        a = rs[k];
        c = rl[k];
      }
      s.w[l][it] = make_float4(w0, w1, w2, w3);
      s.s[l][it] = make_float2(a, c);
      s.row[l][it] = row;
    }
  };

  const int g = tid / K::kTpr, j = tid % K::kTpr;
  const int q = q0 + g % TQ;
  const long long tap_stride = static_cast<long long>(heads) * kCh;
  const long long mask_q = (b * lq + q) * p_taps * tap_stride + h * kCh +
                           j * kVec;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  const int n_chunks = (p_taps + K::kTaps - 1) / K::kTaps;
  const int c0 = rank * n_chunks / splits;
  const int c1 = (rank + 1) * n_chunks / splits;
  if (c0 < c1) {
    fetch(c0 * K::kTaps);
    stage(sm.st[c0 & 1], c0 * K::kTaps);
  }
  __syncthreads();
  for (int ci = c0; ci < c1; ++ci) {
    const int p0 = ci * K::kTaps;
    const bool more = ci + 1 < c1;
    if (more) fetch(p0 + K::kTaps);
    const Stage<kItems>& s = sm.st[ci & 1];
#pragma unroll
    for (int i = 0; i < kItemsPerGroup; ++i) {
      const int it = g + i * kGroups;
      const int p = p0 + it / TQ;
      if (q >= lq || p >= p_taps) continue;
      uint4 v[kMaxLevels][4];
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l < n_levels) {
          const T* src = static_cast<const T*>(lv.table[l]) +
                         static_cast<long long>(s.row[l][it]) * 4 * kCh +
                         j * kVec;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[l][c] = __ldg(reinterpret_cast<const uint4*>(src + c * kCh));
        }
      }
      float m[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) m[e] = 0.f;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l < n_levels) {
          const float4 w4 = s.w[l][it];
          const float wc[4] = {w4.x, w4.y, w4.z, w4.w};
          const float2 sl = s.s[l][it];
          float smp[kVec];
#pragma unroll
          for (int e = 0; e < kVec; ++e) smp[e] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float f[kVec];
            Pack<T>::unpack(v[l][c], f);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              smp[e] = fmaf(f[e], wc[c], smp[e]);
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[e] = fmaf(smp[e], sl.x, acc[e]);
            m[e] = fmaf(smp[e], sl.y, m[e]);
          }
        }
      }
      store16(mask + mask_q + p * tap_stride, Pack<T>::pack(m));
    }
    if (more) stage(sm.st[(ci + 1) & 1], p0 + K::kTaps);
    __syncthreads();
  }

  // out: the groups of a query summed in group order, then the blocks of
  // the cluster in rank order (no atomics)
#pragma unroll
  for (int e = 0; e < kVec; e += 4)
    *reinterpret_cast<float4*>(&sm.red[g * kCh + j * kVec + e]) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  __syncthreads();
  for (int t = tid; t < TQ * kCh; t += K::kThreads) {
    float sum = 0.f;
    for (int gg = t / kCh; gg < kGroups; gg += TQ)
      sum += sm.red[gg * kCh + t % kCh];
    sm.part[t] = sum;
  }
  cluster.sync();
  for (int t = rank * K::kThreads + tid; t < TQ * kCh;
       t += splits * K::kThreads) {
    const int ql = t / kCh;
    if (q0 + ql >= lq) continue;
    float sum = 0.f;
    for (int r = 0; r < splits; ++r)
      sum += cluster.map_shared_rank(&sm.part[0], r)[t];
    out[(bh * lq + q0 + ql) * kCh + t % kCh] = from_f32<T>(sum);
  }
  cluster.sync();  // the other blocks' sums stay until read
}

// Launches the kernel on clusters of `splits` blocks.
template <typename T>
cudaError_t launch(int splits, const Levels& lv, int n_levels,
                   const float* gx, const float* gy, const float* sw,
                   const float* lw, void* out, void* mask, int batch,
                   int heads, int p_taps, int lq, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  const int tiles = (lq + kTileQ - 1) / kTileQ;
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * splits),
                     static_cast<unsigned>(heads),
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, instance_sample_kernel<T>, lv, n_levels, gx,
                            gy, sw, lw, static_cast<T*>(out),
                            static_cast<T*>(mask), heads, p_taps, lq);
}

// The cluster size at B, H, LQ: the fewest blocks a cluster that give the
// card 1.5 waves of resident blocks or more (a single partial wave idles
// SMs), at most kMaxSplits. The card's resident blocks are read once a
// device and dtype.
int cluster_size(int device, int is_bf16, int batch, int heads, int lq) {
  static int resident[2][kMaxDevices] = {};
  int r = device < kMaxDevices ? resident[is_bf16][device] : 0;
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (is_bf16)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, instance_sample_kernel<__nv_bfloat16>, kWarps * 32, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, instance_sample_kernel<float>, kWarps * 32, 0);
    r = sms * per_sm > 0 ? sms * per_sm : 1;
    if (device < kMaxDevices) resident[is_bf16][device] = r;
  }
  const long long units =
      static_cast<long long>((lq + kTileQ - 1) / kTileQ) * heads * batch;
  for (int s = 1; s < kMaxSplits; ++s)
    if (2 * units * s >= 3LL * r) return s;
  return kMaxSplits;
}

}  // namespace

// The tile a launch takes at this shape on card `device`: tile[0..2] =
// queries and warps a block, blocks a cluster. Returns a CUDA error code.
extern "C" int instance_sample_tile(int device, int is_bf16, int batch,
                                    int heads, int lq, int* tile) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  tile[0] = kTileQ;
  tile[1] = kWarps;
  tile[2] = cluster_size(device, is_bf16 != 0, batch, heads, lq);
  return static_cast<int>(cudaGetLastError());
}

// tables t0..t3 (the first n_levels used): level l's quad table (batch *
// heads * (H_l+1) * (W_l+1), 4*32) bf16 (is_bf16=1) or f32, 16-byte
// aligned; level_hw: host array (H_0, W_0, H_1, W_1, ...); gx, gy, sw, lw:
// (batch, heads, n_levels, p_taps, lq) f32; out: (batch, heads, lq, 32) and
// mask: (batch, lq, p_taps, heads*32), in the tables' dtype, 16-byte
// aligned; all on card `device`. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for n_levels outside 1..4, heads or
// batch outside 1..65535, or p_taps < 1.
extern "C" int instance_sample_reduce(
    int device, int is_bf16, const void* t0, const void* t1, const void* t2,
    const void* t3, const int* level_hw, int n_levels, const float* gx,
    const float* gy, const float* sw, const float* lw, void* out, void* mask,
    int batch, int heads, int p_taps, int lq, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || heads < 1 || heads > 65535 ||
      batch > 65535 || p_taps < 1)
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
  const int splits = cluster_size(device, is_bf16 != 0, batch, heads, lq);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(splits, lv, n_levels, gx, gy, sw, lw,
                                      out, mask, batch, heads, p_taps, lq, s)
              : launch<float>(splits, lv, n_levels, gx, gy, sw, lw, out, mask,
                              batch, heads, p_taps, lq, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
