// GroupNorm(32, C) + ReLU on an NHWC tensor at inference (K11), the norm
// and activation between the BEV neck's convolutions
// (`nn/backbone3d.py:ConvNet`): for x (B, H, W, C),
//
//   y[b, h, w, c] = max((x - mean[b, g]) * rstd[b, g] * gamma[c] + beta[c], 0)
//
// with g = c / (C / 32), mean and rstd = 1 / sqrt(var + eps) over frame b's
// H x W x C / 32 values of group g, var the biased variance, all in f32.
//
// Replaces no TPU kernel: the JAX package's neck (boxer_tpu/nn/backbone3d.py)
// leaves its GroupNorm and ReLU to XLA. On the card torch runs the norm as
// a statistics pass with one block a (frame, group), a parameter pass and an
// apply pass on NCHW, then the ReLU as another pass, and its NCHW output
// makes cuDNN transpose the input and the output of the next convolution.
//
// What bounds it on an H100: bytes. Each call reads x twice (statistics,
// then apply) and writes y once: 3 x 2.03 GB for the pp3d.infer_b4 cell's
// eight calls in bf16 (B 4: 2 of 256 x 469 x 469, 4 of 512 x 235 x 235, 2 of
// 1024 x 118 x 118), 1.82 ms at 3.35 TB/s; the arithmetic is a few
// operations a value.
//
// Design: two launches over one grid of (pixel tile, frame) blocks, a few
// an SM. A thread owns one column of V channels
// of a row, V = gcd(C / 32, 16 bytes over an element's), so its 16-byte (or
// narrower) loads stay inside one group, and walks the tile's rows with
// the block's other row lanes (neighbouring threads read neighbouring
// addresses; the block reads whole rows).
//   Pass 1 (statistics): a thread takes kStatsUnroll rows at once, their
//     exact mean and centred squares, and folds them into its running
//     count, mean and M2 by Chan's combine (Welford by chunks; no E[x²] -
//     E[x]², which cancels in f32 when a group's mean is large against its
//     spread: a group holds 1.76 million values at stage 1). The block's
//     threads of one group are merged in shared memory in a fixed order, and
//     the block writes its 32 groups' (count, mean, M2) to scratch.
//   Pass 2 (apply): each block merges its frame's partials of pass 1 (Chan's
//     combine, a fixed order), folds mean, rstd, gamma and beta into a
//     scale and a shift a channel in shared memory, holds its column's in
//     registers, and streams its tile once: y = max(x * scale + shift, 0),
//     written in the output's type (bf16, or f32 where the weights are f32:
//     a bf16 convolution under autocast, whose GroupNorm torch runs in f32).
// Every sum has a fixed order, so two launches give bitwise-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 32;
constexpr int kMinThreads = 256;   // a block's threads while C / V <= 256
constexpr int kStatsUnroll = 8;    // rows a thread loads at once, pass 1
constexpr int kApplyUnroll = 4;    // pass 2

// A block's most threads at vector width V: C / V for C <= 1024 (V < 4),
// else 256; the register budget a thread follows from it.
template <int V>
constexpr int max_threads() {
  return V >= 4 ? kMinThreads : 1024 / V;
}

template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// A group's (count, mean, M2); `merge` is Chan's combine of a second one.
struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ void merge(Stat& a, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float n = a.n + nb;
  const float d = mb - a.mean;
  const float f = nb / n;
  a.mean += d * f;
  a.m2 += m2b + d * d * a.n * f;
  a.n = n;
}

// The thread's place: column `col` of the row's r = C / V vector columns,
// row lane `lane` of the block's k = threads / r (a block of more than 256
// threads has r of them, k = 1).
struct Place {
  int r, k, col, lane;
  long long begin, end;
  __device__ Place(int c, int v, long long hw, int tile_rows) {
    r = c / v;
    k = blockDim.x / r;
    col = threadIdx.x % r;
    lane = threadIdx.x / r;
    begin = static_cast<long long>(blockIdx.x) * tile_rows;
    end = begin + tile_rows < hw ? begin + tile_rows : hw;
  }
};

// Pass 1: partials[b][tile][g] = (count, mean, M2) of group g over the
// tile's rows of frame b. Dynamic shared memory: 3 floats a thread.
template <typename T, int V>
__global__ void __launch_bounds__(max_threads<V>())
    stats_kernel(const T* __restrict__ x, long long hw, int c, int tile_rows,
                 float* __restrict__ partials) {
  extern __shared__ float red[];
  const Place p(c, V, hw, tile_rows);
  const int b = blockIdx.y, nt = blockDim.x;
  const T* base = x + static_cast<long long>(b) * hw * c + p.col * V;
  Stat s{0.f, 0.f, 0.f};
  if (p.lane < p.k) {
    const long long step = static_cast<long long>(kStatsUnroll) * p.k;
    for (long long row = p.begin + p.lane; row < p.end; row += step) {
      Vec<T, V> v[kStatsUnroll];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) {
        const long long rr = row + static_cast<long long>(u) * p.k;
        if (rr < p.end) {
          v[u] = *reinterpret_cast<const Vec<T, V>*>(base + rr * c);
          cnt = u + 1;
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        if (u < cnt)
#pragma unroll
          for (int e = 0; e < V; ++e) sum += to_f(v[u].v[e]);
      const float nb = static_cast<float>(cnt * V);
      const float mb = sum / nb;
      float q = 0.f;
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        if (u < cnt)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float d = to_f(v[u].v[e]) - mb;
            q = fmaf(d, d, q);
          }
      merge(s, nb, mb, q);
    }
  }
  const int t = threadIdx.x;
  red[t] = s.n;
  red[nt + t] = s.mean;
  red[2 * nt + t] = s.m2;
  __syncthreads();
  if (t < kGroups) {
    // group t's columns: per = C / 32 / V of them, in each row lane
    const int per = p.r / kGroups;
    Stat g{0.f, 0.f, 0.f};
    for (int i = 0; i < p.k; ++i)
      for (int j = 0; j < per; ++j) {
        const int e = i * p.r + t * per + j;
        merge(g, red[e], red[nt + e], red[2 * nt + e]);
      }
    float* out = partials +
                 ((static_cast<long long>(b) * gridDim.x + blockIdx.x) *
                      kGroups + t) * 3;
    out[0] = g.n;
    out[1] = g.mean;
    out[2] = g.m2;
  }
}

// Pass 2: out = max(x * scale + shift, 0) over the tile's rows of frame b,
// from the frame's partials of pass 1, one a tile. Dynamic shared memory:
// 2 C + 3 threads + 64 floats.
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(max_threads<V>())
    apply_kernel(const Tin* __restrict__ x, long long hw, int c,
                 int tile_rows, const float* __restrict__ partials,
                 const Tout* __restrict__ gamma,
                 const Tout* __restrict__ beta, float eps,
                 Tout* __restrict__ y) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, nt = blockDim.x, b = blockIdx.y;
  const int tiles = gridDim.x;
  float* scale = smem;
  float* shift = scale + c;
  float* red = shift + c;
  float* gmean = red + 3 * nt;
  float* grstd = gmean + kGroups;
  {
    // thread t merges group t % 32's partials t / 32, + nt / 32, ...
    const int g = t % kGroups, lanes = nt / kGroups;
    const float* part = partials +
                        static_cast<long long>(b) * tiles * kGroups * 3;
    Stat s{0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = t / kGroups; j < tiles; j += lanes) {
      const float* q = part + (static_cast<long long>(j) * kGroups + g) * 3;
      merge(s, q[0], q[1], q[2]);
    }
    red[t] = s.n;
    red[nt + t] = s.mean;
    red[2 * nt + t] = s.m2;
  }
  __syncthreads();
  if (t < kGroups) {
    Stat s{0.f, 0.f, 0.f};
    for (int j = 0; j < nt / kGroups; ++j) {
      const int e = j * kGroups + t;
      merge(s, red[e], red[nt + e], red[2 * nt + e]);
    }
    gmean[t] = s.mean;
    grstd[t] = rsqrtf(s.m2 / s.n + eps);
  }
  __syncthreads();
  const int cpg = c / kGroups;
  for (int ch = t; ch < c; ch += nt) {
    const int g = ch / cpg;
    const float a = grstd[g] * to_f(gamma[ch]);
    scale[ch] = a;
    shift[ch] = to_f(beta[ch]) - gmean[g] * a;
  }
  __syncthreads();
  const Place p(c, V, hw, tile_rows);
  if (p.lane >= p.k) return;
  float a[V], sh[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    a[e] = scale[p.col * V + e];
    sh[e] = shift[p.col * V + e];
  }
  const long long off = static_cast<long long>(b) * hw * c + p.col * V;
  const long long step = static_cast<long long>(kApplyUnroll) * p.k;
  for (long long row = p.begin + p.lane; row < p.end; row += step) {
    Vec<Tin, V> v[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const long long rr = row + static_cast<long long>(u) * p.k;
      if (rr < p.end)
        v[u] = *reinterpret_cast<const Vec<Tin, V>*>(x + off + rr * c);
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const long long rr = row + static_cast<long long>(u) * p.k;
      if (rr < p.end) {
        Vec<Tout, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e)
          o.v[e] = from_f<Tout>(
              fmaxf(fmaf(to_f(v[u].v[e]), a[e], sh[e]), 0.f));
        *reinterpret_cast<Vec<Tout, V>*>(y + off + rr * c) = o;
      }
    }
  }
}

template <typename Tin, typename Tout, int V>
cudaError_t launch(const void* x, int batch, long long hw, int c, int tiles,
                   float eps, const void* gamma, const void* beta,
                   float* partials, void* y, cudaStream_t stream) {
  const int r = c / V;  // a multiple of 32: C is 32 (C / 32) and V | C / 32
  const int threads = r > kMinThreads ? r : kMinThreads;
  const int rows = static_cast<int>((hw + tiles - 1) / tiles);
  const dim3 grid(tiles, batch);
  stats_kernel<Tin, V><<<grid, threads, 3 * threads * sizeof(float),
                         stream>>>(static_cast<const Tin*>(x), hw, c, rows,
                                   partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (2 * c + 3 * threads + 2 * kGroups) * sizeof(float);
  apply_kernel<Tin, Tout, V><<<grid, threads, smem, stream>>>(
      static_cast<const Tin*>(x), hw, c, rows, partials,
      static_cast<const Tout*>(gamma), static_cast<const Tout*>(beta), eps,
      static_cast<Tout*>(y));
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t by_width(int v, const void* x, int batch, long long hw, int c,
                     int tiles, float eps, const void* gamma,
                     const void* beta, float* partials, void* y,
                     cudaStream_t stream) {
  switch (v) {
    case 8:
      return launch<Tin, Tout, 8>(x, batch, hw, c, tiles, eps, gamma, beta,
                                  partials, y, stream);
    case 4:
      return launch<Tin, Tout, 4>(x, batch, hw, c, tiles, eps, gamma, beta,
                                  partials, y, stream);
    case 2:
      return launch<Tin, Tout, 2>(x, batch, hw, c, tiles, eps, gamma, beta,
                                  partials, y, stream);
    default:
      return launch<Tin, Tout, 1>(x, batch, hw, c, tiles, eps, gamma, beta,
                                  partials, y, stream);
  }
}

}  // namespace

// x: (batch, hw, channels) NHWC, bf16 (in_bf16=1) or f32; gamma, beta:
// (channels,) in the output's type, bf16 (out_bf16=1) or f32 (bf16 output
// needs bf16 input); channels a multiple of 32 up to 1024; tiles: pixel
// tiles a frame, 1..hw; partials: batch x tiles x 32 x 3 f32 of scratch;
// y: x's shape in the output's type.
// Every array contiguous on card `device`, x 16-byte and y 32-byte
// aligned. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments outside these.
extern "C" int group_norm_relu(int device, int in_bf16, int out_bf16,
                               const void* x, int batch, long long hw,
                               int channels, int tiles, float eps,
                               const void* gamma, const void* beta,
                               void* partials, void* y, void* stream) {
  if (channels < kGroups || channels > 1024 || channels % kGroups != 0 ||
      batch < 1 || hw < 1 || tiles < 1 || tiles > hw ||
      (out_bf16 && !in_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // the widest vector inside one group: V | C / 32, 16 bytes at most
  const int cpg = channels / kGroups;
  int v = in_bf16 ? 8 : 4;
  while (cpg % v != 0) v /= 2;
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!in_bf16)
    err = by_width<float, float>(v, x, batch, hw, channels, tiles, eps, gamma,
                                 beta, part, y, s);
  else if (out_bf16)
    err = by_width<__nv_bfloat16, __nv_bfloat16>(
        v, x, batch, hw, channels, tiles, eps, gamma, beta, part, y, s);
  else
    err = by_width<__nv_bfloat16, float>(v, x, batch, hw, channels, tiles,
                                         eps, gamma, beta, part, y, s);
  return static_cast<int>(err);
}
