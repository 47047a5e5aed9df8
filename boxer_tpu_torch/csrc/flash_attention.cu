// Online-softmax attention forward: out = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel `flash_attention`
// (boxer_tpu/ops/pallas/flash_attention.py:69, `_flash_kernel` :28). Same
// rules: running max and sum in f32, an optional additive f32 key mask
// (BH, Lkv), a row whose sum is 0 outputs 0, and the output is in q's
// dtype. Ragged sequence edges are not padded: a key past Lkv scores -inf
// (the Pallas kernel pads keys with NEG_INF, which would also average the
// padding into a row whose real keys are all masked), a query row past Lq
// is not stored.
//
// What bounds it on an H100: at the decoder's shape (BH=8, L=300, D=32) the
// whole problem is 92 MFLOP over 0.6 MB, 0.0002 ms of bytes at 3.35 TB/s
// and less of bf16 operations at 989 TFLOP/s. Neither rate is near: the
// time is the latency of staging K and V and of the online softmax's
// dependent chain over the keys, and the parallelism one launch exposes.
// `wgmma` and TMA buy rate, which this size does not need, so:
//
// bf16 (the main path: the decoder's self-attention in bf16 inference and
//   under autocast in training): a block of kWarps = 2 warps owns 32 query
//   rows of one head, 16 a warp (80 blocks at BH=8, L=300; 4-warp blocks,
//   40 of them, took 0.0068 ms of device time against 0.0062 on an H100
//   80GB HBM3 at 700 W, `tools/bench_kernels.py`). The head's K and V (and
//   mask row) arrive in 64-key tiles by `cp.async` into a ring
//   of kStages = 5 tiles in shared memory: up to 320 keys every tile is in
//   flight before the first is used; beyond that a slot is refilled once
//   its tile is consumed, so any Lkv works. Rows are 64 bytes, 16-byte
//   chunks XOR-swizzled so an mma fragment's 8 key rows hit 8 bank groups.
//   Scores q k^T are `mma.sync.m16n8k16` in bf16 with f32 accumulation (D=32
//   is two k-steps); products of bf16 values are exact in f32, so the
//   scores equal an f32 kernel's up to summation order. The online softmax
//   runs over each 64-key tile in registers, a row's max reduced over the 4
//   lanes that share it by `__shfl_xor_sync`. p v is two mmas, p split into
//   a bf16 high part and a bf16 low part, so p keeps about 16 significant
//   bits as the TPU kernel's f32 p does.
// f32 (the card-vs-CPU checks in f32): one thread a query row on CUDA
//   cores, K and V tiles in shared memory as f32 read by broadcast, both
//   products FMA loops. TF32 tensor cores would miss those checks' 1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 32;  // head width, the only one any shipped config uses

// f32 mode
constexpr int kBlockQ = 32;  // query rows per block (one thread each)
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update

// bf16 mode
constexpr int kWarps = 2;             // warps a block, 16 query rows each
constexpr int kRowsQ = 16 * kWarps;   // query rows a block
constexpr int kTileK = 64;            // keys a staged tile and softmax chunk
constexpr int kStages = 5;            // tiles in the shared-memory ring
constexpr int kRowBytes = kD * 2;     // a bf16 key row

__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int lq, int lkv, float scale) {
  __shared__ float ks[kBlockK][kD];
  __shared__ float vs[kBlockK][kD];
  __shared__ float ms[kBlockK];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool active = row < lq;

  float qr[kD];
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = active ? q[(static_cast<long long>(bh) * lq + row) * kD + d] : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  const float* kb = k + static_cast<long long>(bh) * lkv * kD;
  const float* vb = v + static_cast<long long>(bh) * lkv * kD;
  for (int kv0 = 0; kv0 < lkv; kv0 += kBlockK) {
    const int n = min(kBlockK, lkv - kv0);
    for (int i = threadIdx.x; i < kBlockK * kD; i += kBlockQ) {
      const int j = i / kD, d = i % kD;
      const bool in = j < n;
      ks[j][d] = in ? kb[static_cast<long long>(kv0 + j) * kD + d] : 0.f;
      vs[j][d] = in ? vb[static_cast<long long>(kv0 + j) * kD + d] : 0.f;
    }
    for (int j = threadIdx.x; j < kBlockK; j += kBlockQ) {
      ms[j] = (mask != nullptr && j < n)
                  ? mask[static_cast<long long>(bh) * lkv + kv0 + j]
                  : 0.f;
    }
    __syncthreads();

    if (active) {
      for (int j0 = 0; j0 < n; j0 += kChunk) {
        float s[kChunk];
        float m_new = m_run;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          if (j0 + jj < n) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < kD; ++d) dot += qr[d] * ks[j0 + jj][d];
            s[jj] = dot * scale + ms[j0 + jj];
            m_new = fmaxf(m_new, s[jj]);
          } else {
            s[jj] = -INFINITY;
          }
        }
        const float alpha = expf(m_run - m_new);
        l_run *= alpha;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float p = expf(s[jj] - m_new);
          l_run += p;
          if (j0 + jj < n) {
#pragma unroll
            for (int d = 0; d < kD; ++d) acc[d] += p * vs[j0 + jj][d];
          }
        }
        m_run = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float l_inv = l_run == 0.f ? 1.f : 1.f / l_run;
    float* o = out + (static_cast<long long>(bh) * lq + row) * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] = acc[d] * l_inv;
  }
}

// asynchronous copies into shared memory; zero-fill when !ok (src is then
// not read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

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

// byte offset of 16-byte chunk c (0..3) of key row r in a tile: rows r,
// r+2, r+4, r+6 share banks at 64 bytes a row, so their chunks are
// XOR-permuted apart
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
}

// d += a b, a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return static_cast<unsigned>(__bfloat16_as_ushort(h.x)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(h.y)) << 16);
}

// (x, y) -> bf16 pairs hi and lo with hi + lo = (x, y) to about 16 bits
__device__ __forceinline__ void split(float x, float y, unsigned& hi,
                                      unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// A warp's fragments (mma.m16n8k16; g = lane / 4, t = lane % 4): the A
// operand's 4 registers hold rows g, g+8 at columns 2t, 2t+1 and 2t+8,
// 2t+9; B's 2 hold rows (k) 2t, 2t+1 and 2t+8, 2t+9 of column (n) g; the
// accumulator's 4 hold rows g, g+8 at columns 2t, 2t+1.
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, int lq, int lkv,
                      float scale) {
  __shared__ __align__(16) unsigned char ks[kStages][kTileK * kRowBytes];
  __shared__ __align__(16) unsigned char vs[kStages][kTileK * kRowBytes];
  __shared__ float ms[kStages][kTileK];

  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRowsQ + (threadIdx.x >> 5) * 16;
  const int n_tiles = (lkv + kTileK - 1) / kTileK;
  const __nv_bfloat16* kb = k + static_cast<long long>(bh) * lkv * kD;
  const __nv_bfloat16* vb = v + static_cast<long long>(bh) * lkv * kD;
  const float* mb =
      mask == nullptr ? nullptr : mask + static_cast<long long>(bh) * lkv;

  // tile j (keys 64j..) into ring slot j % kStages, keys past lkv zeroed;
  // one commit group a tile, empty past the last
  auto stage = [&](int j) {
    if (j < n_tiles) {
      const int slot = j % kStages, kv0 = j * kTileK;
      for (int e = threadIdx.x; e < kTileK * 4; e += kWarps * 32) {
        const int r = e >> 2, c = e & 3;
        const bool ok = kv0 + r < lkv;
        const long long off =
            ok ? static_cast<long long>(kv0 + r) * kD + c * 8 : 0;
        cp_async16(ks[slot] + swz(r, c), kb + off, ok);
        cp_async16(vs[slot] + swz(r, c), vb + off, ok);
      }
      if (mb != nullptr) {
        for (int r = threadIdx.x; r < kTileK; r += kWarps * 32) {
          const bool ok = kv0 + r < lkv;
          cp_async4(&ms[slot][r], mb + (ok ? kv0 + r : 0), ok);
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < kStages - 1; ++j) stage(j);

  // q's A fragments for the two k-steps over D, rows past lq zero
  unsigned qa[2][4];
  {
    const unsigned* qb = reinterpret_cast<const unsigned*>(
        q + static_cast<long long>(bh) * lq * kD);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + g + 8 * (i & 1);
        const int d = 16 * s + 8 * (i >> 1) + 2 * t;
        qa[s][i] = r < lq ? __ldg(qb + (r * kD + d) / 2) : 0u;
      }
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j has landed (this thread's part)
    __syncthreads();               // ... every thread's; slot j-1 is free
    stage(j + kStages - 1);
    const int slot = j % kStages, kv0 = j * kTileK;
    const unsigned char* kt = ks[slot];
    const unsigned char* vt = vs[slot];

    // s = q k^T over the tile's 8 key blocks of 8
    float s[kTileK / 8][4];
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const int r = 8 * n + g;
#pragma unroll
      for (int ksp = 0; ksp < 2; ++ksp) {
        const unsigned b0 =
            *reinterpret_cast<const unsigned*>(kt + swz(r, 2 * ksp) + 4 * t);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(
            kt + swz(r, 2 * ksp + 1) + 4 * t);
        mma_bf16(s[n], qa[ksp], b0, b1);
      }
    }

    // scale, mask, ragged keys; the row maxima (h: row g or g+8)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * n + 2 * t + (e & 1);
        const float x =
            s[n][e] * scale + (mb != nullptr ? ms[slot][key] : 0.f);
        s[n][e] = kv0 + key < lkv ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      base[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      alpha[h] = __expf(m_run[h] - base[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - base[e >> 1]);
        l_run[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p v over the tile's 4 key steps of 16: p's accumulator
    // fragments of key blocks 2kk and 2kk+1 are the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      unsigned hi[4], lo[4];
      split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int d = 8 * n + g;
        unsigned b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 16 * kk + 8 * i + 2 * t;
          const unsigned x0 = *reinterpret_cast<const unsigned short*>(
              vt + swz(r, d >> 3) + 2 * (d & 7));
          const unsigned x1 = *reinterpret_cast<const unsigned short*>(
              vt + swz(r + 1, d >> 3) + 2 * (d & 7));
          b[i] = x0 | (x1 << 16);
        }
        mma_bf16(o[n], hi, b[0], b[1]);
        mma_bf16(o[n], lo, b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = l == 0.f ? 1.f : 1.f / l;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= lq) continue;
    unsigned* orow = reinterpret_cast<unsigned*>(
        out + (static_cast<long long>(bh) * lq + r) * kD);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      orow[(8 * n + 2 * t) / 2] = bits(__floats2bfloat162_rn(
          o[n][2 * h] * inv[h], o[n][2 * h + 1] * inv[h]));
    }
  }
}

}  // namespace

// q: (BH, Lq, D), k, v: (BH, Lkv, D) in bf16 (is_bf16=1) or f32, contiguous
// and 16-byte aligned; mask: (BH, Lkv) f32 or null; out: (BH, Lq, D) in q's
// dtype, all on card `device`. D must be 32, the head width of every
// shipped config. bf16 takes the tensor-core kernel, f32 the CUDA-core one.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const float* mask,
                                   void* out, int is_bf16, int bh, int lq,
                                   int lkv, int d, float scale, void* stream) {
  if (d != kD) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || lq <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((lq + kRowsQ - 1) / kRowsQ, bh);
    flash_fwd_bf16_kernel<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask,
        static_cast<__nv_bfloat16*>(out), lq, lkv, scale);
  } else {
    const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
    flash_fwd_f32_kernel<<<grid, kBlockQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<float*>(out), lq,
        lkv, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
