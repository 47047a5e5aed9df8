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
// walk the taps serially; on the card the taps run in parallel, so indices
// are global rows of the flat per-level table and the TPU's dump rows and
// bh-relative indexing are not needed. K7a and K7b differ only in the
// caller's index layout.
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
// What bounds the rows mode: device-memory bytes. At the folded encoder's
// level 0 (P=4, M=161,576 taps over a 123,624-row table, bf16 payload) it
// must read the payload (165.5 MB) and idx and write the f32 table (63.3
// MB): 0.069 ms at 3.35 TB/s. Scattering tap by tap, as f32 atomics into a
// zeroed table, took four times that: a 63 MB zero fill and 2.6M warp-wide
// reductions in L2, hundreds of them on one row where the taps crowd (the
// encoder's level 3 gets about 288 taps a row). So the taps are grouped by
// row and each row is summed once, in registers, in four kernels:
// - count: a histogram of idx with integer atomics, the lanes of a warp
//   that hit one row adding once (`__match_any_sync`); the count an atomic
//   returns ranks the tap inside its row;
// - scan: one pass over the counts (a tile of 1,024 rows a block, the
//   totals of the tiles before it read as soon as they are published)
//   gives each row its segment; a row of c taps is cut into ceil(c / 32)
//   pieces, and the same 64-bit scan numbers them;
// - place: each tap writes its index into its row's segment at its rank
//   (`perm`; no atomics);
// - reduce: a group of lanes (16 in bf16, 32 in f32, 16 bytes each) takes
//   a piece, reads its taps' indices in one coalesced load, keeps 8 taps'
//   payload rows in flight and sums them in f32 registers. A one-piece row
//   (most rows, and every row with no tap) is written once with float4
//   stores, zeros included, so the output needs no zero fill; the pieces
//   of a long row leave partials and the last of them to finish, by a
//   ticket on the row's count, adds them. No f32 atomics remain. The sum
//   of a row follows the placement's order, which the atomics set, so two
//   runs may differ in the last bits.
// Beside payload, idx and the output the scratch moves about 13 MB at the
// shape above (idx read twice, rank and perm written and read, the
// counts): within 8% of the bound.
//
// An index outside [0, rows) traps, which surfaces as a launch failure at
// the next sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kCh = 32;            // channels per head
constexpr int kWarpsPerBlock = 8;  // weighted: 256 threads
constexpr int kTileM = 32;         // weighted: outputs per block
constexpr int kTileP = 4;          // weighted: taps of each output per block

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

// ---- rows mode: count, scan, place, reduce --------------------------------

constexpr int kRowsThreads = 256;  // every rows-mode kernel
constexpr int kScanItems = 4;      // scan: rows a thread (one int4)
constexpr int kScanTile = kRowsThreads * kScanItems;
constexpr int kSplit = 32;         // reduce: taps an owner at most
constexpr int kRowsMaxBlocks = 4096;  // count, place: grid-stride cap
constexpr unsigned long long kReady = 1ull << 63;  // scan: tile published

// The scratch of one call, carved from one int32 buffer: the part zeroed
// before the launch (cnt, the scan's tile ticket and tile status words),
// then off and exoff (rows + 1 each), rank and perm (n_taps each), erow and
// the partial rows of long segments (n_taps / kSplit + 1 each). Sections
// start on 16-byte boundaries.
struct RowsScratch {
  int* cnt;      // taps a row, then the reduce's ticket on top of them
  int* ticket;   // scan: tiles in the order they start
  unsigned long long* status;  // scan: tile total | kReady, 0 until then
  int* off;      // first tap of a row's segment in perm; off[rows] = n
  int* exoff;    // first extra piece of a row; exoff[rows] = extra pieces
  int* rank;     // a tap's place among its row's taps
  int* perm;     // taps grouped by row
  int* erow;     // the row of each extra piece
  float* part;   // (extra pieces, 128) partial sums of long rows
  long long zero_words, words;
};

long long round4(long long w) { return (w + 3) / 4 * 4; }

RowsScratch carve(int* base, long long rows, int n_taps) {
  RowsScratch s;
  const long long tiles = (rows + kScanTile - 1) / kScanTile;
  const long long extra = n_taps / kSplit + 1;
  long long w = 0;
  auto take = [&](long long words) {
    int* p = base ? base + w : nullptr;
    w += round4(words);
    return p;
  };
  s.cnt = take(rows);
  s.ticket = take(1);
  s.status = reinterpret_cast<unsigned long long*>(take(2 * tiles));
  s.zero_words = w;
  s.off = take(rows + 1);
  s.exoff = take(rows + 1);
  s.rank = take(n_taps);
  s.perm = take(n_taps);
  s.erow = take(extra);
  s.part = reinterpret_cast<float*>(take(extra * 4 * kCh));
  s.words = w;
  return s;
}

// A row of c taps: (c << 32) | its extra pieces, ceil(c / kSplit) - 1, so
// one 64-bit scan yields both offsets (c < 2^31; the pieces sum below 2^32)
__device__ __forceinline__ unsigned long long packed(int c) {
  return (static_cast<unsigned long long>(c) << 32) |
         static_cast<unsigned>(c > 0 ? (c - 1) / kSplit : 0);
}

// rank[t] = cnt[idx[t]]++. The lanes of a warp that hit one row add once
// and rank themselves by lane, so a row that many neighbouring taps share
// takes one atomic a warp.
__global__ void __launch_bounds__(kRowsThreads)
rows_count_kernel(const int* __restrict__ idx, int n_taps, long long rows,
                  int* __restrict__ cnt, int* __restrict__ rank) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kRowsThreads +
                        (threadIdx.x & ~31);
       base < n_taps; base += stride) {
    const long long t = base + lane;
    int r = -1;
    if (t < n_taps) {
      r = __ldg(idx + t);
      if (r < 0 || r >= rows) __trap();
    }
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (r >= 0 && lane == leader) at = atomicAdd(cnt + r, __popc(peers));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (r >= 0) rank[t] = at + __popc(peers & ((1u << lane) - 1));
  }
}

// u64 sum over the block, once a kernel; every thread gets it
__device__ unsigned long long block_sum(unsigned long long v,
                                        unsigned long long* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  unsigned long long sum = 0;
#pragma unroll
  for (int i = 0; i < kRowsThreads / 32; ++i) sum += s_red[i];
  return sum;
}

// Exclusive scan of packed(cnt) in one pass: a block takes the next tile
// of kScanTile rows (a 16-byte load and store a thread) by ticket, publishes the tile's total at once, and adds
// the totals of the tiles before it, which have all started (their tickets
// came first) and publish theirs without waiting. Writes off, exoff and
// erow.
__global__ void __launch_bounds__(kRowsThreads)
rows_scan_kernel(const int* __restrict__ cnt, int* __restrict__ ticket,
                 unsigned long long* __restrict__ status,
                 int* __restrict__ off, int* __restrict__ exoff,
                 int* __restrict__ erow, long long rows) {
  __shared__ int s_tile;
  __shared__ unsigned long long s_warp[kRowsThreads / 32];
  __shared__ unsigned long long s_red[kRowsThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long r0 =
      static_cast<long long>(tile) * kScanTile + tid * kScanItems;

  int c[kScanItems];
  if (r0 + kScanItems <= rows) {
    const int4 v = *reinterpret_cast<const int4*>(cnt + r0);
    c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) c[i] = r0 + i < rows ? cnt[r0 + i] : 0;
  }
  unsigned long long sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) sum += packed(c[i]);
  unsigned long long inc = sum;  // inclusive scan across the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  unsigned long long before_warp = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kRowsThreads / 32; ++i) {
    if (i < warp) before_warp += s_warp[i];
    total += s_warp[i];
  }
  if (tid == 0) {
    *reinterpret_cast<volatile unsigned long long*>(status + tile) =
        total | kReady;
  }
  unsigned long long pre = 0;
  for (int j = tid; j < tile; j += kRowsThreads) {
    unsigned long long v;
    do {
      v = *reinterpret_cast<volatile unsigned long long*>(status + j);
    } while (!(v & kReady));
    pre += v & ~kReady;
  }
  unsigned long long run = block_sum(pre, s_red) + before_warp + inc - sum;

  int o[kScanItems], e[kScanItems];
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    o[i] = static_cast<int>(run >> 32);
    e[i] = static_cast<int>(run & 0xffffffffu);
    const long long r = r0 + i;
    if (r < rows) {
      const int extra = static_cast<int>(packed(c[i]) & 0xffffffffu);
      for (int k = 0; k < extra; ++k) erow[e[i] + k] = static_cast<int>(r);
    }
    run += packed(c[i]);
    if (r == rows - 1) {
      off[rows] = static_cast<int>(run >> 32);
      exoff[rows] = static_cast<int>(run & 0xffffffffu);
    }
  }
  if (r0 + kScanItems <= rows) {
    *reinterpret_cast<int4*>(off + r0) = make_int4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<int4*>(exoff + r0) = make_int4(e[0], e[1], e[2], e[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (r0 + i < rows) {
        off[r0 + i] = o[i];
        exoff[r0 + i] = e[i];
      }
    }
  }
}

// perm[off[idx[t]] + rank[t]] = t
__global__ void __launch_bounds__(kRowsThreads)
rows_place_kernel(const int* __restrict__ idx, const int* __restrict__ rank,
                  int n_taps, const int* __restrict__ off,
                  int* __restrict__ perm) {
  const long long stride = static_cast<long long>(gridDim.x) * kRowsThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kRowsThreads +
                     threadIdx.x;
       t < n_taps; t += stride)
    perm[off[__ldg(idx + t)] + rank[t]] = static_cast<int>(t);
}

// A payload row read as 16-byte vectors: kLanes lanes of kVals values
template <typename G>
struct Payload;

template <>
struct Payload<__nv_bfloat16> {
  static constexpr int kLanes = 16, kVals = 8;
  static __device__ __forceinline__ void add(float* acc, uint4 v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
};

template <>
struct Payload<float> {
  static constexpr int kLanes = 32, kVals = 4;
  static __device__ __forceinline__ void add(float* acc, uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
};

template <int kVals>
__device__ __forceinline__ void store_vals(float* dst, const float* acc) {
#pragma unroll
  for (int i = 0; i < kVals; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}

// A group of kLanes lanes (an "owner") sums one piece of a row's segment in
// registers: owner o < rows takes piece 0 of row o, owner rows + e the
// extra piece e. A row of at most kSplit taps is one piece, written to out
// once (zeros when no tap lands); the pieces of a longer row leave partials
// (piece 0 in its out row, piece j in part[exoff + j - 1]) and the last to
// finish, by a ticket counted on top of the row's taps in cnt, adds the
// others' and writes the row.
template <typename G>
__global__ void __launch_bounds__(kRowsThreads, 4)
rows_reduce_kernel(const G* __restrict__ payload, const int* __restrict__ off,
                   const int* __restrict__ exoff, const int* __restrict__ erow,
                   const int* __restrict__ perm, int* __restrict__ cnt,
                   float* __restrict__ part, float* __restrict__ out,
                   long long rows) {
  constexpr int kLanes = Payload<G>::kLanes, kVals = Payload<G>::kVals;
  constexpr int kRow16 = 4 * kCh * sizeof(G) / 16;
  constexpr int kU = 8;  // taps' rows in flight
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask =
      kLanes == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  const long long o =
      (static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x) /
      kLanes;
  long long r = o;
  int j = 0;
  if (o >= rows) {
    const long long x = o - rows;
    if (x >= exoff[rows]) return;
    r = erow[x];
    j = static_cast<int>(x - exoff[r]) + 1;
  }
  const int row_begin = off[r], row_end = off[r + 1], ex = exoff[r];
  const int pieces = 1 + exoff[r + 1] - ex;
  const int s = row_begin + j * kSplit, e = min(row_end, s + kSplit);

  float acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;
  const uint4* rows16 = reinterpret_cast<const uint4*>(payload);
  for (int k = s; k < e; k += kLanes) {
    const int mine = k + lane < e ? perm[k + lane] : 0;  // kLanes taps
    const int n = min(kLanes, e - k);
    for (int u0 = 0; u0 < n; u0 += kU) {
      uint4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = __shfl_sync(gmask, mine, u0 + u, kLanes);
        if (u0 + u < n)
          v[u] = __ldcs(rows16 + static_cast<long long>(t) * kRow16 + lane);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (u0 + u < n) Payload<G>::add(acc, v[u]);
    }
  }

  float* row_out = out + r * (4 * kCh) + lane * kVals;
  auto partial = [&](int q) {
    return q == 0 ? row_out
                  : part + static_cast<long long>(ex + q - 1) * (4 * kCh) +
                        lane * kVals;
  };
  store_vals<kVals>(partial(j), acc);
  if (pieces == 1) return;
  __threadfence();
  __syncwarp(gmask);
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(cnt + r, 1) - (row_end - row_begin);
  ticket = __shfl_sync(gmask, ticket, 0, kLanes);
  if (ticket != pieces - 1) return;
  __threadfence();
  // the other pieces' partials, from L2 (written on other SMs), kP in flight
  constexpr int kP = 4;
  for (int q0 = 0; q0 < pieces; q0 += kP) {
    float4 v[kP][kVals / 4];
#pragma unroll
    for (int u = 0; u < kP; ++u) {
      const int q = q0 + u;
      if (q < pieces && q != j) {
#pragma unroll
        for (int i = 0; i < kVals / 4; ++i)
          v[u][i] = __ldcg(reinterpret_cast<const float4*>(partial(q)) + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kP; ++u) {
      const int q = q0 + u;
      if (q < pieces && q != j) {
#pragma unroll
        for (int i = 0; i < kVals / 4; ++i) {
          acc[4 * i] += v[u][i].x;
          acc[4 * i + 1] += v[u][i].y;
          acc[4 * i + 2] += v[u][i].z;
          acc[4 * i + 3] += v[u][i].w;
        }
      }
    }
  }
  store_vals<kVals>(row_out, acc);
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

// Rows mode: the int32 words of the scratch `scatter_rows_segmented` needs
// for `rows` table rows and `n_taps` taps.
extern "C" long long scatter_rows_scratch_words(long long rows, int n_taps) {
  return carve(nullptr, rows, n_taps).words;
}

// Rows mode. idx: (n_taps,) int32 global table rows; payload: (n_taps,
// 4*32), bf16 (payload_is_bf16=1) or f32, 16-byte aligned; out: (rows,
// 4*32) f32, every row written (not zeroed by the caller); scratch: int32,
// `scatter_rows_scratch_words` of them, 16-byte aligned, any contents; all
// on card `device`. Returns the first CUDA error of the four launches.
extern "C" int scatter_rows_segmented(int device, const int* idx,
                                      const void* payload,
                                      int payload_is_bf16, float* out,
                                      long long rows, int n_taps,
                                      int* scratch, void* stream) {
  if (rows <= 0 || n_taps < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowsScratch sc = carve(scratch, rows, n_taps);
  err = cudaMemsetAsync(sc.cnt, 0, sc.zero_words * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tap_blocks = static_cast<unsigned>(
      std::min<long long>((n_taps + kRowsThreads - 1) / kRowsThreads,
                          kRowsMaxBlocks));
  if (n_taps > 0) {
    rows_count_kernel<<<tap_blocks, kRowsThreads, 0, s>>>(idx, n_taps, rows,
                                                          sc.cnt, sc.rank);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  rows_scan_kernel<<<static_cast<unsigned>((rows + kScanTile - 1) /
                                           kScanTile),
                     kRowsThreads, 0, s>>>(sc.cnt, sc.ticket, sc.status,
                                           sc.off, sc.exoff, sc.erow, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_taps > 0) {
    rows_place_kernel<<<tap_blocks, kRowsThreads, 0, s>>>(
        idx, sc.rank, n_taps, sc.off, sc.perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  // owners: one a row, and at most n_taps / kSplit + 1 extra pieces
  const long long owners = rows + n_taps / kSplit + 1;
  if (payload_is_bf16) {
    constexpr int kLanes = Payload<__nv_bfloat16>::kLanes;
    rows_reduce_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>((owners * kLanes + kRowsThreads - 1) /
                                 kRowsThreads),
           kRowsThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(payload),
                                 sc.off, sc.exoff, sc.erow, sc.perm, sc.cnt,
                                 sc.part, out, rows);
  } else {
    constexpr int kLanes = Payload<float>::kLanes;
    rows_reduce_kernel<float>
        <<<static_cast<unsigned>((owners * kLanes + kRowsThreads - 1) /
                                 kRowsThreads),
           kRowsThreads, 0, s>>>(static_cast<const float*>(payload), sc.off,
                                 sc.exoff, sc.erow, sc.perm, sc.cnt, sc.part,
                                 out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
