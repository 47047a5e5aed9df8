// Exact min-cost assignment (H1): the Jonker-Volgenant shortest augmenting
// path solver of the Hungarian matcher, one thread block a problem.
//
// For each of N problems, cost (n, m) f32 with n <= m and a row count
// n_rows[b] <= n: the assignment of rows 0..n_rows[b]-1 to distinct columns
// of least total cost, as col4row (n,) int64 (rows at or past n_rows[b] get
// 0).
//
// Replaces the XLA loops of boxer_tpu/nn/matcher.py:_hungarian_single (a
// `lax.fori_loop` over rows around two `lax.while_loop`s, vmapped over the
// problems; no `pallas_call`), step for step: column 0 is the virtual start
// column, u and v the duals, p (the row a column holds, -1 free), way,
// used and minv over m+1 columns, the Dijkstra search from row i while
// p[j0] != -1, the augmenting walk back along `way`, then the inversion to
// col4row. The plain version is
// boxer_tpu_torch/ops/hungarian.py:solve_assignment_plain, which runs the
// same float operations in the same order (`(cost - u[i0]) - v`,
// `minv - delta`, `u + delta`, `v - delta`; nothing to contract, no
// multiply), and takes the first minimum as `argmin` does, so the kernel's
// choices equal it bit for bit.
//
// What bounds it on an H100: latency. A problem is a chain of Dijkstra
// steps (about n_rows plus the steps of the augmenting paths), each one
// sweep of the m columns and a block-wide argmin that the next step waits
// for; the steps cannot overlap, and a step's sweep reads one cost row and
// the column state (21 B a column, mostly from L2). A solve must read only
// its n_rows cost rows from device memory, a few MB, so the chain's
// latency, not the memory, sets its time. The design:
// - one block a problem (1,024 threads at m >= 1,024), the column sweeps
//   strided over the block's threads;
// - the column state (v, minv, p, way, used: 17 B a column, over 1 MB a
//   problem at m = 62,500) lives in a global scratch the wrapper
//   allocates, where it stays resident in L2; u (n floats) and the search's
//   used columns, in order (the path, at most n + 1), in shared memory;
// - one sweep a step: the previous step's `minv - delta` of the columns
//   unused then is applied as the column is read (the same value the plain
//   version stores), then cur, better, the minv/way update and the masked
//   candidate, which a warp-shuffle and then a block reduction over
//   (value, index) turn into (delta, j1), the lower index winning a tie;
// - the dual update of the used columns runs over the path (at most n + 1
//   columns), not over all m, the rows of used columns being distinct: a
//   step whose argmin lands on a column already used (every unused column
//   at BIG, a used one at a lower index) adds nothing to the path, so each
//   used column's row is updated once, as the plain version's row mask
//   does;
// - the first step of a row resets minv, way and used as it reads them;
// - the augmenting walk (at most n + 1 columns) runs on one thread.
// Every loop bound and branch around a __syncthreads() is the same in every
// thread of the block (a problem with n_rows = 0 skips the row loop whole).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kBig = 1e9f;       // the masking cost of ops/hungarian.py
constexpr int kMaxThreads = 1024;
constexpr int kMaxRows = 4096;     // u and the path in shared memory

struct Scratch {
  float* v;
  float* minv;
  int* p;
  int* way;
  unsigned char* used;
  long long bytes;
};

// The scratch's layout, arrays of (N, m + 1) one after another; with a
// null base only the size is meaningful.
__host__ __device__ inline Scratch carve(void* base, long long nb, int m) {
  const long long w = static_cast<long long>(nb) * (m + 1);
  char* b = static_cast<char*>(base);
  Scratch s;
  s.v = reinterpret_cast<float*>(b);
  s.minv = reinterpret_cast<float*>(b + 4 * w);
  s.p = reinterpret_cast<int*>(b + 8 * w);
  s.way = reinterpret_cast<int*>(b + 12 * w);
  s.used = reinterpret_cast<unsigned char*>(b + 16 * w);
  s.bytes = 17 * w;
  return s;
}

// (av, aj) before (bv, bj) in `argmin`'s order: the smaller value, a NaN
// before any number, the lower index among equals.
__device__ __forceinline__ bool precedes(float av, int aj, float bv, int bj) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || aj < bj);
  return av < bv || (av == bv && aj < bj);
}

__device__ __forceinline__ void warp_argmin(float& v, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oj = __shfl_down_sync(0xffffffffu, j, off);
    if (precedes(ov, oj, v, j)) {
      v = ov;
      j = oj;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
hungarian_kernel(const float* __restrict__ cost,
                 const int* __restrict__ n_rows, long long* __restrict__ out,
                 int n, int m, Scratch sc) {
  extern __shared__ float smem[];
  float* u = smem;                                  // (n,) row duals
  int* path = reinterpret_cast<int*>(smem + n);     // (n + 1,) used columns
  __shared__ float red_v[kMaxThreads / 32];
  __shared__ int red_j[kMaxThreads / 32];
  __shared__ float s_delta;
  __shared__ int s_j1;
  __shared__ bool s_fresh;

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long w = static_cast<long long>(m) + 1;
  const float* c = cost + static_cast<long long>(b) * n * m;
  float* v = sc.v + b * w;
  float* minv = sc.minv + b * w;
  int* p = sc.p + b * w;
  int* way = sc.way + b * w;
  unsigned char* used = sc.used + b * w;
  long long* col4row = out + static_cast<long long>(b) * n;
  const int rows = min(max(n_rows[b], 0), n);

  for (int j = tid; j <= m; j += nt) {
    v[j] = 0.f;
    p[j] = -1;
  }
  for (int r = tid; r < n; r += nt) u[r] = 0.f;
  __syncthreads();

  for (int i = 0; i < rows; ++i) {
    if (tid == 0) p[0] = i;
    int j0 = 0, len = 0;
    float delta = 0.f;
    bool first = true, fresh = true;
    while (true) {
      // used[j0] = true, j0 joining the path unless it was used already;
      // i0 = p[j0] (p[0] = i is read by thread 0 alone before the next
      // barrier, so the first step takes i itself)
      if (fresh) {
        if (tid == 0) path[len] = j0;
        ++len;
      }
      const int i0 = first ? i : p[j0];
      const float ui0 = u[i0];
      const float* crow = c + static_cast<long long>(i0) * m;
      float best_v = __int_as_float(0x7f800000);  // +inf
      int best_j = INT_MAX;
      for (int j = tid + 1; j <= m; j += nt) {
        const bool was_used = !first && used[j];
        float mv = first ? kBig : minv[j];
        if (!first && !was_used) mv = mv - delta;
        const bool now_used = was_used || j == j0;
        const float cur = now_used ? kBig : (crow[j - 1] - ui0) - v[j];
        if (cur < mv) {
          mv = cur;
          way[j] = j0;
        } else if (first) {
          way[j] = 0;
        }
        minv[j] = mv;
        if (first || j == j0) used[j] = now_used;
        const float masked = now_used ? kBig : mv;
        if (precedes(masked, j, best_v, best_j)) {
          best_v = masked;
          best_j = j;
        }
      }
      warp_argmin(best_v, best_j);
      if (lane == 0) {
        red_v[warp] = best_v;
        red_j[warp] = best_j;
      }
      __syncthreads();
      if (warp == 0) {
        const int nw = nt >> 5;
        best_v = lane < nw ? red_v[lane] : __int_as_float(0x7f800000);
        best_j = lane < nw ? red_j[lane] : INT_MAX;
        warp_argmin(best_v, best_j);
        if (lane == 0) {
          s_delta = best_v;
          s_j1 = best_j;
          s_fresh = !used[best_j];
        }
      }
      __syncthreads();
      delta = s_delta;
      const int j1 = s_j1;
      fresh = s_fresh;
      // dual update: the rows of used columns += delta, their v -= delta
      // (column 0 holds row i); the unused columns' minv -= delta is taken
      // by the next sweep
      for (int t = tid; t < len; t += nt) {
        const int col = path[t];
        const int r = col == 0 ? i : p[col];
        u[r] = u[r] + delta;
        v[col] = v[col] - delta;
      }
      const bool done = p[j1] == -1;
      __syncthreads();
      j0 = j1;
      first = false;
      if (done) break;
    }
    // augment: walk back along `way`, shifting assignments
    if (tid == 0) {
      int j = j0;
      while (j != 0) {
        const int jp = way[j];
        p[j] = p[jp];
        j = jp;
      }
    }
    __syncthreads();
  }

  // invert: col4row[r] = j - 1 for the column j that holds row r
  for (int r = tid; r < n; r += nt) col4row[r] = 0;
  __syncthreads();
  for (int j = tid + 1; j <= m; j += nt) {
    const int r = p[j];
    if (r >= 0) col4row[r] = j - 1;
  }
}

}  // namespace

// Bytes of scratch `hungarian_solve` needs for nb problems of m columns.
extern "C" long long hungarian_scratch_bytes(long long nb, int m) {
  return carve(nullptr, nb, m).bytes;
}

// cost: (nb, n, m) f32, n <= m; n_rows: (nb,) int32; out: (nb, n) int64;
// scratch: `hungarian_scratch_bytes(nb, m)` bytes, 4-byte aligned, any
// contents; all contiguous on card `device`. n may be at most 4,096.
// Returns cudaGetLastError() after the launch.
extern "C" int hungarian_solve(int device, const float* cost,
                               const int* n_rows, long long* out,
                               long long nb, int n, int m, void* scratch,
                               void* stream) {
  if (n < 0 || n > kMaxRows || m < n || nb < 0 || nb > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int threads = m >= kMaxThreads ? kMaxThreads : ((m + 31) / 32) * 32;
  const size_t smem = (2 * static_cast<size_t>(n) + 1) * sizeof(float);
  hungarian_kernel<<<static_cast<unsigned>(nb), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      cost, n_rows, out, n, m, carve(scratch, nb, m));
  return static_cast<int>(cudaGetLastError());
}
