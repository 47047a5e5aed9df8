// Exact min-cost assignment (H1): the Jonker-Volgenant shortest augmenting
// path solver of the Hungarian matcher, one thread-block cluster a problem.
//
// For each of N problems, cost (n, m) f32 with n <= m and a row count
// n_rows[b] <= n: the assignment of rows 0..n_rows[b]-1 to distinct columns
// of least total cost, as col4row (n,) int64 (rows at or past n_rows[b]
// get 0).
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
// sweep of the m columns and an argmin over all of them that the next step
// waits for; the steps cannot overlap. A solve must read only its n_rows
// cost rows from device memory, a few MB, so the time of a step, not the
// memory, sets its time. One block a problem read the column state (17 B a
// column) back from L2 at every step on one SM. The design:
// - a cluster of C blocks a problem (C from the wrapper's rule, 1 to 16);
//   block k owns the columns 1 + k*S .. (k+1)*S, S = ceil(m / C), and
//   holds their state (v, minv, p, way, used) in its shared memory where
//   it fits (kSmemLimit), else in a global scratch slice of its own; where
//   the problem's valid rows' slices of the cost fit in the shared memory
//   left, the block stages them there before the first step, else a
//   step's sweep reads its slice of one cost row from device memory
//   (loads issued kUnroll at a time a thread), a thread a column up to
//   1,024 threads;
// - the row duals u and the search's path are replicated in every block
//   and updated identically; each path entry records its column, the row
//   it held and its way when it joined (column 0: row i), so the dual
//   update of u needs no remote read, and each block applies `v - delta`
//   only to the path columns it owns; the unused columns' `minv - delta`
//   is taken lazily by the next sweep as it reads the column (the value
//   the plain version stores); the first step of a row resets minv, way
//   and used;
// - a step's argmin in argmin's order (a NaN first, then the least value,
//   then the lower index): each thread's first minimum over its columns,
//   then two `redux.sync` minima a warp over an order-preserving key and
//   the column, once over the threads and, after one __syncthreads, in
//   every warp over the warps' minima, so every thread holds the block's
//   candidate (value, column, and that column's p, used and way after the
//   step) with no second block barrier;
// - one exchange a step between the C blocks, no cluster-wide barrier and
//   no memory fence: lane k of warp 0 stores the candidate into block k's
//   slot with `st.async`, which completes 16 bytes of the transaction
//   count of block k's mbarrier; every thread waits on its own block's
//   mbarrier and reduces the C slots as a warp does, so every block holds
//   the same (delta, j1, fresh, done, next row, way). Slots and mbarriers
//   are double-buffered by the step's parity: a block sends for the step
//   after next only once every block has sent for the next one, which
//   each does only after its own wait on this one. A step whose argmin
//   lands on a column already used (every unused column at BIG) adds
//   nothing to the path, as the plain version's row mask counts each used
//   column's row once;
// - a column's way is final once it is used: the step after it wins, its
//   minv becomes `minv - delta` = 0 (or NaN), which BIG never undercuts.
//   So the augmenting walk (at most n + 1 columns) needs only the
//   replicated path: warp 0 of every block walks it from the free column
//   and writes the p of its own columns, with no exchange; each block
//   inverts its own columns into col4row, which block 0 zeroed before
//   the one `cluster.sync()`.
// Every loop bound and branch around a barrier or an exchange is the same
// in every thread of the cluster (it depends on n_rows[b] and the reduced
// candidate only).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e9f;       // the masking cost of ops/hungarian.py
constexpr int kMaxThreads = 1024;
constexpr int kMaxRows = 4096;     // u and the path in shared memory
constexpr int kMaxCluster = 16;    // above 8 a non-portable cluster size
constexpr int kUnroll = 8;         // cost loads in flight a thread
// dynamic shared memory a block may take on an H100 (227 KB), less the
// static arrays (about 1 KB) and a margin
constexpr int kSmemLimit = 232448 - 2048;

// One block's candidate for a step's argmin.
struct Candidate {
  float v;   // the masked minv
  int j;     // its column (INT_MAX: an empty slice)
  int pu;    // p[j] * 2 + used[j] after the step (-1: none)
  int way;   // way[j] after the step, final once j is used
};

// One block's slice of the column state, S columns from `base`.
struct Cols {
  float* v;
  float* minv;
  int* p;
  int* way;
  unsigned char* used;
};

__host__ __device__ inline long long round16(long long x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline long long slice_bytes(int s) {
  return round16(17LL * s);
}

// Shared memory before the column state: u (n), the path's columns, rows
// and ways (n + 1 each).
__host__ __device__ inline long long fixed_bytes(int n) {
  return round16(4LL * n + 12LL * (n + 1));
}

__device__ inline Cols carve(char* base, int s) {
  Cols c;
  c.v = reinterpret_cast<float*>(base);
  c.minv = reinterpret_cast<float*>(base + 4LL * s);
  c.p = reinterpret_cast<int*>(base + 8LL * s);
  c.way = reinterpret_cast<int*>(base + 12LL * s);
  c.used = reinterpret_cast<unsigned char*>(base + 16LL * s);
  return c;
}

// argmin's order as an unsigned key: a NaN first (0), then the numbers in
// increasing order, -0 as +0 (equal to it, so the index decides, as
// `argmin` and the plain version's comparisons do).
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0u;
  if (v == 0.f) v = 0.f;
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The warp's first minimum of the candidates in argmin's order (the least
// key, then the least column), in every lane: two `redux.sync` minima,
// then the winning lane's candidate.
__device__ __forceinline__ void warp_argmin(Candidate& c) {
  const unsigned k = order_key(c.v);
  const unsigned kmin = __reduce_min_sync(0xffffffffu, k);
  const unsigned jmin = __reduce_min_sync(
      0xffffffffu, k == kmin ? static_cast<unsigned>(c.j) : 0xffffffffu);
  const int src = __ffs(__ballot_sync(
      0xffffffffu, k == kmin && static_cast<unsigned>(c.j) == jmin)) - 1;
  c.v = __shfl_sync(0xffffffffu, c.v, src);
  c.j = static_cast<int>(jmin);
  c.pu = __shfl_sync(0xffffffffu, c.pu, src);
  c.way = __shfl_sync(0xffffffffu, c.way, src);
}

// Distributed shared memory: this block's shared address `addr` in block
// `rank` of the cluster; an asynchronous store of a candidate there that
// completes 16 bytes of the transaction count of the mbarrier `bar` there
// (no fence: the mbarrier's phase completion makes it visible); arming this
// block's mbarrier for a phase of `bytes`; and the wait for a phase.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void send(unsigned addr, const Candidate& c,
                                     unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(__float_as_uint(c.v)), "r"(c.j), "r"(c.pu),
         "r"(c.way), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The thread's columns lo + l, l = tid + t*nt below cnt, in increasing
// order, swept against the cost row `row` (row[l] = cost[i0][lo + l - 1];
// kStaged: in shared memory): the lazy `minv - delta` of the columns unused
// until now, cur, the minv/way/used update and the thread's first minimum
// of the masked values (a strictly smaller value, or a NaN after a number,
// replaces the one it holds). The first step of a row (kFirst: j0 = 0,
// nothing used) resets minv, way and used as it writes them.
template <bool kFirst, bool kStaged>
__device__ __forceinline__ void sweep(const Cols& mine, const float* row,
                                      int lo, int cnt, int j0, float ui0,
                                      float delta, float& best_v,
                                      int& best_j) {
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < cnt; base += nt * kUnroll) {
    float cv[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int l = base + t * nt;
      cv[t] = l < cnt ? (kStaged ? row[l] : __ldg(row + l)) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int l = base + t * nt;
      if (l >= cnt) break;
      const int j = lo + l;
      float masked;
      if (kFirst) {
        const float cur = (cv[t] - ui0) - mine.v[l];
        masked = cur < kBig ? cur : kBig;
        mine.way[l] = 0;
        mine.minv[l] = masked;
        mine.used[l] = 0;
      } else {
        const bool was_used = mine.used[l];
        float mv = mine.minv[l];
        if (!was_used) mv = mv - delta;
        const bool now_used = was_used || j == j0;
        const float cur = now_used ? kBig : (cv[t] - ui0) - mine.v[l];
        if (cur < mv) {
          mv = cur;
          mine.way[l] = j0;
        }
        mine.minv[l] = mv;
        if (j == j0) mine.used[l] = 1;
        masked = now_used ? kBig : mv;
      }
      if (best_j == INT_MAX || masked < best_v ||
          (masked != masked && best_v == best_v)) {
        best_v = masked;
        best_j = j;
      }
    }
  }
}

// probe slots: clock64 cycles of thread 0 of block 0 of problem 0
enum Probe {
  kSweep,     // the sweep of its columns
  kReduce,    // the block's argmin and the candidate's push
  kExchange,  // waiting for the cluster's candidates
  kDecide,    // their reduction and the dual update
  kWalk,      // the augmenting walk
  kSteps,     // Dijkstra steps
  kTotal,     // the whole kernel
  kProbes
};

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
hungarian_kernel(const float* __restrict__ cost,
                 const int* __restrict__ n_rows, long long* __restrict__ out,
                 int n, int m, int s, int stage_cap, char* scratch,
                 long long* probe) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Candidate red[kMaxThreads / 32];
  // slots[parity][k]: block k's candidate of the step of that parity
  __shared__ __align__(16) Candidate slots[2][kMaxCluster];
  __shared__ __align__(8) unsigned long long bars[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / nc;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float inf = __int_as_float(0x7f800000);
  const Candidate none{inf, INT_MAX, -1, 0};
  const bool probing = probe != nullptr && b == 0 && rank == 0 && tid == 0;
  long long clk = probing ? clock64() : 0, spent[kProbes] = {};
  const long long start = clk;
  auto tick = [&](int slot) {
    if (probing) {
      const long long now = clock64();
      spent[slot] += now - clk;
      clk = now;
    }
  };

  float* u = reinterpret_cast<float*>(smem);
  int* path_col = reinterpret_cast<int*>(u + n);
  int* path_row = path_col + n + 1;
  int* path_way = path_row + n + 1;
  const long long stride = slice_bytes(s);
  Cols mine;
  float* stage;
  if constexpr (kShared) {
    mine = carve(smem + fixed_bytes(n), s);
    stage = reinterpret_cast<float*>(smem + fixed_bytes(n) + stride);
  } else {
    mine = carve(scratch + static_cast<long long>(blockIdx.x) * stride, s);
    stage = reinterpret_cast<float*>(smem + fixed_bytes(n));
  }

  const float* c = cost + static_cast<long long>(b) * n * m;
  long long* col4row = out + static_cast<long long>(b) * n;
  const int rows = min(max(n_rows[b], 0), n);
  const int lo = 1 + rank * s;                 // this block's columns
  const int cnt = max(min(m + 1 - lo, s), 0);  // lo .. lo + cnt - 1
  // the valid rows' slice of the cost in shared memory, where it fits
  const bool staged = static_cast<long long>(rows) * cnt <= stage_cap;
  const unsigned bytes = nc * sizeof(Candidate);

  for (int l = tid; l < cnt; l += nt) {
    mine.v[l] = 0.f;
    mine.p[l] = -1;
  }
  for (int r = tid; r < n; r += nt) u[r] = 0.f;
  if (rank == 0)
    for (int r = tid; r < n; r += nt) col4row[r] = 0;
  if (staged) {
#pragma unroll 4
    for (int e = tid; e < rows * cnt; e += nt) {
      const int r = e / cnt;
      stage[e] = __ldg(c + static_cast<long long>(r) * m + lo - 1 + e -
                       r * cnt);
    }
  }
  if (tid == 0 && nc > 1) {
    for (int k = 0; k < 2; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bars[k])) : "memory");
      expect_bytes(smem_u32(&bars[k]), bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();

  int parity = 0;
  unsigned phases = 0;  // bit k: the parity of bars[k]'s next phase
  for (int i = 0; i < rows; ++i) {
    int j0 = 0, i0 = i, w0 = 0, len = 0;
    float delta = 0.f;
    bool first = true, fresh = true;
    Candidate win;
    while (true) {
      // j0 joins the path with the row it holds and its way, unless it
      // was used already
      if (fresh) {
        if (tid == 0) {
          path_col[len] = j0;
          path_row[len] = i0;
          path_way[len] = w0;
        }
        ++len;
      }
      const float ui0 = u[i0];
      float best_v = inf;
      int best_j = INT_MAX;
      if (staged) {
        const float* row = stage + i0 * cnt;
        if (first)
          sweep<true, true>(mine, row, lo, cnt, j0, ui0, delta, best_v,
                            best_j);
        else
          sweep<false, true>(mine, row, lo, cnt, j0, ui0, delta, best_v,
                             best_j);
      } else {
        const float* row = c + static_cast<long long>(i0) * m + lo - 1;
        if (first)
          sweep<true, false>(mine, row, lo, cnt, j0, ui0, delta, best_v,
                             best_j);
        else
          sweep<false, false>(mine, row, lo, cnt, j0, ui0, delta, best_v,
                              best_j);
      }
      tick(kSweep);
      // the block's first minimum, in every warp, with its p, used and way
      win = Candidate{best_v, best_j, -1, 0};
      warp_argmin(win);
      if (lane == 0) red[warp] = win;
      __syncthreads();
      win = lane < nw ? red[lane] : none;
      warp_argmin(win);
      if (win.j != INT_MAX) {
        win.pu = mine.p[win.j - lo] * 2 + mine.used[win.j - lo];
        win.way = mine.way[win.j - lo];
      }
      if (nc > 1) {
        // lane k of warp 0 sends the candidate to block k; then every
        // warp reduces the cluster's candidates alike
        if (warp == 0 && lane < nc)
          send(map_rank(smem_u32(&slots[parity][rank]), lane), win,
               map_rank(smem_u32(&bars[parity]), lane));
        tick(kReduce);
        wait_phase(smem_u32(&bars[parity]), (phases >> parity) & 1);
        phases ^= 1u << parity;
        if (tid == 0) expect_bytes(smem_u32(&bars[parity]), bytes);
        tick(kExchange);
        win = lane < nc ? slots[parity][lane] : none;
        warp_argmin(win);
      } else {
        tick(kReduce);
        tick(kExchange);
      }
      delta = win.v;
      const int p1 = win.pu >> 1;
      fresh = !(win.pu & 1);
      parity ^= 1;
      // dual update: the rows of used columns += delta, the v of this
      // block's used columns -= delta
      for (int t = tid; t < len; t += nt) {
        const int col = path_col[t], r = path_row[t];
        u[r] = u[r] + delta;
        if (col >= lo && col < lo + cnt)
          mine.v[col - lo] = mine.v[col - lo] - delta;
      }
      __syncthreads();
      tick(kDecide);
      ++spent[kSteps];
      j0 = win.j;
      i0 = p1;
      w0 = win.way;
      first = false;
      if (p1 == -1) break;
    }
    // augment: walk back along the ways from the free column j0, each
    // column taking the row of the path column it came from (column 0:
    // row i); every block walks the replicated path and writes its own
    // columns' p
    if (warp == 0) {
      int j = j0, w = w0;
      while (j != 0) {
        int t = 0;  // w's path entry (column 0: entry 0)
        for (int base = 0; w != 0 && base < len; base += 32) {
          const unsigned hit = __ballot_sync(
              0xffffffffu, base + lane < len && path_col[base + lane] == w);
          if (hit) {
            t = base + __ffs(hit) - 1;
            break;
          }
        }
        if (lane == 0 && j >= lo && j < lo + cnt)
          mine.p[j - lo] = path_row[t];
        j = w;
        w = path_way[t];
      }
    }
    __syncthreads();
    tick(kWalk);
  }

  // invert: col4row[r] = j - 1 for the column j that holds row r
  for (int l = tid; l < cnt; l += nt) {
    const int r = mine.p[l];
    if (r >= 0) col4row[r] = lo + l - 1;
  }
  if (probing) {
    spent[kTotal] = clock64() - start;
    for (int k = 0; k < kProbes; ++k) probe[k] += spent[k];
  }
}

struct Plan {
  int s;             // columns a block
  int threads;
  bool shared;       // the column state in shared memory
  int stage_cap;     // floats of cost a block may stage in shared memory
  long long smem;    // dynamic shared memory a block
  long long scratch; // bytes of global scratch
};

// The column state goes to shared memory where it fits; what is left, up
// to all n rows' slices, stages the cost (the kernel stages when its
// problem's valid rows fit, else it reads the cost from device memory).
Plan plan(long long nb, int n, int m, int clusters) {
  Plan q;
  q.s = (m + clusters - 1) / clusters;
  q.threads = q.s >= kMaxThreads ? kMaxThreads : ((q.s + 31) / 32) * 32;
  const long long fixed = fixed_bytes(n), state = slice_bytes(q.s);
  q.shared = fixed + state <= kSmemLimit;
  const long long base = fixed + (q.shared ? state : 0);
  long long stage = 4LL * n * q.s;
  if (stage > kSmemLimit - base) stage = (kSmemLimit - base) / 16 * 16;
  if (stage < 4LL * q.s) stage = 0;
  q.stage_cap = static_cast<int>(stage / 4);
  q.smem = base + stage;
  q.scratch = q.shared ? 0 : nb * clusters * state;
  return q;
}

bool valid(long long nb, int n, int m, int clusters) {
  return n >= 0 && n <= kMaxRows && m >= n && nb >= 0 && clusters >= 1 &&
         clusters <= kMaxCluster && nb * clusters <= INT_MAX;
}

// The kernel variant, its attributes set, and its launch configuration.
cudaError_t configure(const Plan& q, long long nb, int clusters,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, const void** fn) {
  *fn = q.shared ? reinterpret_cast<const void*>(&hungarian_kernel<true>)
                 : reinterpret_cast<const void*>(&hungarian_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(q.smem));
  if (err == cudaSuccess && clusters > 8)
    err = cudaFuncSetAttribute(
        *fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(nb * clusters));
  cfg->blockDim = dim3(q.threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(q.smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Bytes of global scratch `hungarian_solve` needs for nb problems of n
// rows and m columns on clusters of `clusters` blocks (0 when the column
// state fits in shared memory); -1 for arguments the kernel does not take.
extern "C" long long hungarian_scratch_bytes(long long nb, int n, int m,
                                             int clusters) {
  if (!valid(nb, n, m, clusters)) return -1;
  return plan(nb, n, m, clusters).scratch;
}

// Clusters of `clusters` blocks at this shape that the card can hold at
// once (cudaOccupancyMaxActiveClusters; 0: it cannot launch one), or minus
// a CUDA error code.
extern "C" int hungarian_max_active_clusters(int device, int n, int m,
                                             int clusters) {
  if (!valid(1, n, m, clusters))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const Plan q = plan(1, n, m, clusters);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn;
  err = configure(q, 1, clusters, nullptr, &cfg, &attr, &fn);
  int count = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return count;
}

// cost: (nb, n, m) f32, n <= m; n_rows: (nb,) int32; out: (nb, n) int64;
// scratch: `hungarian_scratch_bytes(nb, n, m, clusters)` bytes, 16-byte
// aligned, any contents; all contiguous on card `device`. n may be at most
// 4,096, clusters 1 to 16. probe: null, or kProbes (7) zeroed int64 on the
// card, to which thread 0 of block 0 of problem 0 adds the clock64 cycles
// it spent in each part of the steps (sweep, block argmin and push,
// waiting for the cluster, decision and dual update, walk), its step count
// and its whole time. Returns the launch's CUDA error code (a cluster the
// card cannot hold is refused here, never run).
extern "C" int hungarian_solve(int device, const float* cost,
                               const int* n_rows, long long* out,
                               long long nb, int n, int m, int clusters,
                               void* scratch, long long* probe,
                               void* stream) {
  if (!valid(nb, n, m, clusters))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan q = plan(nb, n, m, clusters);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn;
  err = configure(q, nb, clusters, static_cast<cudaStream_t>(stream), &cfg,
                  &attr, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  char* sc = static_cast<char*>(scratch);
  int s = q.s, stage_cap = q.stage_cap;
  void* args[] = {&cost, &n_rows, &out, &n, &m, &s, &stage_cap, &sc, &probe};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
