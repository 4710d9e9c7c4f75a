// Moving least squares: recursive (exponentially forgetting) and rolling
// window fits of every row of every group, scan and solve (CUDA C++, sm_90a).
//
// Replaces the XLA code of polars_ols_tpu/ops/recursive.py:_rls_chunk (a
// lax.associative_scan of discounted outer products, then a batched
// Cholesky), ops/rolling.py:_windowed_solve_chunks (a cumsum of entering
// minus leaving outer products, then a batched Cholesky) and the lane
// solvers of ops/moving.py (solve_recursive_lanes, solve_rolling_lanes); no
// Pallas kernel. torch has no associative scan, and the same recurrences as
// eager tensor ops cost a Python loop over rows with dozens of launches each.
//
// Per group g and row t, in the group's row order, over Z = [y | x] and the
// valid rows v:
//   recursive: A_t = lam_t A_{t-1} + v_t x_t x_t', b_t likewise with x_t y_t,
//              disc_t = lam_t disc_{t-1}; lam_t = ff on valid rows, else 1;
//              solve (A_t + disc_t reg0 I) beta_t = b_t + disc_t reg0 mean0;
//   rolling:   A_t = A_{t-1} + v_t x_t x_t' - x_s x_s' with s = leaving[t]
//              (where >= 0), b_t likewise; solve (A_t + reg0 I) beta_t = b_t.
// A row solves where refresh[t] is set; other rows carry the last solved
// beta (the prior mean, or NaN for rolling, before the first). The output is
// beta_t [G, R, K] or the prediction x_t . beta_t [G, R].
//
// Design. One thread owns one (group, chunk of L rows) and keeps the packed
// lower triangle of A, b and the Cholesky factor in registers (K <= 8: the
// loops unroll over a compile-time K) or in its local memory (K <= 16,
// K <= 32). Neighbouring threads' rows lie L rows apart, so a thread that
// loaded its own row would make its warp touch 32 lines with every load:
// instead the warp stages the next T rows of each of its 32 chunks through
// shared memory with contiguous loads (stage), every lane works on its own
// rows there, and the warp writes the T rows of output back the same way
// (unstage). Four kernels on one stream:
//   summarize: each chunk's state from a zero start (the recurrence is
//              linear, so that is its contribution to any later state) and
//              its total discount;
//   prefix:    per group and state entry, a pass over the chunk summaries
//              in chunk order that gives each chunk its exact start state
//              (a long group's chunks in segments: composed, scanned over
//              the segments, expanded);
//   walk:      every chunk walks its rows from its start state, solves at
//              refresh rows by Cholesky and writes the output; it leaves its
//              last beta for the chunks after it;
//   fill:      the first rows of a chunk that only carry take the last beta
//              of the nearest earlier chunk that solved any.
// All sums run in row order within a chunk and in chunk order across chunks:
// no atomics touch a result, so two launches give the same bits. A row whose
// Cholesky meets a pivot that is not positive and finite is flagged (and
// counted, the one atomic) and gets NaN; moments_at recomputes the systems of
// listed rows for the caller's eigh fallback.
//
// What bounds it: bytes (Z and the masks read once, the output written once)
// at K = 5; the summary pass and the walk each read Z, and a rolling row's
// leaving row is a second, scattered read. The chain of a row (K square
// roots and divisions, ~K^3/3 dependent multiply-adds) times L rows is the
// latency floor of a launch.

#include <cmath>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 32;
// doubles of Z a lane's share of a tile holds at most (rolling: as many
// again of its leaving rows). On the H100 at K = 5, shares of 24 / 2 x 20
// doubles (4 / 3 rows) ran faster than larger ones, which cost resident
// warps.
constexpr int kTileDoubles = 24;
constexpr int kTileDoublesRolling = 20;

struct Mean {
  double m[kMaxK];
};

struct Problem {
  const double* Z;         // [G, R, 1 + K]
  const uint8_t* v;        // [G, R]
  const int64_t* rows;     // [G]
  const uint8_t* refresh;  // [G, R]
  const int32_t* leaving;  // [G, R], rolling only
  int64_t G, R, L, NC;
  int K;
  double ff, reg0;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// packed lower triangle: (i, j <= i) at i (i + 1) / 2 + j
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int KB>
struct State {
  double A[KB * (KB + 1) / 2];
  double b[KB];
  double disc;
};

// K of this launch: the template's own where the loops unroll over it
template <int KB>
__device__ __forceinline__ int width(int k) {
  return KB <= 8 ? KB : k;
}

template <int KB>
__device__ __forceinline__ void clear(State<KB>& s, int k) {
#pragma unroll
  for (int e = 0; e < k * (k + 1) / 2; ++e) s.A[e] = 0.0;
#pragma unroll
  for (int i = 0; i < k; ++i) s.b[i] = 0.0;
  s.disc = 1.0;
}

// state entries in the order of the summary and seed buffers: A, b, disc
template <int KB>
__device__ __forceinline__ void store(const State<KB>& s, int k, double* __restrict__ dst) {
  const int kt = k * (k + 1) / 2;
#pragma unroll
  for (int e = 0; e < kt; ++e) dst[e] = s.A[e];
#pragma unroll
  for (int i = 0; i < k; ++i) dst[kt + i] = s.b[i];
  dst[kt + k] = s.disc;
}

template <int KB>
__device__ __forceinline__ void load(State<KB>& s, int k, const double* __restrict__ src) {
  const int kt = k * (k + 1) / 2;
#pragma unroll
  for (int e = 0; e < kt; ++e) s.A[e] = src[e];
#pragma unroll
  for (int i = 0; i < k; ++i) s.b[i] = src[kt + i];
  s.disc = src[kt + k];
}

template <int KB>
__device__ __forceinline__ void load_row(double (&z)[KB + 1], const double* __restrict__ row, int k) {
#pragma unroll
  for (int i = 0; i <= k; ++i) z[i] = row[i];
}

// A += sign x x', b += sign x y for the row z = [y, x]
template <int KB>
__device__ __forceinline__ void add_row(State<KB>& s, const double (&z)[KB + 1], int k, double sign) {
#pragma unroll
  for (int i = 0; i < k; ++i) {
    const double xi = sign * z[1 + i];
#pragma unroll
    for (int j = 0; j <= i; ++j) s.A[tri(i, j)] = fma(xi, z[1 + j], s.A[tri(i, j)]);
    s.b[i] = fma(xi, z[0], s.b[i]);
  }
}

// the state after a row: z its values, gone those of the row that leaves
// the window with it (null where none does)
template <int KB, bool kRolling>
__device__ __forceinline__ void advance(State<KB>& s, double ff, const double (&z)[KB + 1],
                                        bool valid, const double* gone, int k) {
  if (valid) {
    if (!kRolling && ff != 1.0) {
#pragma unroll
      for (int e = 0; e < k * (k + 1) / 2; ++e) s.A[e] *= ff;
#pragma unroll
      for (int i = 0; i < k; ++i) s.b[i] *= ff;
      s.disc *= ff;
    }
    add_row<KB>(s, z, k, 1.0);
  }
  if (kRolling && gone != nullptr) {
    double zs[KB + 1];
    load_row<KB>(zs, gone, k);
    add_row<KB>(s, zs, k, -1.0);
  }
}

// Cholesky solve of (A + reg I) beta = b + reg mean; false where a pivot is
// not positive and finite (beta is then meaningless)
template <int KB>
__device__ __forceinline__ bool chol_solve(const State<KB>& s, double reg, const Mean& mean, int k,
                                           double (&beta)[KB]) {
  double Lw[KB * (KB + 1) / 2];  // strict lower triangle of the factor
  double inv[KB];                // 1 / its diagonal
  bool ok = true;
#pragma unroll
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      double acc = s.A[tri(i, j)];
      if (i == j) acc += reg;
#pragma unroll
      for (int q = 0; q < j; ++q) acc = fma(-Lw[tri(i, q)], Lw[tri(j, q)], acc);
      if (i == j) {
        ok = ok && acc > 0.0 && acc < INFINITY;
        inv[i] = rsqrt(acc);
      } else {
        Lw[tri(i, j)] = acc * inv[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < k; ++i) {  // L z = rhs, z kept in beta
    double acc = fma(reg, mean.m[i], s.b[i]);
#pragma unroll
    for (int q = 0; q < i; ++q) acc = fma(-Lw[tri(i, q)], beta[q], acc);
    beta[i] = acc * inv[i];
  }
#pragma unroll
  for (int i = k - 1; i >= 0; --i) {  // L' beta = z, in place
    double acc = beta[i];
#pragma unroll
    for (int q = i + 1; q < k; ++q) acc = fma(-Lw[tri(q, i)], beta[q], acc);
    beta[i] = acc * inv[i];
  }
  return ok;
}

// one row's output into dst: beta (k doubles) or the prediction x . beta
template <int KB>
__device__ __forceinline__ void emit(double* __restrict__ dst, bool coefs, const double* __restrict__ row,
                                     const double (&beta)[KB], int k) {
  if (coefs) {
#pragma unroll
    for (int i = 0; i < k; ++i) dst[i] = beta[i];
  } else {
    double acc = row[1] * beta[0];
#pragma unroll
    for (int i = 1; i < k; ++i) acc += row[1 + i] * beta[i];
    dst[0] = acc;
  }
}

// Rows of a chunk a tile holds: as many as the doubles a lane may hold allow
template <int KB, bool kRolling>
constexpr int tile_rows() {
  const int t = (kRolling ? kTileDoublesRolling : kTileDoubles) / (KB + 1);
  return t < 1 ? 1 : t;
}

// A warp's tile in shared memory: T rows of each of its 32 chunks. Lane j's
// rows start at z + j zs, its leaving rows at gone + j zs, its output at
// out + j os; the strides zs and os are odd, so the lanes' accesses at one
// offset fall into different banks.
struct TileShape {
  int zs;     // doubles between two lanes' rows
  int os;     // doubles between two lanes' outputs (0: the pass writes none)
  int bytes;  // of one warp's tile
};

// The chunk of thread w: its group's first row (grow = g R), its own first
// row (row0) and the rows it walks (len; 0 past the group's rows and past
// the last chunk).
struct Chunk {
  int64_t grow, row0;
  int len;
};

__device__ __forceinline__ Chunk chunk_of(const Problem& p, int64_t w) {
  Chunk ch{0, 0, 0};
  if (w < p.G * p.NC) {
    const int64_t g = w / p.NC, t0 = (w % p.NC) * p.L, n = p.rows[g];
    ch.grow = g * p.R;
    ch.row0 = ch.grow + t0;
    if (t0 < n) ch.len = static_cast<int>(min64(p.L, n - t0));
  }
  return ch;
}

template <int KB, bool kRolling>
struct Tile {
  static constexpr int T = tile_rows<KB, kRolling>();
  double* z;
  double* gone;
  double* out;
  int64_t* row0;     // [32] the lanes' chunks
  int64_t* grow;
  int* len;
  int* from;         // [32] the first row of the tile each lane has output for
  int32_t* leaving;  // [32, T]
  uint8_t* v;
  uint8_t* refresh;

  // every lane of the warp constructs it, with its own chunk
  __device__ Tile(const TileShape& sh, double* smem, const Chunk& ch) {
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    z = reinterpret_cast<double*>(reinterpret_cast<char*>(smem) + static_cast<size_t>(warp) * sh.bytes);
    gone = z + kWarp * sh.zs;
    out = gone + (kRolling ? kWarp * sh.zs : 0);
    row0 = reinterpret_cast<int64_t*>(out + kWarp * sh.os);
    grow = row0 + kWarp;
    len = reinterpret_cast<int*>(grow + kWarp);
    from = len + kWarp;
    leaving = from + kWarp;
    v = reinterpret_cast<uint8_t*>(leaving + (kRolling ? kWarp * T : 0));
    refresh = v + kWarp * T;
    row0[lane] = ch.row0;
    grow[lane] = ch.grow;
    len[lane] = ch.len;
    __syncwarp();
  }
};

// The warp copies rows [r0, r0 + T) of every lane's chunk into the tile.
// Lane j's rows are contiguous in Z, so the copy runs over the flat index
// (j, element) with neighbouring lanes on neighbouring doubles, as
// asynchronous 8-byte copies that are all in flight before the one wait;
// likewise the masks and the leaving-row index (through registers, loads
// before stores) and, found through that index, the leaving rows.
template <int KB, bool kRolling>
__device__ __forceinline__ void stage(const Tile<KB, kRolling>& tl, const TileShape& sh,
                                      const Problem& p, int lane, int c1, int r0, bool with_refresh) {
  constexpr int T = Tile<KB, kRolling>::T;
  const int seg = T * c1;
  for (int i = lane; i < kWarp * seg; i += kWarp) {
    const int j = i / seg, e = i - j * seg;
    const int left = tl.len[j] - r0;
    if (e < (left < T ? left : T) * c1) {
      __pipeline_memcpy_async(tl.z + j * sh.zs + e, p.Z + (tl.row0[j] + r0) * c1 + e, 8);
    }
  }
  uint8_t mv[T], mr[T];
  int32_t ml[T];
#pragma unroll
  for (int q = 0; q < T; ++q) {  // flat over (j, row): i = j T + row
    const int i = lane + kWarp * q;
    const int j = i / T, r = r0 + i - j * T;
    const bool on = r < tl.len[j];
    const int64_t at = tl.row0[j] + r;
    mv[q] = on ? p.v[at] : 0;
    mr[q] = on && with_refresh ? p.refresh[at] : 0;
    ml[q] = on && kRolling ? p.leaving[at] : -1;
  }
#pragma unroll
  for (int q = 0; q < T; ++q) {
    const int i = lane + kWarp * q;
    tl.v[i] = mv[q];
    tl.refresh[i] = mr[q];
    if (kRolling) tl.leaving[i] = ml[q];
  }
  if (kRolling) {
    __syncwarp();
    for (int i = lane; i < kWarp * seg; i += kWarp) {
      const int j = i / seg, e = i - j * seg;
      const int r = e / c1;
      const int32_t gone = tl.leaving[j * T + r];
      if (gone >= 0) {
        __pipeline_memcpy_async(tl.gone + j * sh.zs + e, p.Z + (tl.grow[j] + gone) * c1 + (e - r * c1), 8);
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

// The warp writes every lane's output of rows [r0 + from, r0 + T) of its
// chunk from the tile to out (ow doubles a row), over the flat index again.
template <int KB, bool kRolling>
__device__ __forceinline__ void unstage(const Tile<KB, kRolling>& tl, const TileShape& sh,
                                        double* __restrict__ out, int ow, int lane, int r0, int from) {
  constexpr int T = Tile<KB, kRolling>::T;
  tl.from[lane] = from;
  __syncwarp();
  const int seg = T * ow;
  for (int i = lane; i < kWarp * seg; i += kWarp) {
    const int j = i / seg, e = i - j * seg;
    const int left = tl.len[j] - r0;
    if (e >= tl.from[j] * ow && e < (left < T ? left : T) * ow) {
      out[(tl.row0[j] + r0) * ow + e] = tl.out[j * sh.os + e];
    }
  }
}

// lane's staged row r: its values into z, those of its leaving row or null
// into gone; returns the row in the tile
template <int KB, bool kRolling>
__device__ __forceinline__ const double* staged_row(const Tile<KB, kRolling>& tl, const TileShape& sh,
                                                    int lane, int r, int k, double (&z)[KB + 1],
                                                    const double*& gone) {
  const int at = lane * sh.zs + r * (k + 1);
  load_row<KB>(z, tl.z + at, k);
  gone = kRolling && tl.leaving[lane * tl.T + r] >= 0 ? tl.gone + at : nullptr;
  return tl.z + at;
}

template <int KB, bool kRolling>
__global__ void __launch_bounds__(kThreads)
summarize(Problem p, TileShape sh, double* __restrict__ summ) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Chunk ch = chunk_of(p, w);
  const Tile<KB, kRolling> tl(sh, smem, ch);
  constexpr int T = Tile<KB, kRolling>::T;
  const int k = width<KB>(p.K);
  State<KB> s;
  clear<KB>(s, k);
  const int longest = __reduce_max_sync(kFull, ch.len);
  for (int r0 = 0; r0 < longest; r0 += T) {
    stage<KB, kRolling>(tl, sh, p, lane, k + 1, r0, false);
    for (int r = 0; r < T && r0 + r < ch.len; ++r) {
      double z[KB + 1];
      const double* gone;
      staged_row<KB, kRolling>(tl, sh, lane, r, k, z, gone);
      advance<KB, kRolling>(s, p.ff, z, tl.v[lane * T + r] != 0, gone, k);
    }
    __syncwarp();  // the next tile overwrites this one
  }
  if (w < p.G * p.NC) store<KB>(s, k, summ + w * (k * (k + 1) / 2 + k + 1));
}

// The prefix over a group's chunk summaries, per state entry e:
// state[c + 1] = lam_c state[c] + summ[c], lam_c the chunk's total discount
// (the last entry, which itself runs as a product from 1). One thread runs
// segment j (SEG chunks) of group g for entry e, from start[g, j] (the zero
// state where null), writes the state before each chunk into seed (where not
// null) and the state after its last chunk into total (where not null). A
// group of few chunks is one segment; a long one is composed per segment
// (total), scanned over the segments' totals (a second call of this kernel
// on them), and expanded per segment from those starts.
__global__ void __launch_bounds__(kThreads)
prefix(const double* __restrict__ summ, const double* __restrict__ start,
       double* __restrict__ seed, double* __restrict__ total, int64_t G, int64_t NC, int E,
       int64_t S, int64_t SEG) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= G * S * E) return;
  const int64_t gj = idx / E, g = gj / S, j = gj % S;
  const int e = static_cast<int>(idx % E);
  const bool is_disc = e == E - 1;
  double run = start != nullptr ? start[gj * E + e] : (is_disc ? 1.0 : 0.0);
  const int64_t c1 = min64((j + 1) * SEG, NC);
#pragma unroll 4
  for (int64_t c = j * SEG; c < c1; ++c) {
    const int64_t base = (g * NC + c) * E;
    if (seed != nullptr) seed[base + e] = run;
    const double lam = summ[base + E - 1];
    run = is_disc ? run * lam : fma(lam, run, summ[base + e]);
  }
  if (total != nullptr) total[gj * E + e] = run;
}

template <int KB, bool kRolling>
__global__ void __launch_bounds__(kThreads)
walk(Problem p, Mean mean, TileShape sh, const double* __restrict__ seed, double* __restrict__ tail,
     uint8_t* __restrict__ has, double* __restrict__ coef, double* __restrict__ pred,
     uint8_t* __restrict__ flag, int* __restrict__ nflag) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Chunk ch = chunk_of(p, w);
  const Tile<KB, kRolling> tl(sh, smem, ch);
  constexpr int T = Tile<KB, kRolling>::T;
  const int k = width<KB>(p.K);
  State<KB> s;
  if (seed != nullptr && ch.len > 0) {
    load<KB>(s, k, seed + w * (k * (k + 1) / 2 + k + 1));
  } else {
    clear<KB>(s, k);
  }
  const bool coefs = coef != nullptr;
  const int ow = coefs ? k : 1;
  double beta[KB];
  bool have = false;
  const int longest = __reduce_max_sync(kFull, ch.len);
  for (int r0 = 0; r0 < longest; r0 += T) {
    stage<KB, kRolling>(tl, sh, p, lane, k + 1, r0, true);
    int from = T;  // the first row of this tile that has coefficients
    for (int r = 0; r < T && r0 + r < ch.len; ++r) {
      double z[KB + 1];
      const double* gone;
      const double* row = staged_row<KB, kRolling>(tl, sh, lane, r, k, z, gone);
      advance<KB, kRolling>(s, p.ff, z, tl.v[lane * T + r] != 0, gone, k);
      if (tl.refresh[lane * T + r]) {
        const double reg = kRolling ? p.reg0 : s.disc * p.reg0;
        if (!chol_solve<KB>(s, reg, mean, k, beta)) {
          flag[ch.row0 + r0 + r] = 1;
          atomicAdd(nflag, 1);
#pragma unroll
          for (int i = 0; i < k; ++i) beta[i] = NAN;
        }
        have = true;
      }
      if (have) {
        if (from == T) from = r;
        emit<KB>(tl.out + lane * sh.os + r * ow, coefs, row, beta, k);
      }
    }
    unstage<KB, kRolling>(tl, sh, coefs ? coef : pred, ow, lane, r0, from);
  }
  if (w >= p.G * p.NC) return;
  if (have) {
#pragma unroll
    for (int i = 0; i < k; ++i) tail[w * k + i] = beta[i];
  }
  has[w] = have ? 1 : 0;
}

template <int KB>
__global__ void __launch_bounds__(kThreads)
fill(Problem p, Mean mean, bool rolling, const double* __restrict__ tail,
     const uint8_t* __restrict__ has, double* __restrict__ coef, double* __restrict__ pred) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= p.G * p.NC) return;
  const int64_t g = w / p.NC, c = w % p.NC;
  const int k = width<KB>(p.K);
  const int64_t n = p.rows[g];
  const int64_t t0 = c * p.L;
  if (t0 >= n || p.refresh[g * p.R + t0]) return;
  const int64_t t1 = min64(t0 + p.L, n);
  double beta[KB];
#pragma unroll
  for (int i = 0; i < k; ++i) beta[i] = rolling ? NAN : mean.m[i];
  for (int64_t cc = c - 1; cc >= 0; --cc) {
    if (has[g * p.NC + cc]) {
#pragma unroll
      for (int i = 0; i < k; ++i) beta[i] = tail[(g * p.NC + cc) * k + i];
      break;
    }
  }
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t at = g * p.R + t;
    if (p.refresh[at]) break;
    double* dst = coef != nullptr ? coef + at * k : pred + at;
    emit<KB>(dst, coef != nullptr, p.Z + at * (k + 1), beta, k);
  }
}

// the system (A + reg I, b + reg mean) of each listed row (fg[f], ft[f])
template <int KB, bool kRolling>
__global__ void __launch_bounds__(kThreads)
moments_at(Problem p, Mean mean, const double* __restrict__ seed, const int64_t* __restrict__ fg,
           const int64_t* __restrict__ ft, int64_t F, double* __restrict__ A_out,
           double* __restrict__ rhs_out) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int64_t g = fg[f], t_at = ft[f];
  const int64_t c = t_at / p.L;
  const int k = width<KB>(p.K);
  State<KB> s;
  if (seed != nullptr) {
    load<KB>(s, k, seed + (g * p.NC + c) * (k * (k + 1) / 2 + k + 1));
  } else {
    clear<KB>(s, k);
  }
  for (int64_t t = c * p.L; t <= t_at; ++t) {
    const int64_t at = g * p.R + t;
    double z[KB + 1];
    const bool valid = p.v[at] != 0;
    if (valid) load_row<KB>(z, p.Z + at * (k + 1), k);
    const double* gone = nullptr;
    if (kRolling && p.leaving[at] >= 0) gone = p.Z + (g * p.R + p.leaving[at]) * (k + 1);
    advance<KB, kRolling>(s, p.ff, z, valid, gone, k);
  }
  const double reg = kRolling ? p.reg0 : s.disc * p.reg0;
#pragma unroll
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const double a = i >= j ? s.A[tri(i, j)] : s.A[tri(j, i)];
      A_out[(f * k + i) * k + j] = i == j ? a + reg : a;
    }
    rhs_out[f * k + i] = fma(reg, mean.m[i], s.b[i]);
  }
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// seed = the state before every chunk, from the chunks' summaries
int run_prefix(const double* summ, double* seed, double* comp, double* segseed, int64_t G,
               int64_t NC, int E, int64_t S, cudaStream_t st) {
  const int64_t SEG = (NC + S - 1) / S;
  const double* no_start = nullptr;
  double* no_out = nullptr;
  if (S == 1) {
    prefix<<<blocks_for(G * E), kThreads, 0, st>>>(summ, no_start, seed, no_out, G, NC, E, S, SEG);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks = blocks_for(G * S * E);
  prefix<<<blocks, kThreads, 0, st>>>(summ, no_start, no_out, comp, G, NC, E, S, SEG);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the segments' totals are summaries of their own: one segment of S of them
  prefix<<<blocks_for(G * E), kThreads, 0, st>>>(comp, no_start, segseed, no_out, G, S, E, 1, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prefix<<<blocks, kThreads, 0, st>>>(summ, segseed, seed, no_out, G, NC, E, S, SEG);
  return static_cast<int>(cudaGetLastError());
}

// The tile of a pass over K features that writes ow doubles a row (0: none)
template <int KB, bool kRolling>
TileShape tile_shape(int K, int ow) {
  constexpr int T = tile_rows<KB, kRolling>();
  TileShape sh;
  sh.zs = (T * (K + 1)) | 1;
  sh.os = ow > 0 ? (T * ow) | 1 : 0;
  const int doubles = kWarp * (sh.zs * (kRolling ? 2 : 1) + sh.os + 2);  // and row0, grow
  const int bytes = doubles * 8 + kWarp * (4 * (2 + (kRolling ? T : 0)) + 2 * T);
  sh.bytes = (bytes + 15) / 16 * 16;
  return sh;
}

// Launch a staged pass with its block's tiles as dynamic shared memory.
template <class Kernel, class... Args>
int launch_staged(Kernel kernel, unsigned blocks, const TileShape& sh, cudaStream_t st, Args... args) {
  const int smem = sh.bytes * (kThreads / kWarp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool kRolling>
int run_all(const Problem& p, const Mean& mean, int64_t S, double* summ, double* seed,
            double* comp, double* segseed, double* tail, uint8_t* has, double* coef,
            double* pred, uint8_t* flag, int* nflag, cudaStream_t st) {
  const unsigned blocks = blocks_for(p.G * p.NC);
  const int E = p.K * (p.K + 1) / 2 + p.K + 1;
  int rc = 0;
  if (p.NC > 1) {
    const TileShape sh = tile_shape<KB, kRolling>(p.K, 0);
    rc = launch_staged(summarize<KB, kRolling>, blocks, sh, st, p, sh, summ);
    if (rc != 0) return rc;
    rc = run_prefix(summ, seed, comp, segseed, p.G, p.NC, E, S, st);
    if (rc != 0) return rc;
  } else {
    seed = nullptr;
  }
  const TileShape sh = tile_shape<KB, kRolling>(p.K, coef != nullptr ? p.K : 1);
  rc = launch_staged(walk<KB, kRolling>, blocks, sh, st, p, mean, sh, static_cast<const double*>(seed),
                     tail, has, coef, pred, flag, nflag);
  if (rc != 0) return rc;
  fill<KB><<<blocks, kThreads, 0, st>>>(p, mean, kRolling, tail, has, coef, pred);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool kRolling>
int run_moments_at(const Problem& p, const Mean& mean, const double* seed, const int64_t* fg,
                   const int64_t* ft, int64_t F, double* A_out, double* rhs_out,
                   cudaStream_t st) {
  if (p.NC == 1) seed = nullptr;
  moments_at<KB, kRolling><<<blocks_for(F), kThreads, 0, st>>>(p, mean, seed, fg, ft, F, A_out, rhs_out);
  return static_cast<int>(cudaGetLastError());
}

bool valid_sizes(const Problem& p) {
  return p.G >= 0 && p.R >= 0 && p.L >= 1 && p.NC >= 1 && p.K >= 1 && p.K <= kMaxK &&
         p.NC * p.L >= p.R && p.G * p.NC < (int64_t{1} << 37);
}

Mean mean_from(const double* mean0) {
  Mean mean;
  for (int i = 0; i < kMaxK; ++i) mean.m[i] = mean0[i];
  return mean;
}

}  // namespace

// KB of a K: itself up to 8 (registers), then the buckets 16 and 32
#define POLS_MOVING_DISPATCH(K, ROLLING, CALL)             \
  switch ((K) <= 8 ? (K) : ((K) <= 16 ? 16 : 32)) {        \
    case 1: return (ROLLING) ? CALL(1, true) : CALL(1, false);    \
    case 2: return (ROLLING) ? CALL(2, true) : CALL(2, false);    \
    case 3: return (ROLLING) ? CALL(3, true) : CALL(3, false);    \
    case 4: return (ROLLING) ? CALL(4, true) : CALL(4, false);    \
    case 5: return (ROLLING) ? CALL(5, true) : CALL(5, false);    \
    case 6: return (ROLLING) ? CALL(6, true) : CALL(6, false);    \
    case 7: return (ROLLING) ? CALL(7, true) : CALL(7, false);    \
    case 8: return (ROLLING) ? CALL(8, true) : CALL(8, false);    \
    case 16: return (ROLLING) ? CALL(16, true) : CALL(16, false); \
    default: return (ROLLING) ? CALL(32, true) : CALL(32, false); \
  }

extern "C" {

// The moving fit of Z [G, R, 1 + K] (contiguous f64, target first) over the
// valid rows v [G, R] of groups of rows[g] rows each, in chunks of L rows
// (NC = ceil(R / L) chunks a group): beta into coef [G, R, K] or x . beta
// into pred [G, R] (the other null). rolling: leaving [G, R] int32 and
// reg0 = alpha; else reg0 = 1 / c, ff the forgetting factor and mean0 (32
// host doubles) the prior mean. summ and seed [G, NC, E], E = K (K + 1) / 2
// + K + 1, tail [G, NC, K] and has [G, NC] are scratch, and so are comp
// and segseed [G, S, E] where the prefix runs in S > 1 segments; flag
// [G, R] and nflag [1] arrive zeroed and mark and count the rows whose
// Cholesky failed. Launches on `stream` without synchronising; returns the CUDA
// error code of the first launch that failed (0 on success).
int pols_moving(const double* Z, const uint8_t* v, const int64_t* rows, const uint8_t* refresh,
                const int32_t* leaving, int64_t G, int64_t R, int K, int64_t L, int64_t NC,
                int rolling, double ff, double reg0, const double* mean0, int64_t S,
                double* summ, double* seed, double* comp, double* segseed, double* tail,
                uint8_t* has, double* coef, double* pred, uint8_t* flag, int* nflag,
                void* stream) {
  const Problem p{Z, v, rows, refresh, leaving, G, R, L, NC, K, ff, reg0};
  if (!valid_sizes(p) || (coef == nullptr) == (pred == nullptr) ||
      (rolling != 0) != (leaving != nullptr) || S < 1 || S > NC ||
      (S > 1 && (comp == nullptr || segseed == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0 || R == 0) return 0;
  const Mean mean = mean_from(mean0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POLS_RUN_ALL(KB, ROLL) \
  run_all<KB, ROLL>(p, mean, S, summ, seed, comp, segseed, tail, has, coef, pred, flag, nflag, st)
  POLS_MOVING_DISPATCH(K, rolling != 0, POLS_RUN_ALL)
#undef POLS_RUN_ALL
}

// The systems of the F listed rows (fg[f], ft[f]) of the same problem, from
// the seeds a pols_moving call with the same L left: A_out [F, K, K] with
// the regularisation on its diagonal, rhs_out [F, K].
int pols_moving_moments_at(const double* Z, const uint8_t* v, const int32_t* leaving, int64_t G,
                           int64_t R, int K, int64_t L, int64_t NC, int rolling, double ff,
                           double reg0, const double* mean0, const double* seed,
                           const int64_t* fg, const int64_t* ft, int64_t F, double* A_out,
                           double* rhs_out, void* stream) {
  const Problem p{Z, v, nullptr, nullptr, leaving, G, R, L, NC, K, ff, reg0};
  if (!valid_sizes(p) || F < 0 || (rolling != 0) != (leaving != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  const Mean mean = mean_from(mean0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POLS_RUN_AT(KB, ROLL) \
  run_moments_at<KB, ROLL>(p, mean, seed, fg, ft, F, A_out, rhs_out, st)
  POLS_MOVING_DISPATCH(K, rolling != 0, POLS_RUN_AT)
#undef POLS_RUN_AT
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
