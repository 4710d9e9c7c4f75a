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
// Design (the register form, K <= 8). A warp owns a range of one group's
// rows: the whole group where it has at most L rows (the planner's rows a
// range, ops/moving.py), else one of the group's ranges of L rows. It walks
// the range in stretches of 32 T rows; lane j owns rows [j T, (j + 1) T) of
// a stretch, so a stretch of Z is one contiguous span. Per stretch:
//   - lane 0 bulk-copies (cp.async.bulk, the TMA's 1-D form, completed on an
//     mbarrier) the stretch's rows of Z, v, refresh and leaving into one of
//     two shared-memory stages; the copy of stretch s + 2 is issued as soon
//     as stretch s is done, so one copy is always in flight behind the
//     arithmetic. Addresses and sizes are rounded out to 16-byte words, and
//     the data lands at the same offset from a boundary as in device memory;
//   - rolling: the stretch's leaving rows form one span of Z (leaving[t]
//     does not decrease where it is set), bulk-copied into a third buffer,
//     in pieces where the span is longer than a stretch;
//   - each lane forms the summary of its T rows from a zero start (the
//     recurrence is linear, so that is its contribution to every later
//     state) and its total discount; an inclusive Hillis-Steele scan over
//     the lanes by __shfl_up_sync composes (lam_a, S_a) o (lam_b, S_b) =
//     (lam_a lam_b, lam_b S_a + S_b) in 5 steps; the exclusive result
//     composed onto the carry (the state before the stretch, in shared
//     memory) is each lane's exact start state;
//   - every lane walks its rows again from that state, solves at refresh
//     rows by Cholesky and writes its rows' output into shared memory; the
//     last solved beta passes to the lanes after it by a shuffle (and from
//     stretch to stretch in shared memory), so a lane's leading rows that
//     only carry take it there; the warp stores the stretch's output with
//     contiguous stores; lane 31's end state becomes the carry.
// So a group that one warp walks reads Z once and needs no other kernel.
// A group longer than L is cut into ranges (the planner's table): a summary
// pass over those ranges only (the same stretches, the carry composed from
// the scan's inclusive totals), a segmented prefix over each group's range
// summaries, the walk from each range's seed, and a fill of the leading
// rows of a range that only carry a beta solved in an earlier range.
// All sums run in a fixed order: no atomics touch a result, so two launches
// give the same bits. A row whose Cholesky meets a pivot that is not
// positive and finite is flagged (and counted, the one atomic) and gets
// NaN; the walk then keeps the start state of that stretch, and moments_at
// recomputes the systems of listed rows from it for the caller's eigh
// fallback.
//
// What bounds it: bytes would (Z and the masks read once, the output
// written once), but the f64 work sits close: every row is advanced twice
// (the lanes' summary and the walk) and a refresh row runs a Cholesky with
// K double-precision reciprocal square roots. K <= 8 keeps the state, the
// factor and the row in registers (the loops unroll over a compile-time K).
//
// The shared form (K > 8). A lane's own K x K state does not fit its
// registers past K = 8 (as local memory it ran 160x off its bound at
// K = 16), so above 8 the register form's idea is lifted one level, lane
// to warp. A walker is a block of NW warps (up to 4, as many as the
// shared memory holds; one past K = 100) that walks its range in stretches
// of NW runs of 32 T rows; warp w owns run w of a stretch, which arrives
// in one bulk-copied stage (the register form's copies; the leaving rows
// of a rolling stretch gathered beside it). A warp keeps a state (A
// packed, b, the discount) in a ring of NW slots in shared memory and
// updates it a row at a time, each lane its own entries. Per stretch:
//   - each run but the last forms its summary from a zero start (the
//     discounted rank-1 sums, for rolling entering minus leaving, and the
//     total discount) in the slot after the carry's;
//   - the summaries are composed in warp order onto the carry, in place,
//     entry by entry (A = disc_s A + S, as compose_after), so that each
//     slot holds the start state of the next run;
//   - every warp walks its run from its start state and, at each refresh
//     row, solves its own LDL' of the augmented system [A + reg I, b + reg
//     mean] under __syncwarp only: up to K = 48 in registers (lane l holds
//     rows l and l + 32 of the factor, a column broadcast through a
//     shared-memory buffer; the right-hand side eliminated beside), above
//     in the warp's shared-memory buffer, each lane its entries of the
//     trailing update, lane 0 posting the next pivot's reciprocal; then the
//     back substitution beta_i = (y_i - sum_{q>i} F_qi beta_q) / d_i;
//   - the last run's end state is the new carry; a run's rows before its
//     first refresh row take the last beta of the nearest earlier run that
//     solved one, else the walker's carried beta.
// The same pivot test flags a row (d_j not positive and finite), and the
// same moments are solved, so the semantics do not change at K = 9 or 33.
// Each stretch's start state goes to sseed for moments_at. Past K = 100
// the ring and the warp buffers sit in a device-memory workspace and a
// stretch is one run, copied in pieces of fewer rows where its stage does
// not fit. The ranges, the summary pass, the prefix and the fill are the
// register form's; the grid is persistent (one walker a block, the blocks
// the card holds), so that the workspace is one slot a walker.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegisterMaxK = 8;  // the register form's K; the shared form above
constexpr int kMaxK = 8192;       // the shared form's K, while a row of Z fits a stage
constexpr int kMaxWarps = 4;  // warps a block, fewer where a warp's buffers are large
constexpr int kMaxShared = 227 * 1024;
constexpr int kMaxT = 16;

struct Problem {
  const double* Z;         // [G, R, 1 + K]
  const uint8_t* v;        // [G, R]
  const int64_t* rows;     // [G]
  const uint8_t* refresh;  // [G, R]
  const int32_t* leaving;  // [G, R], rolling only
  const int64_t* ranges;   // [M, 2]: (group, first row) of the ranges of groups longer than L
  int64_t G, R, L, M;
  int K, T;
  double ff, reg0;
};

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// A warp's shared memory: three mbarriers (two stages, the leaving span),
// the carry (state, beta, whether beta is known), two stages of a stretch's
// rows and masks, the leaving span and the stretch's output.
struct Layout {
  int carry, cbeta, misc, stage, z, m, lv, gone, out, total;
};

__host__ __device__ inline Layout layout_for(int K, int T, bool rolling, int ow) {
  const int C = K + 1, rows = kWarp * T, E = K * (K + 1) / 2 + K + 1;
  Layout l;
  l.z = round16(rows * C * 8) + 16;
  l.m = round16(rows) + 16;
  l.lv = rolling ? round16(rows * 4) + 16 : 0;
  l.carry = 32;
  l.cbeta = l.carry + round16(E * 8);
  l.misc = l.cbeta + round16(K * 8);
  l.stage = l.misc + 16;
  const int stage_bytes = l.z + 2 * l.m + l.lv;
  l.gone = l.stage + 2 * stage_bytes;
  l.out = l.gone + (rolling ? l.z : 0);
  l.total = (l.out + round16(rows * ow * 8) + 127) & ~127;
  return l;
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// packed lower triangle: (i, j <= i) at i (i + 1) / 2 + j
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int KB>
struct State {
  double A[KB * (KB + 1) / 2];
  double b[KB];
  double disc;
};

template <int KB>
__device__ __forceinline__ void clear(State<KB>& s, int k) {
#pragma unroll
  for (int e = 0; e < k * (k + 1) / 2; ++e) s.A[e] = 0.0;
#pragma unroll
  for (int i = 0; i < k; ++i) s.b[i] = 0.0;
  s.disc = 1.0;
}

// state entries in the order of the carry, summary and seed buffers: A, b, disc
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

// s = c o s: the state after c's rows and then s's, for s from a zero start
// (A = disc_s A_c + A_s, disc = disc_c disc_s)
template <int KB>
__device__ __forceinline__ void compose_after(State<KB>& s, const double* __restrict__ c, int k) {
  const int kt = k * (k + 1) / 2;
#pragma unroll
  for (int e = 0; e < kt; ++e) s.A[e] = fma(s.disc, c[e], s.A[e]);
#pragma unroll
  for (int i = 0; i < k; ++i) s.b[i] = fma(s.disc, c[kt + i], s.b[i]);
  s.disc *= c[kt + k];
}

// Inclusive scan of the lanes' summaries in lane order: lane j ends with
// the composition of lanes 0..j (Hillis-Steele, 5 steps).
template <int KB, bool kDisc>
__device__ __forceinline__ void scan_lanes(State<KB>& s, int lane, int k) {
  const int kt = k * (k + 1) / 2;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const bool on = lane >= o;
#pragma unroll
    for (int e = 0; e < kt; ++e) {
      const double x = __shfl_up_sync(kFull, s.A[e], o);
      if (on) s.A[e] = kDisc ? fma(s.disc, x, s.A[e]) : s.A[e] + x;
    }
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const double x = __shfl_up_sync(kFull, s.b[i], o);
      if (on) s.b[i] = kDisc ? fma(s.disc, x, s.b[i]) : s.b[i] + x;
    }
    if (kDisc) {
      const double x = __shfl_up_sync(kFull, s.disc, o);
      if (on) s.disc *= x;
    }
  }
}

// the inclusive scan shifted by one lane: lane j gets lanes 0..j-1, lane 0
// the zero state
template <int KB>
__device__ __forceinline__ void exclusive(State<KB>& s, int lane, int k) {
  const int kt = k * (k + 1) / 2;
#pragma unroll
  for (int e = 0; e < kt; ++e) {
    const double x = __shfl_up_sync(kFull, s.A[e], 1);
    s.A[e] = lane > 0 ? x : 0.0;
  }
#pragma unroll
  for (int i = 0; i < k; ++i) {
    const double x = __shfl_up_sync(kFull, s.b[i], 1);
    s.b[i] = lane > 0 ? x : 0.0;
  }
  const double x = __shfl_up_sync(kFull, s.disc, 1);
  s.disc = lane > 0 ? x : 1.0;
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
__device__ __forceinline__ bool chol_solve(const State<KB>& s, double reg, const double* __restrict__ mean, int k,
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
    double acc = fma(reg, mean[i], s.b[i]);
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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ int shift16(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// bytes from src (rounded out to 16-byte words) into dst, completing on bar
__device__ __forceinline__ void bulk(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<const uint8_t*>(src) - shift16(src)),
         "r"(static_cast<uint32_t>(round16(shift16(src) + bytes))), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(static_cast<uint32_t>(bytes)) : "memory");
}

// The range a warp walks: its group, first row and rows (0: none).
struct Range {
  int64_t g, t0;
  int len;
};

// item i < G: group i where it has at most L rows; item G + m: range m of
// the table
__device__ __forceinline__ Range range_of(const Problem& p, int64_t i) {
  Range r{0, 0, 0};
  if (i < p.G) {
    const int64_t n = p.rows[i];
    if (n <= p.L) r = Range{i, 0, static_cast<int>(n)};
  } else {
    const int64_t m = i - p.G;
    r.g = p.ranges[2 * m];
    r.t0 = p.ranges[2 * m + 1];
    r.len = static_cast<int>(min64(p.L, p.rows[r.g] - r.t0));
  }
  return r;
}

// The rows of stretch st of a range in device memory.
struct Stretch {
  int64_t row;  // g R + first row
  int64_t a;    // first row in the group
  int n;        // rows
};

__device__ __forceinline__ Stretch stretch_of(const Problem& p, const Range& rg, int st) {
  const int rows = kWarp * p.T;
  Stretch s;
  s.a = rg.t0 + static_cast<int64_t>(st) * rows;
  s.row = rg.g * p.R + s.a;
  s.n = static_cast<int>(min64(rows, rg.len - static_cast<int64_t>(st) * rows));
  return s;
}

// Lane 0: the bulk copies of a stretch into a stage.
// zb, mb: the stage's bytes for the rows of Z and for each mask
template <bool kRolling>
__device__ __forceinline__ void issue_stretch(const Problem& p, int zb, int mb, const Stretch& s,
                                              uint32_t stage, uint32_t bar) {
  const int C = p.K + 1;
  const double* z = p.Z + s.row * C;
  const uint8_t* v = p.v + s.row;
  const uint8_t* r = p.refresh + s.row;
  int bytes = round16(shift16(z) + 8 * s.n * C) + round16(shift16(v) + s.n) + round16(shift16(r) + s.n);
  const int32_t* l = kRolling ? p.leaving + s.row : nullptr;
  if (kRolling) bytes += round16(shift16(l) + 4 * s.n);
  expect(bar, bytes);
  bulk(stage, z, 8 * s.n * C, bar);
  bulk(stage + zb, v, s.n, bar);
  bulk(stage + zb + mb, r, s.n, bar);
  if (kRolling) bulk(stage + zb + 2 * mb, l, 4 * s.n, bar);
}

// A lane's view of a stretch in its stage.
struct Rows {
  const double* z;      // its first row
  const uint8_t* v;
  const uint8_t* refresh;
  const int32_t* leaving;
  int n;                // its rows (0..T)
};

// The rolling window's leaving rows of a stretch: the span [lo, hi] of
// the group's rows and the pieces of at most 32 T rows it is copied in.
struct Span {
  int lo, hi, pieces;
};

// Lanes walk their rows in order; in rolling, over the pieces of the
// leaving span, each lane going as far as the piece holds its leaving rows.
// `copy`: bring each piece in (else the one piece is still there).
template <int KB, bool kRolling, class Row>
__device__ __forceinline__ void over_rows(const Problem& p, const Rows& mine, const Span& sp, int64_t g,
                                          unsigned char* gone, uint32_t gone_bar, int& gone_phase,
                                          bool copy, int lane, Row&& row) {
  const int C = p.K + 1, cap = kWarp * p.T;
  const int passes = kRolling && sp.pieces > 0 ? sp.pieces : 1;
  int r = 0;
  for (int pc = 0; pc < passes; ++pc) {
    int lo = 0, hi = INT_MAX;
    const double* gz = nullptr;
    if (kRolling && sp.pieces > 0) {
      lo = sp.lo + pc * cap;
      hi = sp.hi + 1 < lo + cap ? sp.hi + 1 : lo + cap;
      const double* src = p.Z + (g * p.R + lo) * C;
      if (copy) {
        __syncwarp();  // every lane is done with the last piece
        if (lane == 0) {
          expect(gone_bar, round16(shift16(src) + 8 * (hi - lo) * C));
          bulk(shared_addr(gone), src, 8 * (hi - lo) * C, gone_bar);
        }
        wait_parity(gone_bar, static_cast<uint32_t>(gone_phase) & 1u);
        ++gone_phase;
      }
      gz = reinterpret_cast<const double*>(gone + shift16(src));
    }
    for (; r < mine.n; ++r) {
      const int s = kRolling ? mine.leaving[r] : -1;
      if (kRolling && s >= hi) break;
      row(r, mine.z + r * C, s >= 0 ? gz + (s - lo) * C : nullptr);
    }
  }
}

// One warp walks one range (kWalk) or forms its summary (else: the ranges
// of groups longer than L only, items G .. G + M - 1). seed: the ranges'
// start states [M, E] (null: zero). Walk: output into coef or pred; a
// stretch with a flagged row leaves its start state in
// sseed[item, stretch]; a range of the table leaves its last beta in tail
// and whether it has one in has. Summary: summ [M, E].
template <int KB, bool kRolling, bool kWalk>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
walk(Problem p, const double* __restrict__ mean, Layout lay, int64_t first, int64_t items, const double* __restrict__ seed,
     double* __restrict__ summ, double* __restrict__ sseed, int64_t nsmax, double* __restrict__ tail,
     uint8_t* __restrict__ has, double* __restrict__ coef, double* __restrict__ pred,
     uint8_t* __restrict__ flag, int* __restrict__ nflag) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int64_t item = first + static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (item >= first + items) return;
  const Range rg = range_of(p, item);
  if (rg.len <= 0) return;  // the whole warp leaves together
  const int k = KB, C = k + 1, T = p.T, E = k * (k + 1) / 2 + k + 1;
  unsigned char* base = smem + static_cast<int64_t>(warp) * lay.total;
  const uint32_t bars = shared_addr(base);
  double* carry = reinterpret_cast<double*>(base + lay.carry);
  double* cbeta = reinterpret_cast<double*>(base + lay.cbeta);
  int* known = reinterpret_cast<int*>(base + lay.misc);
  double* out = reinterpret_cast<double*>(base + lay.out);
  const int stage_bytes = lay.z + 2 * lay.m + lay.lv;
  const int nst = (rg.len + kWarp * T - 1) / (kWarp * T);
  const bool in_table = item >= p.G;

  if (lane == 0) {
    for (int b = 0; b < 3; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8u * b) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int st = 0; st < 2 && st < nst; ++st) {
      issue_stretch<kRolling>(p, lay.z, lay.m, stretch_of(p, rg, st),
                              shared_addr(base + lay.stage + st * stage_bytes), bars + 8u * st);
    }
  }
  const double* s0 = in_table && seed != nullptr ? seed + (item - p.G) * E : nullptr;
  for (int e = lane; e < E; e += kWarp) carry[e] = s0 != nullptr ? s0[e] : (e == E - 1 ? 1.0 : 0.0);
  if (kWalk) {
    for (int i = lane; i < k; i += kWarp) cbeta[i] = kRolling ? NAN : mean[i];
    if (lane == 0) *known = rg.t0 == 0 ? 1 : 0;  // a later range's carry comes from fill
  }
  __syncwarp();

  const bool coefs = coef != nullptr;
  const int ow = coefs ? k : 1;
  double* dst = coefs ? coef : pred;
  int gone_phase = 0;
  for (int st = 0; st < nst; ++st) {
    const int slot = st & 1;
    wait_parity(bars + 8u * slot, static_cast<uint32_t>(st >> 1) & 1u);
    const Stretch sx = stretch_of(p, rg, st);
    unsigned char* stage = base + lay.stage + slot * stage_bytes;
    const int r0 = lane * T;
    Rows mine;
    mine.z = reinterpret_cast<const double*>(stage + shift16(p.Z + sx.row * C)) + r0 * C;
    mine.v = stage + lay.z + shift16(p.v + sx.row) + r0;
    mine.refresh = stage + lay.z + lay.m + shift16(p.refresh + sx.row) + r0;
    mine.leaving = kRolling ? reinterpret_cast<const int32_t*>(
                                  stage + lay.z + 2 * lay.m + shift16(p.leaving + sx.row)) + r0
                            : nullptr;
    mine.n = sx.n - r0 < 0 ? 0 : (sx.n - r0 < T ? sx.n - r0 : T);
    Span sp{0, -1, 0};
    if (kRolling) {
      int lo = INT_MAX, hi = -1;
      for (int r = 0; r < mine.n; ++r) {
        const int s = mine.leaving[r];
        if (s >= 0) {
          lo = s < lo ? s : lo;
          hi = s > hi ? s : hi;
        }
      }
      sp.lo = __reduce_min_sync(kFull, lo);
      sp.hi = __reduce_max_sync(kFull, hi);
      sp.pieces = sp.hi >= sp.lo ? (sp.hi - sp.lo + kWarp * T) / (kWarp * T) : 0;
    }
    unsigned char* gone = base + lay.gone;
    const uint32_t gone_bar = bars + 16u;

    // 1. the summary of the lane's rows from a zero start, scanned over the lanes
    State<KB> s;
    clear<KB>(s, k);
    over_rows<KB, kRolling>(p, mine, sp, rg.g, gone, gone_bar, gone_phase, true, lane,
                            [&](int r, const double* row, const double* gz) {
                              double z[KB + 1];
                              load_row<KB>(z, row, k);
                              advance<KB, kRolling>(s, p.ff, z, mine.v[r] != 0, gz, k);
                            });
    scan_lanes<KB, !kRolling>(s, lane, k);
    if (kWalk) {
      exclusive<KB>(s, lane, k);
      compose_after<KB>(s, carry, k);
    } else {
      __syncwarp();
      if (lane == kWarp - 1) {
        compose_after<KB>(s, carry, k);
        store<KB>(s, k, carry);
      }
    }
    __syncwarp();
    if (kWalk) {
      // 2. each lane's start state is s: its walk, its output into the stage
      double beta[KB];
#pragma unroll
      for (int i = 0; i < k; ++i) beta[i] = 0.0;
      bool have = false, flagged = false;
      int lead = T;  // the lane's first refresh row
      over_rows<KB, kRolling>(
          p, mine, sp, rg.g, gone, gone_bar, gone_phase, sp.pieces > 1, lane,
          [&](int r, const double* row, const double* gz) {
            double z[KB + 1];
            load_row<KB>(z, row, k);
            advance<KB, kRolling>(s, p.ff, z, mine.v[r] != 0, gz, k);
            if (mine.refresh[r]) {
              const double reg = kRolling ? p.reg0 : s.disc * p.reg0;
              if (!chol_solve<KB>(s, reg, mean, k, beta)) {
                flag[sx.row + r0 + r] = 1;
                atomicAdd(nflag, 1);
                flagged = true;
#pragma unroll
                for (int i = 0; i < k; ++i) beta[i] = NAN;
              }
              if (!have) lead = r;
              have = true;
            }
            if (have) emit<KB>(out + (r0 + r) * ow, coefs, row, beta, k);
          });
      // 3. the beta the lane's leading rows carry: the last solved of the
      // lanes before it, else the stretch's incoming one
      const unsigned solved = __ballot_sync(kFull, have);
      const unsigned before = solved & ((1u << lane) - 1u);
      const int src = before != 0u ? 31 - __clz(before) : lane;
      const bool was_known = *known != 0;
      double in[KB];
#pragma unroll
      for (int i = 0; i < k; ++i) {
        const double x = __shfl_sync(kFull, beta[i], src);
        in[i] = before != 0u ? x : cbeta[i];
      }
      if (before != 0u || was_known) {
        for (int r = 0; r < lead && r < mine.n; ++r) emit<KB>(out + (r0 + r) * ow, coefs, mine.z + r * C, in, k);
      }
      // the first row with output: 0, or the range's first refresh row
      int from = 0;
      if (!was_known) {
        const int fl = solved != 0u ? __ffs(solved) - 1 : 0;
        const int lead_fl = __shfl_sync(kFull, lead, fl);
        from = solved != 0u ? fl * T + lead_fl : sx.n;
      }
      if (__any_sync(kFull, flagged) && sseed != nullptr) {
        double* ss = sseed + (item * nsmax + st) * E;
        for (int e = lane; e < E; e += kWarp) ss[e] = carry[e];
      }
      __syncwarp();  // every lane has read the carry and written its output
      if (lane == kWarp - 1) store<KB>(s, k, carry);
      if (solved != 0u && lane == 31 - __clz(solved)) {
#pragma unroll
        for (int i = 0; i < k; ++i) cbeta[i] = beta[i];
        *known = 1;
      }
      double* o = dst + sx.row * ow;
      for (int e = from * ow + lane; e < sx.n * ow; e += kWarp) o[e] = out[e];
      __syncwarp();
    }
    if (lane == 0 && st + 2 < nst) {
      issue_stretch<kRolling>(p, lay.z, lay.m, stretch_of(p, rg, st + 2), shared_addr(stage), bars + 8u * slot);
    }
  }
  if (!in_table) return;
  const int64_t m = item - p.G;
  if (!kWalk) {
    for (int e = lane; e < E; e += kWarp) summ[m * E + e] = carry[e];
  } else {
    for (int i = lane; i < k; i += kWarp) tail[m * k + i] = cbeta[i];
    if (lane == 0) has[m] = static_cast<uint8_t>(*known);
  }
}

// The prefix over each long group's range summaries, per state entry e:
// state[c + 1] = lam_c state[c] + summ[c], lam_c the range's total discount
// (the last entry, which itself runs as a product from 1). Ranges are flat
// (a group's are contiguous) and cut into segments that never cross a
// group: compose each segment, scan each group's segment totals, expand
// each segment from its start (the zero state where segseed is null).
__device__ __forceinline__ double step(double run, const double* __restrict__ summ, int64_t c, int e, int E) {
  const double lam = summ[c * E + E - 1];
  return e == E - 1 ? run * lam : fma(lam, run, summ[c * E + e]);
}

__global__ void __launch_bounds__(128)
prefix_compose(const double* __restrict__ summ, const int64_t* __restrict__ seg_first, int64_t NS, int E,
               double* __restrict__ segtot) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= NS * E) return;
  const int64_t sg = idx / E;
  const int e = static_cast<int>(idx % E);
  double run = e == E - 1 ? 1.0 : 0.0;
  for (int64_t c = seg_first[sg]; c < seg_first[sg + 1]; ++c) run = step(run, summ, c, e, E);
  segtot[sg * E + e] = run;
}

__global__ void __launch_bounds__(128)
prefix_scan(const double* __restrict__ segtot, const int64_t* __restrict__ grp_seg, int64_t NL, int E,
            double* __restrict__ segseed) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= NL * E) return;
  const int64_t j = idx / E;
  const int e = static_cast<int>(idx % E);
  double run = e == E - 1 ? 1.0 : 0.0;
  for (int64_t sg = grp_seg[j]; sg < grp_seg[j + 1]; ++sg) {
    segseed[sg * E + e] = run;
    run = step(run, segtot, sg, e, E);
  }
}

__global__ void __launch_bounds__(128)
prefix_expand(const double* __restrict__ summ, const int64_t* __restrict__ seg_first,
              const double* __restrict__ segseed, int64_t NS, int E, double* __restrict__ seed) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= NS * E) return;
  const int64_t sg = idx / E;
  const int e = static_cast<int>(idx % E);
  double run = segseed != nullptr ? segseed[sg * E + e] : (e == E - 1 ? 1.0 : 0.0);
  for (int64_t c = seg_first[sg]; c < seg_first[sg + 1]; ++c) {
    seed[c * E + e] = run;
    run = step(run, summ, c, e, E);
  }
}

// The leading rows of a later range of a long group that only carry take
// the last beta of the nearest earlier range that has one (the group's
// first range always has: the prior mean, or NaN for rolling).
template <int KB>
__global__ void __launch_bounds__(128)
fill(Problem p, const double* __restrict__ tail, const uint8_t* __restrict__ has,
     double* __restrict__ coef, double* __restrict__ pred) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= p.M) return;
  const Range rg = range_of(p, p.G + m);
  if (rg.t0 == 0) return;
  const int k = KB;
  int64_t src = m - 1;
  while (src > 0 && !has[src] && p.ranges[2 * (src - 1)] == rg.g) --src;
  double beta[KB];
#pragma unroll
  for (int i = 0; i < k; ++i) beta[i] = tail[src * k + i];
  for (int t = 0; t < rg.len; ++t) {
    const int64_t at = rg.g * p.R + rg.t0 + t;
    if (p.refresh[at]) break;
    double* dst = coef != nullptr ? coef + at * k : pred + at;
    emit<KB>(dst, coef != nullptr, p.Z + at * (k + 1), beta, k);
  }
}

// the system (A + reg I, b + reg mean) of each listed row (fg[f], ft[f]),
// walked from the start state of its stretch sseed[fseed[f]], which begins
// at row fa[f] of the group
template <int KB, bool kRolling>
__global__ void __launch_bounds__(128)
moments_at(Problem p, const double* __restrict__ mean, const double* __restrict__ sseed, const int64_t* __restrict__ fg,
           const int64_t* __restrict__ ft, const int64_t* __restrict__ fa,
           const int64_t* __restrict__ fseed, int64_t F, double* __restrict__ A_out,
           double* __restrict__ rhs_out) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int64_t g = fg[f], t_at = ft[f];
  const int k = KB, E = k * (k + 1) / 2 + k + 1;
  State<KB> s;
  load<KB>(s, k, sseed + fseed[f] * E);
  for (int64_t t = fa[f]; t <= t_at; ++t) {
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
    rhs_out[f * k + i] = fma(reg, mean[i], s.b[i]);
  }
}

// ---------------------------------------------------------------------------
// The shared form (K > 8): see the header.

constexpr int kSharedMaxWarps = 4;  // warps a walker
constexpr int kSharedMaxK = 100;    // the state ring and warp buffers in shared memory up to here
constexpr int kRegFactorMaxK = 48;  // the factor in registers (a lane rows l and l + 32) up to here
constexpr int kColumn = 64;         // doubles of a column buffer of the register factor
constexpr int kSharedPerSm = 228 * 1024;  // an SM's shared memory
// entries of a row loaded together before their updates are stored: a
// store to a warp's state or factor could alias a later load, so the
// compiler keeps them in order unless they are batched by hand
constexpr int kBatch = 8;
// pairs of a column the register factor loads before it updates with them
constexpr int kGroup = 4;

// doubles of a state (A packed, b, disc) and of a warp's buffers: the
// factor (A packed, then b's row), the reciprocal pivots, the beta it
// last solved and two column buffers
__host__ __device__ inline int state_doubles(int K) { return K * (K + 1) / 2 + K + 1; }
__host__ __device__ inline int warp_doubles(int K) {
  return (K * (K + 1) / 2 + K + 2 * K + (K > 2 * kColumn ? K : 2 * kColumn) + 3) & ~1;
}

// A walker's shared memory (byte offsets): two mbarriers, one stage of a
// piece of `rows` rows (Z, v, refresh, leaving: the register form's stage),
// the piece's leaving rows (rolling), the walker's carried beta and each
// warp's flags, and, where they fit (`here`), the ring of `warps` states
// and each warp's buffers; else those two sit in a device-memory workspace
// of work_doubles a walker.
struct SharedLayout {
  int warps, rows, z, m, lv, stage, gone, misc, ring, wbuf, total;
  bool here;
};

__host__ __device__ inline SharedLayout shared_layout(int K, int warps, int rows, bool rolling, bool here) {
  const int C = K + 1;
  SharedLayout l;
  l.warps = warps;
  l.rows = rows;
  l.here = here;
  l.z = round16(rows * C * 8) + 16;
  l.m = round16(rows) + 16;
  l.lv = rolling ? round16(rows * 4) + 16 : 0;
  l.stage = 32;
  l.gone = l.stage + l.z + 2 * l.m + l.lv;
  l.misc = l.gone + (rolling ? round16(rows * C * 8) : 0);
  l.ring = l.misc + round16(K * 8) + 2 * 4 * kSharedMaxWarps;
  l.wbuf = l.ring + (here ? round16(warps * state_doubles(K) * 8) : 0);
  l.total = l.wbuf + (here ? warps * warp_doubles(K) * 8 : 0);
  return l;
}

// walkers of a layout an SM's shared memory holds (1 KB of it reserved a
// block)
__host__ __device__ inline int walkers_per_sm(const SharedLayout& l) {
  return kSharedPerSm / (l.total + 1024);
}

// Up to kSharedMaxK: of walkers of w = 4 .. 1 warps, each staging its w
// runs of 32 T rows at once (and, past kRegFactorMaxK, one warp staging
// its run in pieces of a half or a quarter), the layout that fits the most
// warps on an SM, the most warps a walker among equals. Above, or where
// none fits: one warp, its ring and buffers in the workspace, on stages of
// the most rows that divide 32 T and fit; rows 0 where none does.
__host__ __device__ inline SharedLayout shared_layout_for(int K, int T, bool rolling) {
  const int run = kWarp * T;
  if (K <= kSharedMaxK) {
    SharedLayout best = shared_layout(K, 1, run, rolling, true);
    int most = 0;
    for (int w = kSharedMaxWarps; w >= 1; --w) {
      const int cuts = w == 1 && K > kRegFactorMaxK ? 3 : 1;
      for (int c = 0, rows = w * run; c < cuts && rows >= 1; ++c, rows /= 2) {
        const SharedLayout l = shared_layout(K, w, rows, rolling, true);
        const int warps = w * walkers_per_sm(l);
        if (l.total <= kMaxShared && warps > most) {
          best = l;
          most = warps;
        }
      }
    }
    if (most > 0) return best;
  }
  int rows = run;
  SharedLayout l = shared_layout(K, 1, rows, rolling, false);
  while (l.total > kMaxShared && rows > 1) {
    rows = rows % 2 == 0 ? rows / 2 : 1;
    l = shared_layout(K, 1, rows, rolling, false);
  }
  if (l.total > kMaxShared) l.rows = 0;
  return l;
}

__host__ __device__ inline int64_t work_doubles(int K, const SharedLayout& l) {
  return l.here ? 0 : int64_t{l.warps} * (state_doubles(K) + warp_doubles(K));
}

// (i, j <= i) of packed index e
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.0f * static_cast<float>(e) + 1.0f) - 1.0f) * 0.5f);
  if ((r + 1) * (r + 2) / 2 <= e) {
    ++r;
  } else if (r * (r + 1) / 2 > e) {
    --r;
  }
  i = r;
  j = e - r * (r + 1) / 2;
}

// 1 / d from the reciprocal's estimate and two Newton steps (an ulp or two
// from the division)
__device__ __forceinline__ double recip(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  double e = fma(-d, r, 1.0);
  r = fma(r, e, r);
  e = fma(-d, r, 1.0);
  return fma(r, e, r);
}

// The rows of piece pc (of P rows) of a range in device memory.
__device__ __forceinline__ Stretch piece_of(const Problem& p, const Range& rg, int pc, int P) {
  Stretch s;
  s.a = rg.t0 + static_cast<int64_t>(pc) * P;
  s.row = rg.g * p.R + s.a;
  s.n = static_cast<int>(min64(P, rg.len - static_cast<int64_t>(pc) * P));
  return s;
}

// Lane l's rows of a triangle of k rows where the rows are many (KB = 0):
// l and 63 - l of every 64, so that the lanes' rows hold about as many
// entries each; f(r) for each.
template <class F>
__device__ __forceinline__ void for_rows(int k, int lane, F&& f) {
  for (int base = 0; base < k; base += 2 * kWarp) {
    if (base + lane < k) f(base + lane);
    if (base + 2 * kWarp - 1 - lane < k) f(base + 2 * kWarp - 1 - lane);
  }
}

// st (a warp's state: A packed, then b) += the row's change: lane l owns
// rows l, l + 32 of A (row r's entries q <= r at r (r + 1) / 2 + q, a
// permutation of the banks over each half-warp's rows) and their entries
// of b (at kt + r); the row's values are broadcast. KB > 0: K <= KB, the
// loops unrolled; 0: any K, the rows of for_rows. gz the leaving row's
// values (null: none).
template <int KB>
__device__ __forceinline__ void update_state(double* __restrict__ st, const double* __restrict__ z,
                                             const double* __restrict__ gz, bool valid, bool scale, double ff, int k,
                                             int kt, int lane) {
  auto entry = [&](double a, double xr, double gr, double zq, double gq) {
    if (valid) {
      if (scale) a *= ff;
      a = fma(xr, zq, a);
    }
    if (gz != nullptr) a = fma(-gr, gq, a);
    return a;
  };
  auto row_b = [&](int r, double xr, double gr) {
    st[kt + r] = entry(st[kt + r], xr, gr, z[0], gz != nullptr ? gz[0] : 0.0);
  };
  if constexpr (KB > 0) {
    constexpr int kRows = (KB + kWarp - 1) / kWarp;
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int r = lane + h * kWarp;
      if (r >= k) continue;
      double* row = st + r * (r + 1) / 2;
      const double xr = z[1 + r], gr = gz != nullptr ? gz[1 + r] : 0.0;
#pragma unroll
      for (int q0 = 0; q0 < KB && q0 < (h + 1) * kWarp; q0 += kBatch) {
        if (q0 <= r) {
          // the whole batch is loaded and updated (entries past the row's
          // end lie in the state's later rows and are not stored), so only
          // the stores wait on a lane's test
          double a[kBatch], zq[kBatch], gq[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            a[u] = row[q0 + u];
            zq[u] = z[1 + q0 + u];
            gq[u] = gz != nullptr ? gz[1 + q0 + u] : 0.0;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) a[u] = entry(a[u], xr, gr, zq[u], gq[u]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (q0 + u <= r) row[q0 + u] = a[u];
          }
        }
      }
      row_b(r, xr, gr);
    }
  } else {
    for_rows(k, lane, [&](int r) {
      double* row = st + r * (r + 1) / 2;
      const double xr = z[1 + r], gr = gz != nullptr ? gz[1 + r] : 0.0;
      int q = 0;
      for (; q + kBatch <= r + 1; q += kBatch) {  // loads in flight together, then the stores
        double a[kBatch], zq[kBatch], gq[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          a[u] = row[q + u];
          zq[u] = z[1 + q + u];
          gq[u] = gz != nullptr ? gz[1 + q + u] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) row[q + u] = entry(a[u], xr, gr, zq[u], gq[u]);
      }
      for (; q <= r; ++q) row[q] = entry(row[q], xr, gr, z[1 + q], gz != nullptr ? gz[1 + q] : 0.0);
      row_b(r, xr, gr);
    });
  }
}

// one row's output from beta (k doubles in shared memory): the coefficients
// or the prediction x . beta (a warp's sum in a fixed order)
__device__ __forceinline__ void emit_row(const double* __restrict__ z, const double* __restrict__ beta, int k,
                                         int lane, int64_t at,
                                         double* __restrict__ coef, double* __restrict__ pred) {
  if (coef != nullptr) {
    for (int i = lane; i < k; i += kWarp) coef[at * k + i] = beta[i];
  } else {
    double acc = 0.0;
    for (int i = lane; i < k; i += kWarp) acc = fma(z[1 + i], beta[i], acc);
    for (int o = kWarp / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) pred[at] = acc;
  }
}

// The LDL' solve of (A + reg I) beta = b + reg mean from the state st, by
// one warp, K <= KB <= kRegFactorMaxK: lane l holds rows l and l + 32 of
// the factor in registers (the second where KB > 32) and eliminates by
// columns; column jc goes through a shared-memory buffer (two, used in
// turns, so one __syncwarp a column) and into fac (packed lower triangle)
// for the back substitution. The right-hand side is eliminated beside
// (lane l keeps y_l, y_{l+32}). Returns whether every pivot was positive
// and finite; beta into wbeta (NaN where not). phase 2 stops after the
// factorisation.
template <int KB>
__device__ __forceinline__ bool solve_regs(const double* __restrict__ st, double reg, const double* __restrict__ mean,
                                           int k, int lane, double* __restrict__ fac, double* __restrict__ colb,
                                           double* __restrict__ wbeta, int phase) {
  constexpr int KA = KB < kWarp ? KB : kWarp;
  constexpr int KH = KB > kWarp ? KB : 1;
  const int kt = k * (k + 1) / 2;
  const int r1 = lane, r2 = lane + kWarp;
  double Fa[KA], Fb[KH];
  const int t1 = r1 * (r1 + 1) / 2, t2 = r2 * (r2 + 1) / 2;
#pragma unroll
  for (int q = 0; q < KA; ++q) Fa[q] = r1 < k && q <= r1 ? st[t1 + q] + (q == r1 ? reg : 0.0) : 0.0;
#pragma unroll
  for (int q = 0; q < KH; ++q) Fb[q] = KB > kWarp && r2 < k && q <= r2 ? st[t2 + q] + (q == r2 ? reg : 0.0) : 0.0;
  double y1 = r1 < k ? fma(reg, mean[r1], st[kt + r1]) : 0.0;
  double y2 = KB > kWarp && r2 < k ? fma(reg, mean[r2], st[kt + r2]) : 0.0;
  double rd1 = 0.0, rd2 = 0.0;
  bool ok = true;
#pragma unroll
  for (int jc = 0; jc < KB; ++jc) {
    if (jc < k) {
      const double c1 = jc < KA ? Fa[jc < KA ? jc : 0] : 0.0;  // F[r1][jc]
      const double c2 = KB > kWarp ? Fb[jc < KH ? jc : 0] : 0.0;  // F[r2][jc]
      const double dj = __shfl_sync(kFull, jc < kWarp ? c1 : c2, jc % kWarp);
      ok = ok && dj > 0.0 && dj < INFINITY;
      const double rd = recip(dj);
      if (jc < kWarp) {
        rd1 = lane == jc ? rd : rd1;
      } else {
        rd2 = lane == jc - kWarp ? rd : rd2;
      }
      double* cb = colb + (jc & 1) * kColumn;
      cb[r1] = c1;
      if (KB > kWarp) cb[r2] = c2;
      if (r1 > jc && r1 < k) fac[t1 + jc] = c1;
      if (KB > kWarp && r2 > jc && r2 < k) fac[t2 + jc] = c2;
      __syncwarp();
      const double s1 = c1 * rd, s2 = c2 * rd;
      // the trailing columns q > jc (jc and q are constants here), two at a
      // time from the buffer, kGroup pairs loaded before their updates so
      // that the loads are in flight together; columns past K are updated
      // too (their entries are never read), so no update waits on a test
      const double2* cb2 = reinterpret_cast<const double2*>(cb);
#pragma unroll
      for (int q0 = (jc + 1) & ~1; q0 < KB; q0 += 2 * kGroup) {
        double2 cq[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (q0 + 2 * g < KB) cq[g] = cb2[(q0 + 2 * g) / 2];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int q = q0 + 2 * g;
          if (q < KB && q > jc) {
            if (q < KA) Fa[q < KA ? q : 0] = fma(-s1, cq[g].x, Fa[q < KA ? q : 0]);
            if (KB > kWarp) Fb[q < KH ? q : 0] = fma(-s2, cq[g].x, Fb[q < KH ? q : 0]);
          }
          if (q + 1 < KB) {
            if (q + 1 < KA) Fa[q + 1 < KA ? q + 1 : 0] = fma(-s1, cq[g].y, Fa[q + 1 < KA ? q + 1 : 0]);
            if (KB > kWarp) Fb[q + 1 < KH ? q + 1 : 0] = fma(-s2, cq[g].y, Fb[q + 1 < KH ? q + 1 : 0]);
          }
        }
      }
      const double yj = __shfl_sync(kFull, jc < kWarp ? y1 : y2, jc % kWarp) * rd;
      if (r1 > jc) y1 = fma(-yj, c1, y1);
      if (KB > kWarp && r2 > jc) y2 = fma(-yj, c2, y2);
    }
  }
  if (phase == 2) return ok;
  // beta_i = (y_i - sum_{q > i} F_qi beta_q) / d_i, i from k - 1 down (ri
  // a constant of the unrolled loop, so F_qi's loads need not wait); beta_i
  // passed by a shuffle
#pragma unroll
  for (int ri = KB - 1; ri >= 0; --ri) {
    if (ri < k) {
      const double bi = __shfl_sync(kFull, ri < kWarp ? y1 * rd1 : y2 * rd2, ri % kWarp);
      if (lane == ri % kWarp) wbeta[ri] = ok ? bi : NAN;
      const int tr = ri * (ri + 1) / 2;
      if (r1 < ri) y1 = fma(-fac[tr + r1], bi, y1);
      if (KB > kWarp && r2 < ri) y2 = fma(-fac[tr + r2], bi, y2);
    }
  }
  return ok;
}

// The same solve at any K in shared memory (or the workspace): the
// augmented system [A + reg I; b' + reg mean'] in fac (packed, row K is
// the right-hand side), LDL' by columns, right-looking, each lane updating
// its rows (for_rows) from column jc, which is first copied to a
// contiguous buffer (colb, K doubles); then the back substitution by
// columns, each lane its entries of the right-hand side.
__device__ __forceinline__ bool solve_shared(const double* __restrict__ st, double reg,
                                             const double* __restrict__ mean, int k, int lane,
                                             double* __restrict__ fac, double* __restrict__ rpiv,
                                             double* __restrict__ colb, double* __restrict__ wbeta, int phase) {
  const int kt = k * (k + 1) / 2;
  for_rows(k, lane, [&](int r) {
    const int t = r * (r + 1) / 2;
    int q = 0;
    for (; q + kBatch <= r; q += kBatch) {  // loads in flight together (the stores could alias them)
      double v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = st[t + q + u];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) fac[t + q + u] = v[u];
    }
    for (; q < r; ++q) fac[t + q] = st[t + q];
    fac[t + r] = st[t + r] + reg;
    fac[kt + r] = fma(reg, mean[r], st[kt + r]);
  });
  __syncwarp();
  bool ok = true;
  // F_rq -= F_rj F_qj / d_j for j < q <= r, and y_r -= y_j F_rj / d_j
  for (int jc = 0; jc < k; ++jc) {
    const double dj = fac[jc * (jc + 1) / 2 + jc];
    ok = ok && dj > 0.0 && dj < INFINITY;
    const double rd = recip(dj);
    if (lane == 0) rpiv[jc] = rd;
    for (int q = jc + 1 + lane; q < k; q += kWarp) colb[q] = fac[q * (q + 1) / 2 + jc];
    __syncwarp();
    const double yj = fac[kt + jc] * rd;
    for_rows(k, lane, [&](int r) {
      if (r <= jc) return;
      double* row = fac + r * (r + 1) / 2;
      const double cr = colb[r], sr = cr * rd;
      int q = jc + 1;
      for (; q + kBatch <= r + 1; q += kBatch) {  // loads in flight together, then the stores
        double a[kBatch], c[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          a[u] = row[q + u];
          c[u] = colb[q + u];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) row[q + u] = fma(-sr, c[u], a[u]);
      }
      for (; q <= r; ++q) row[q] = fma(-sr, colb[q], row[q]);
      fac[kt + r] = fma(-yj, cr, fac[kt + r]);
    });
    __syncwarp();
  }
  if (phase == 2) return ok;
  // beta_i = (y_i - sum_{q > i} F_qi beta_q) / d_i by columns
  for (int ri = k - 1; ri >= 0; --ri) {
    const double bi = fac[kt + ri] * rpiv[ri];
    if (lane == 0) wbeta[ri] = ok ? bi : NAN;
    const int ti = ri * (ri + 1) / 2;
    for (int q = lane; q < ri; q += kWarp) fac[kt + q] = fma(-fac[ti + q], bi, fac[kt + q]);
    __syncwarp();
  }
  return ok;
}

// A walker (a block of NW warps) walks ranges in turn (a persistent grid):
// the walk (kWalk) or the summary, with the arguments of the register
// form's walk; work: the workspace, a slot a block, where the layout says
// so (kHere false); phase 1 / 2 / 3 stops each solve after the update, the
// LDL' and the back substitution (no output), 0 runs it all. KB: the
// register factor's width (0: the factor in shared memory).
template <int KB, bool kRolling, bool kWalk, bool kHere>
__global__ void __launch_bounds__(kSharedMaxWarps * kWarp)
walk_shared(Problem p, const double* __restrict__ mean, SharedLayout lay, int64_t first, int64_t items,
            const double* __restrict__ seed, double* __restrict__ summ, double* __restrict__ sseed,
            int64_t nsmax, double* __restrict__ tail, uint8_t* __restrict__ has,
            double* __restrict__ coef, double* __restrict__ pred, uint8_t* __restrict__ flag,
            int* __restrict__ nflag, double* __restrict__ work, int phase) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = static_cast<int>(threadIdx.x), nt = static_cast<int>(blockDim.x);
  const int warp = tid / kWarp, lane = tid % kWarp, NW = lay.warps;
  const int k = p.K, C = k + 1, kt = k * (k + 1) / 2, body = kt + k, E = body + 1;
  const int run = kWarp * p.T, P = lay.rows, stretch = NW * run;  // NW > 1: P == stretch
  const uint32_t bar = shared_addr(smem);
  // kHere (the layout's `here`, a template argument so that the compiler
  // knows these are shared-memory addresses): the ring and the warps'
  // buffers in shared memory, else in the block's workspace slot
  double* ring = kHere ? reinterpret_cast<double*>(smem + lay.ring)
                       : work + static_cast<int64_t>(blockIdx.x) * work_doubles(k, lay);
  // warp w's buffers: its factor, reciprocal pivots, beta and column buffers
  auto warp_buf = [&](int w) {
    return (kHere ? reinterpret_cast<double*>(smem + lay.wbuf) : ring + NW * E) + w * warp_doubles(k);
  };
  double* wb = warp_buf(warp);
  double* fac = wb;
  double* rpiv = wb + body;
  double* wbeta = rpiv + k;
  double* colb = wbeta + k + ((body + 2 * k) & 1);  // 16-byte aligned
  double* cbeta = reinterpret_cast<double*>(smem + lay.misc);
  int* whas = reinterpret_cast<int*>(smem + lay.misc + round16(k * 8));
  int* wlead = whas + kSharedMaxWarps;
  double* gone = reinterpret_cast<double*>(smem + lay.gone);
  unsigned char* stage = smem + lay.stage;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t used = 0;  // pieces this walker has taken from its stage
  for (int64_t item = first + blockIdx.x; item < first + items; item += gridDim.x) {
    const Range rg = range_of(p, item);
    if (rg.len <= 0) continue;  // the whole block moves on together
    const int npc = (rg.len + P - 1) / P;
    const bool in_table = item >= p.G;
    if (tid == 0) issue_stretch<kRolling>(p, lay.z, lay.m, piece_of(p, rg, 0, P), shared_addr(stage), bar);
    // the carry: ring slot c
    int c = 0;
    const double* s0 = in_table && seed != nullptr ? seed + (item - p.G) * E : nullptr;
    for (int e = tid; e < E; e += nt) ring[e] = s0 != nullptr ? s0[e] : (e == E - 1 ? 1.0 : 0.0);
    if (kWalk) {
      for (int i = tid; i < k; i += nt) cbeta[i] = kRolling ? NAN : mean[i];
    }
    bool known = rg.t0 == 0;  // a later range's leading rows that carry come from fill
    __syncthreads();

    for (int pc = 0; pc < npc; ++pc, ++used) {
      wait_parity(bar, used & 1u);
      const Stretch sx = piece_of(p, rg, pc, P);
      const double* zs = reinterpret_cast<const double*>(stage + shift16(p.Z + sx.row * C));
      const uint8_t* vs = stage + lay.z + shift16(p.v + sx.row);
      const uint8_t* rs = stage + lay.z + lay.m + shift16(p.refresh + sx.row);
      const int32_t* ls = kRolling ? reinterpret_cast<const int32_t*>(
                                         stage + lay.z + 2 * lay.m + shift16(p.leaving + sx.row))
                                   : nullptr;
      if (kRolling) {  // the piece's leaving rows, gathered beside it
        for (int idx = tid; idx < sx.n * C; idx += nt) {
          const int r = idx / C;
          const int32_t src = ls[r];
          if (src >= 0) gone[idx] = p.Z[(rg.g * p.R + src) * C + (idx - r * C)];
        }
      }
      const int at = pc * P;  // the piece's first row in the range
      if (kWalk && sseed != nullptr && at % stretch == 0) {  // a stretch's start state, for moments_at
        double* ss = sseed + (item * nsmax + at / stretch) * E;
        for (int e = tid; e < E; e += nt) ss[e] = ring[c * E + e];
      }
      __syncthreads();
      // the warps' runs: warp w rows [w run, (w + 1) run) of the piece (one
      // warp: all of it)
      const int nact = NW > 1 ? (sx.n + run - 1) / run : 1;
      const int lo = NW > 1 ? warp * run : 0;
      const int hi = NW > 1 ? (lo + run < sx.n ? lo + run : sx.n) : sx.n;
      // 1. the summary of each run but the last from a zero start, into the
      // slots after the carry
      if (warp < nact - 1) {
        double* st = ring + ((c + 1 + warp) % NW) * E;
        for (int e = lane; e < body; e += kWarp) st[e] = 0.0;
        double disc = 1.0;
        __syncwarp();
        for (int r = lo; r < hi; ++r) {
          const bool valid = vs[r] != 0;
          const bool scale = !kRolling && valid && p.ff != 1.0;
          if (scale) disc *= p.ff;
          update_state<KB>(st, zs + r * C, kRolling && ls[r] >= 0 ? gone + r * C : nullptr, valid, scale, p.ff, k,
                           kt, lane);
        }
        if (lane == 0) st[body] = disc;
      }
      if (nact > 1) {
        // 2. composed in warp order onto the carry, in place: slot c + 1 + w
        // ends as the state after run w, the start of run w + 1
        __syncthreads();
        double dsc[kSharedMaxWarps];
#pragma unroll
        for (int w = 0; w < kSharedMaxWarps; ++w) dsc[w] = w < nact - 1 ? ring[((c + 1 + w) % NW) * E + body] : 1.0;
        __syncthreads();
        for (int e = tid; e < E; e += nt) {
          double acc = ring[c * E + e];
#pragma unroll
          for (int w = 0; w < kSharedMaxWarps; ++w) {
            if (w < nact - 1) {
              double* sw = ring + ((c + 1 + w) % NW) * E;
              acc = e == body ? acc * sw[e] : fma(dsc[w], acc, sw[e]);
              sw[e] = acc;
            }
          }
        }
        __syncthreads();
      }
      // 3. each run walked from its start state in its slot (the summary:
      // the last run only); the last run's end state is the new carry
      if (warp < nact && (kWalk || warp == nact - 1)) {
        double* st = ring + ((c + warp) % NW) * E;
        double disc = st[body];
        bool have = false;
        int lead = hi - lo;  // rows before the run's first refresh row
        for (int r = lo; r < hi; ++r) {
          const double* z = zs + r * C;
          const bool valid = vs[r] != 0;
          const bool scale = !kRolling && valid && p.ff != 1.0;
          if (scale) disc *= p.ff;
          update_state<KB>(st, z, kRolling && ls[r] >= 0 ? gone + r * C : nullptr, valid, scale, p.ff, k, kt, lane);
          if (!kWalk) continue;
          if (rs[r] != 0 && phase != 1) {
            __syncwarp();
            const double reg = kRolling ? p.reg0 : disc * p.reg0;
            bool ok;
            if constexpr (KB > 0) {
              ok = solve_regs<KB>(st, reg, mean, k, lane, fac, colb, wbeta, phase);
            } else {
              ok = solve_shared(st, reg, mean, k, lane, fac, rpiv, colb, wbeta, phase);
            }
            if (!ok && lane == 0 && phase == 0) {
              flag[sx.row + r] = 1;
              atomicAdd(nflag, 1);
            }
            __syncwarp();
            if (!have) lead = r - lo;
            have = true;
          }
          if (have && phase == 0) emit_row(z, wbeta, k, lane, sx.row + r, coef, pred);
        }
        if (lane == 0) {
          st[body] = disc;
          whas[warp] = have ? 1 : 0;
          wlead[warp] = lead;
        }
      }
      __syncthreads();
      if (kWalk && warp < nact) {
        // 4. a run's leading rows carry the last beta solved before it: of
        // the nearest earlier run that solved one, else the walker's
        int src = -1;
        for (int w = warp - 1; w >= 0 && src < 0; --w) src = whas[w] != 0 ? w : -1;
        const double* bin = src >= 0 ? warp_buf(src) + body + k : cbeta;
        if ((src >= 0 || known) && phase == 0) {
          for (int r = lo; r < lo + wlead[warp]; ++r) emit_row(zs + r * C, bin, k, lane, sx.row + r, coef, pred);
        }
      }
      __syncthreads();
      if (kWalk) {
        int last = -1;
        for (int w = 0; w < nact; ++w) last = whas[w] != 0 ? w : last;
        if (last >= 0) {
          const double* bl = warp_buf(last) + body + k;
          for (int i = tid; i < k; i += nt) cbeta[i] = bl[i];
          known = true;
        }
      }
      c = (c + nact - 1) % NW;
      __syncthreads();  // the stage, the leaving rows and the beta are read
      if (tid == 0 && pc + 1 < npc) {
        issue_stretch<kRolling>(p, lay.z, lay.m, piece_of(p, rg, pc + 1, P), shared_addr(stage), bar);
      }
    }
    if (in_table) {
      const int64_t m = item - p.G;
      if (!kWalk) {
        for (int e = tid; e < E; e += nt) summ[m * E + e] = ring[c * E + e];
      } else {
        for (int i = tid; i < k; i += nt) tail[m * k + i] = cbeta[i];
        if (tid == 0) has[m] = known ? 1 : 0;
      }
    }
    __syncthreads();  // before the next range takes the ring and beta
  }
}

// fill (above) at any K, for the shared form. The register form keeps its
// templated fill and moments_at: run in their place at K <= 8 on an H100,
// these two changed its outputs' bits (chip_smoke.REGISTER_FORM_DIGESTS),
// which are held fixed.
__global__ void __launch_bounds__(128)
fill_shared(Problem p, const double* __restrict__ tail, const uint8_t* __restrict__ has,
            double* __restrict__ coef, double* __restrict__ pred) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= p.M) return;
  const Range rg = range_of(p, p.G + m);
  if (rg.t0 == 0) return;
  const int k = p.K;
  int64_t src = m - 1;
  while (src > 0 && !has[src] && p.ranges[2 * (src - 1)] == rg.g) --src;
  const double* beta = tail + src * k;
  for (int t = 0; t < rg.len; ++t) {
    const int64_t at = rg.g * p.R + rg.t0 + t;
    if (p.refresh[at]) break;
    if (coef != nullptr) {
      for (int i = 0; i < k; ++i) coef[at * k + i] = beta[i];
    } else {
      const double* z = p.Z + at * (k + 1);
      double acc = 0.0;
      for (int i = 0; i < k; ++i) acc = fma(z[1 + i], beta[i], acc);
      pred[at] = acc;
    }
  }
}

// moments_at (above) at any K: a block a listed row, its threads over the
// entries, each walking the rows from the stretch's start state
template <bool kRolling>
__global__ void __launch_bounds__(128)
moments_at_shared(Problem p, const double* __restrict__ mean, const double* __restrict__ sseed,
                  const int64_t* __restrict__ fg, const int64_t* __restrict__ ft,
                  const int64_t* __restrict__ fa, const int64_t* __restrict__ fseed,
                  double* __restrict__ A_out, double* __restrict__ rhs_out) {
  const int64_t f = blockIdx.x;
  const int k = p.K, C = k + 1, kt = k * (k + 1) / 2, body = kt + k;
  const int64_t g = fg[f], t_at = ft[f], t0 = fa[f];
  const double* s0 = sseed + fseed[f] * (body + 1);
  double disc = s0[body];
  if (!kRolling && p.ff != 1.0) {
    for (int64_t t = t0; t <= t_at; ++t) {
      if (p.v[g * p.R + t]) disc *= p.ff;
    }
  }
  const double reg = kRolling ? p.reg0 : disc * p.reg0;
  for (int e = threadIdx.x; e < body; e += blockDim.x) {
    int i, j = -1;
    if (e < kt) {
      untri(e, i, j);
    } else {
      i = e - kt;
    }
    double a = s0[e];
    for (int64_t t = t0; t <= t_at; ++t) {
      const int64_t at = g * p.R + t;
      if (p.v[at]) {
        const double* z = p.Z + at * C;
        if (!kRolling && p.ff != 1.0) a *= p.ff;
        a = fma(z[1 + i], z[1 + j], a);
      }
      if (kRolling && p.leaving[at] >= 0) {
        const double* gz = p.Z + (g * p.R + p.leaving[at]) * C;
        a = fma(-gz[1 + i], gz[1 + j], a);
      }
    }
    if (e < kt) {
      const double x = i == j ? a + reg : a;
      A_out[(f * k + i) * k + j] = x;
      A_out[(f * k + j) * k + i] = x;
    } else {
      rhs_out[f * k + i] = fma(reg, mean[i], a);
    }
  }
}

unsigned blocks_for(int64_t threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

// warps a block: as many as fit the block's shared memory, at most kMaxWarps
int warps_per_block(const Layout& lay) {
  const int w = kMaxShared / lay.total;
  return w < kMaxWarps ? w : kMaxWarps;
}

template <class Kernel>
int prepare(Kernel kernel, const Layout& lay, int* wpb) {
  *wpb = warps_per_block(lay);
  if (*wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               *wpb * lay.total));
}

template <bool kWalk, int KB, bool kRolling>
int launch_walk(const Problem& p, const double* mean, int ow, int64_t first, int64_t items,
                const double* seed, double* summ, double* sseed, int64_t nsmax, double* tail,
                uint8_t* has, double* coef, double* pred, uint8_t* flag, int* nflag, cudaStream_t st) {
  if (items == 0) return 0;
  const Layout lay = layout_for(p.K, p.T, kRolling, ow);
  auto kernel = walk<KB, kRolling, kWalk>;
  int wpb = 0;
  const int rc = prepare(kernel, lay, &wpb);
  if (rc != 0) return rc;
  kernel<<<blocks_for(items, wpb), wpb * kWarp, wpb * lay.total, st>>>(
      p, mean, lay, first, items, seed, summ, sseed, nsmax, tail, has, coef, pred, flag, nflag);
  return static_cast<int>(cudaGetLastError());
}

// The prefix over the range summaries into each range's seed (the start
// state its walk takes).
int run_prefix(const Problem& p, const int64_t* seg_first, int64_t NS, const int64_t* grp_seg, int64_t NL,
               const double* summ, double* seed, double* segtot, double* segseed, cudaStream_t st) {
  const int E = p.K * (p.K + 1) / 2 + p.K + 1;
  if (NS > NL) {
    prefix_compose<<<blocks_for(NS * E, 128), 128, 0, st>>>(summ, seg_first, NS, E, segtot);
    prefix_scan<<<blocks_for(NL * E, 128), 128, 0, st>>>(segtot, grp_seg, NL, E, segseed);
  } else {
    segseed = nullptr;
  }
  prefix_expand<<<blocks_for(NS * E, 128), 128, 0, st>>>(summ, seg_first, segseed, NS, E, seed);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool kRolling>
int run_all(const Problem& p, const double* mean, const int64_t* seg_first, int64_t NS,
            const int64_t* grp_seg, int64_t NL, double* summ, double* seed, double* segtot,
            double* segseed, double* sseed, int64_t nsmax, double* tail, uint8_t* has, double* coef,
            double* pred, uint8_t* flag, int* nflag, cudaStream_t st) {
  int rc = 0;
  if (p.M > 0) {
    rc = launch_walk<false, KB, kRolling>(p, mean, 0, p.G, p.M, nullptr, summ, nullptr, 0, nullptr,
                                          nullptr, nullptr, nullptr, nullptr, nullptr, st);
    if (rc == 0) rc = run_prefix(p, seg_first, NS, grp_seg, NL, summ, seed, segtot, segseed, st);
    if (rc != 0) return rc;
  }
  rc = launch_walk<true, KB, kRolling>(p, mean, coef != nullptr ? p.K : 1, 0, p.G + p.M, seed, nullptr,
                                       sseed, nsmax, tail, has, coef, pred, flag, nflag, st);
  if (rc != 0 || p.M == 0) return rc;
  fill<KB><<<blocks_for(p.M, 128), 128, 0, st>>>(p, tail, has, coef, pred);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool kRolling>
int run_moments_at(const Problem& p, const double* mean, const double* sseed, const int64_t* fg,
                   const int64_t* ft, const int64_t* fa, const int64_t* fseed, int64_t F,
                   double* A_out, double* rhs_out, cudaStream_t st) {
  moments_at<KB, kRolling><<<blocks_for(F, 128), 128, 0, st>>>(p, mean, sseed, fg, ft, fa, fseed, F,
                                                                A_out, rhs_out);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool kRolling>
int run_occupancy(int K, int T, int ow, int* warps) {
  const Layout lay = layout_for(K, T, kRolling, ow);
  auto kernel = walk<KB, kRolling, true>;
  int wpb = 0, blocks = 0;
  int rc = prepare(kernel, lay, &wpb);
  if (rc != 0) return rc;
  rc = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, wpb * kWarp, wpb * lay.total));
  *warps = blocks * wpb;
  return rc;
}

// the shared form
// the walker's shared memory, and the largest carveout, so that the blocks
// the occupancy calculator counts an SM are resident at once (the grid is
// persistent: a block beyond them would wait for a whole walker)
template <class Kernel>
int prepare_shared(Kernel kernel, const SharedLayout& lay) {
  if (lay.rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  }
  return static_cast<int>(err);
}

// the register factor's width at K features (0: the factor in shared
// memory or the workspace)
inline int factor_width(int K) {
  return K <= 16 ? 16 : (K <= 32 ? 32 : (K <= 40 ? 40 : (K <= kRegFactorMaxK ? kRegFactorMaxK : 0)));
}

// the walk (kWalk) or summary kernel at a layout: the ring and warp
// buffers in shared memory (every layout with the register factor) or in
// the workspace
template <int KB, bool kRolling, bool kWalk>
auto walk_kernel(const SharedLayout& lay) {
  if constexpr (KB > 0) {
    return walk_shared<KB, kRolling, kWalk, true>;
  } else {
    return lay.here ? walk_shared<0, kRolling, kWalk, true> : walk_shared<0, kRolling, kWalk, false>;
  }
}

template <int KB, bool kRolling>
int run_walk_shared(const Problem& p, const double* mean, const SharedLayout& lay, int64_t walkers, double* work,
                    const double* seed, double* sseed, int64_t nsmax, double* tail, uint8_t* has, double* coef,
                    double* pred, uint8_t* flag, int* nflag, int phase, cudaStream_t st) {
  if (KB > 0 && !lay.here) return static_cast<int>(cudaErrorInvalidValue);
  auto walker = walk_kernel<KB, kRolling, true>(lay);
  const int rc = prepare_shared(walker, lay);
  if (rc != 0) return rc;
  walker<<<static_cast<unsigned>(min64(p.G + p.M, walkers)), lay.warps * kWarp, lay.total, st>>>(
      p, mean, lay, 0, p.G + p.M, seed, nullptr, sseed, nsmax, tail, has, coef, pred, flag, nflag, work, phase);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRolling>
int run_all_shared(const Problem& p, const double* mean, int64_t walkers, double* work,
                   const int64_t* seg_first, int64_t NS, const int64_t* grp_seg, int64_t NL, double* summ,
                   double* seed, double* segtot, double* segseed, double* sseed, int64_t nsmax, double* tail,
                   uint8_t* has, double* coef, double* pred, uint8_t* flag, int* nflag, int phase, cudaStream_t st) {
  const SharedLayout lay = shared_layout_for(p.K, p.T, kRolling);
  if (walkers < 1 || (!lay.here && work == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  int rc = 0;
  if (p.M > 0) {
    auto summary = walk_kernel<0, kRolling, false>(lay);
    rc = prepare_shared(summary, lay);
    if (rc != 0) return rc;
    summary<<<static_cast<unsigned>(min64(p.M, walkers)), lay.warps * kWarp, lay.total, st>>>(
        p, mean, lay, p.G, p.M, nullptr, summ, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, work, 0);
    rc = static_cast<int>(cudaGetLastError());
    if (rc == 0) rc = run_prefix(p, seg_first, NS, grp_seg, NL, summ, seed, segtot, segseed, st);
    if (rc != 0) return rc;
  }
  switch (factor_width(p.K)) {
    case 16:
      rc = run_walk_shared<16, kRolling>(p, mean, lay, walkers, work, seed, sseed, nsmax, tail, has, coef, pred,
                                         flag, nflag, phase, st);
      break;
    case 32:
      rc = run_walk_shared<32, kRolling>(p, mean, lay, walkers, work, seed, sseed, nsmax, tail, has, coef, pred,
                                         flag, nflag, phase, st);
      break;
    case 40:
      rc = run_walk_shared<40, kRolling>(p, mean, lay, walkers, work, seed, sseed, nsmax, tail, has, coef, pred,
                                         flag, nflag, phase, st);
      break;
    case kRegFactorMaxK:
      rc = run_walk_shared<kRegFactorMaxK, kRolling>(p, mean, lay, walkers, work, seed, sseed, nsmax, tail, has,
                                                     coef, pred, flag, nflag, phase, st);
      break;
    default:
      rc = run_walk_shared<0, kRolling>(p, mean, lay, walkers, work, seed, sseed, nsmax, tail, has, coef, pred,
                                        flag, nflag, phase, st);
  }
  if (rc != 0 || p.M == 0 || phase != 0) return rc;
  fill_shared<<<blocks_for(p.M, 128), 128, 0, st>>>(p, tail, has, coef, pred);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRolling>
int run_moments_at_shared(const Problem& p, const double* mean, const double* sseed, const int64_t* fg,
                          const int64_t* ft, const int64_t* fa, const int64_t* fseed, int64_t F,
                          double* A_out, double* rhs_out, cudaStream_t st) {
  moments_at_shared<kRolling><<<static_cast<unsigned>(F), 128, 0, st>>>(p, mean, sseed, fg, ft, fa, fseed,
                                                                        A_out, rhs_out);
  return static_cast<int>(cudaGetLastError());
}

template <int KB, bool kRolling>
int occupancy_shared(const SharedLayout& lay, int* walkers) {
  auto kernel = walk_kernel<KB, kRolling, true>(lay);
  int blocks = 0;
  int rc = prepare_shared(kernel, lay);
  if (rc != 0) return rc;
  rc = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, lay.warps * kWarp, lay.total));
  *walkers = blocks;
  return rc;
}

template <bool kRolling>
int run_occupancy_shared(int K, int T, int* walkers) {
  const SharedLayout lay = shared_layout_for(K, T, kRolling);
  switch (factor_width(K)) {
    case 16: return occupancy_shared<16, kRolling>(lay, walkers);
    case 32: return occupancy_shared<32, kRolling>(lay, walkers);
    case 40: return occupancy_shared<40, kRolling>(lay, walkers);
    case kRegFactorMaxK: return occupancy_shared<kRegFactorMaxK, kRolling>(lay, walkers);
    default: return occupancy_shared<0, kRolling>(lay, walkers);
  }
}

bool valid_sizes(int64_t G, int64_t R, int K, int T) {
  return G >= 0 && R >= 0 && R < (int64_t{1} << 31) && K >= 1 && K <= kMaxK && T >= 1 && T <= kMaxT;
}

}  // namespace

// The register form's templates at K <= 8, the shared form above
#define POLS_MOVING_DISPATCH(K, ROLLING, CALL, SHARED)             \
  switch (K) {                                                     \
    case 1: return (ROLLING) ? CALL(1, true) : CALL(1, false);     \
    case 2: return (ROLLING) ? CALL(2, true) : CALL(2, false);     \
    case 3: return (ROLLING) ? CALL(3, true) : CALL(3, false);     \
    case 4: return (ROLLING) ? CALL(4, true) : CALL(4, false);     \
    case 5: return (ROLLING) ? CALL(5, true) : CALL(5, false);     \
    case 6: return (ROLLING) ? CALL(6, true) : CALL(6, false);     \
    case 7: return (ROLLING) ? CALL(7, true) : CALL(7, false);     \
    case 8: return (ROLLING) ? CALL(8, true) : CALL(8, false);     \
    default: return (ROLLING) ? SHARED(true) : SHARED(false);      \
  }

extern "C" {

// The moving fit of Z [G, R, 1 + K] (contiguous f64, target first) over the
// valid rows v [G, R] of groups of rows[g] rows each: beta into coef
// [G, R, K] or x . beta into pred [G, R] (the other null), in stretches of
// 32 T rows. rolling: leaving [G, R] int32 and reg0 = alpha; else reg0 =
// 1 / c, ff the forgetting factor. mean0: the prior mean, K doubles in
// device memory (zeros for rolling). A group of more than L rows is walked
// in the M ranges of the table
// ranges [M, 2] (group, first row; a group's ranges contiguous and in row
// order), cut for the prefix into NS segments (seg_first [NS + 1], flat
// range indices) of NL groups (grp_seg [NL + 1], segment indices). Scratch:
// summ and seed [M, E] (E = K (K + 1) / 2 + K + 1), segtot and segseed
// [NS, E], tail [M, K], has [M]; sseed [G + M, nsmax, E] receives the start
// state of every stretch that holds a flagged row (the shared form: of
// every stretch; nsmax: stretches of the longest range). flag [G, R] and
// nflag [1] arrive zeroed and mark and count the rows whose Cholesky failed.
// K > 8 (the shared form): walkers, the blocks of the persistent grid
// (pols_moving_resident_warps times the SMs), and work, walkers times
// pols_moving_workspace doubles (null where that is 0); phase 1 / 2 / 3
// stops its walk after the update, the LDL' and the back substitution
// (no output: for timing the phases), 0 runs it all. Launches on
// `stream` without synchronising; returns the CUDA error code of the first
// launch that failed (0 on success).
int pols_moving(const double* Z, const uint8_t* v, const int64_t* rows, const uint8_t* refresh,
                const int32_t* leaving, int64_t G, int64_t R, int K, int T, int64_t L, int rolling,
                double ff, double reg0, const double* mean0, const int64_t* ranges, int64_t M,
                const int64_t* seg_first, int64_t NS, const int64_t* grp_seg, int64_t NL,
                double* summ, double* seed, double* segtot, double* segseed, double* sseed,
                int64_t nsmax, double* tail, uint8_t* has, double* coef, double* pred,
                uint8_t* flag, int* nflag, int64_t walkers, double* work, int phase, void* stream) {
  const Problem p{Z, v, rows, refresh, leaving, ranges, G, R, L, M, K, T, ff, reg0};
  if (!valid_sizes(G, R, K, T) || L < 1 || M < 0 || mean0 == nullptr ||
      (coef == nullptr) == (pred == nullptr) || (rolling != 0) != (leaving != nullptr) ||
      (M > 0 && (ranges == nullptr || seg_first == nullptr || grp_seg == nullptr || NL < 1 ||
                 NS < NL || summ == nullptr || seed == nullptr || tail == nullptr || has == nullptr ||
                 (NS > NL && (segtot == nullptr || segseed == nullptr))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0 || R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POLS_RUN_ALL(KB, ROLL)                                                                        \
  run_all<KB, ROLL>(p, mean0, seg_first, NS, grp_seg, NL, summ, seed, segtot, segseed, sseed, nsmax, \
                    tail, has, coef, pred, flag, nflag, st)
#define POLS_RUN_SHARED(ROLL)                                                                        \
  run_all_shared<ROLL>(p, mean0, walkers, work, seg_first, NS, grp_seg, NL, summ, seed, segtot,       \
                       segseed, sseed, nsmax, tail, has, coef, pred, flag, nflag, phase, st)
  POLS_MOVING_DISPATCH(K, rolling != 0, POLS_RUN_ALL, POLS_RUN_SHARED)
#undef POLS_RUN_ALL
#undef POLS_RUN_SHARED
}

// The systems of the F listed rows (fg[f], ft[f]) of the same problem, from
// the stretch start states a pols_moving call left in sseed: row f walks
// from row fa[f] of its group and the state sseed[fseed[f]]. A_out
// [F, K, K] with the regularisation on its diagonal, rhs_out [F, K]; mean0
// as above.
int pols_moving_moments_at(const double* Z, const uint8_t* v, const int32_t* leaving, int64_t G,
                           int64_t R, int K, int rolling, double ff, double reg0,
                           const double* mean0, const double* sseed, const int64_t* fg,
                           const int64_t* ft, const int64_t* fa, const int64_t* fseed, int64_t F,
                           double* A_out, double* rhs_out, void* stream) {
  const Problem p{Z, v, nullptr, nullptr, leaving, nullptr, G, R, 1, 0, K, 1, ff, reg0};
  if (!valid_sizes(G, R, K, 1) || F < 0 || F > INT_MAX || mean0 == nullptr ||
      (rolling != 0) != (leaving != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define POLS_RUN_AT(KB, ROLL) \
  run_moments_at<KB, ROLL>(p, mean0, sseed, fg, ft, fa, fseed, F, A_out, rhs_out, st)
#define POLS_RUN_AT_SHARED(ROLL) \
  run_moments_at_shared<ROLL>(p, mean0, sseed, fg, ft, fa, fseed, F, A_out, rhs_out, st)
  POLS_MOVING_DISPATCH(K, rolling != 0, POLS_RUN_AT, POLS_RUN_AT_SHARED)
#undef POLS_RUN_AT
#undef POLS_RUN_AT_SHARED
}

// Walkers of the walk an SM holds at K features, stretches of 32 T rows and
// coefficients (else predictions) into *walkers: warps in the register form
// (K <= 8), blocks in the shared form; the CUDA error code.
int pols_moving_resident_warps(int K, int rolling, int T, int coefs, int* walkers) {
  if (!valid_sizes(0, 0, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  const int ow = coefs != 0 ? K : 1;
#define POLS_RUN_OCC(KB, ROLL) run_occupancy<KB, ROLL>(K, T, ow, walkers)
#define POLS_RUN_OCC_SHARED(ROLL) run_occupancy_shared<ROLL>(K, T, walkers)
  POLS_MOVING_DISPATCH(K, rolling != 0, POLS_RUN_OCC, POLS_RUN_OCC_SHARED)
#undef POLS_RUN_OCC
#undef POLS_RUN_OCC_SHARED
}

// The shared form's layout at K features and stretches of 32 T rows: the
// device-memory workspace a walker needs (doubles, 0 where its state sits
// in shared memory, and always 0 at K <= 8) into *doubles, the rows of a
// piece that its stages hold into *rows and the threads of a walker into
// *threads; -1 where no layout fits, else 0.
int pols_moving_shared_layout(int K, int rolling, int T, int64_t* doubles, int* rows, int* threads) {
  if (!valid_sizes(0, 0, K, T)) return -1;
  if (K <= kRegisterMaxK) {
    *doubles = 0;
    *rows = kWarp * T;
    *threads = kWarp;
    return 0;
  }
  const SharedLayout lay = shared_layout_for(K, T, rolling != 0);
  if (lay.rows < 1) return -1;
  *doubles = work_doubles(K, lay);
  *rows = lay.rows;
  *threads = lay.warps * kWarp;
  return 0;
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
