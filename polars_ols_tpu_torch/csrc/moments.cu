// Grouped f64 moments over the split-padded block layout (CUDA C++, sm_90a).
//
// For each group g: M[g] = Z^T diag(w) Z summed over the group's row blocks,
// and counts[g] = number of valid rows, where Z = [y | X] is a block's
// [R, C] slice of Zp (target in column 0) and w its bool row mask. Blocks of
// one group are contiguous; offsets[g] .. offsets[g+1]-1 are its blocks.
//
// Replaces the TPU kernel polars_ols_tpu/ops/pallas_moments.py:
// _moment_kernel / digit_pair_moments_pallas (with the f64 rescale and
// segment sum of moments_from_digits_pallas). That kernel splits every f64
// value into int8 digit planes because the TPU has no f64 unit; the H100
// has one, so this kernel forms the exact f64 products directly.
//
// What bounds it: device-memory bytes. It reads S*R*(8C+1) bytes for
// S*R*C(C+1) flops: at the main path's S = 20,000, R = 512, C = 6 that is
// 0.50 GB, 0.151 ms at 3.35 TB/s, against ~10 us at the card's f64 rate.
// Reading at that rate takes ~25 KB in flight on every SM at all times
// (3.35 TB/s x ~1 us of latency / 132 SMs), with the arithmetic hidden
// under the copies. The design:
//
// - Persistent warps. The grid is what the occupancy calculator fits on
//   the card (a few 4-warp CTAs per SM). Each warp owns whole row blocks,
//   s = its index in the grid, s += the grid's warps, so a block's sum
//   never crosses warps: no CTA barrier and no cross-warp reduction.
// - A ring of kStages shared-memory stages per warp, each holding one chunk
//   of the current block (~6-8 KB of Zp rows and their mask bytes). Lane 0
//   fills a stage with bulk copies (the TMA's 1-D form) completed on the
//   stage's mbarrier and refills it as soon as the warp has read it, so
//   kStages - 1 chunks stay in flight while the warp computes on the one
//   that arrived: ~150 KB an SM at the main path's shape. No thread spends
//   registers or instructions on the copies' addresses.
// - Bulk copies take 16-byte aligned addresses and sizes. A chunk whose Zp
//   rows or mask bytes do not start or end on a 16-byte boundary (R*C odd,
//   R % 16 != 0, a view at an odd offset) is copied rounded out to the
//   16-byte words that hold it, and lands in its stage at the same offset
//   from a boundary as in device memory. The few bytes read beyond it lie
//   in those same words, so on the pages that hold the tensor, and are
//   never used. Every chunk thus comes whole by bulk copy, and the
//   arithmetic reads shared memory only.
// - C <= 8 (the main path's C = 6): lanes own rows. Each lane keeps all
//   C(C+1)/2 upper-triangle sums and its count in registers (a template per
//   C, so the loops unroll) and reads its rows from shared memory. The mask
//   selects a row and does not multiply it, so a NaN in a masked row does
//   not leak. At the end of a block one xor-shuffle tree, a fixed order,
//   gives every lane the block's sums.
// - 9 <= C <= 13: lanes own entries (up to 3 each, a template per bucket)
//   and the warp walks the rows together, four at a time so that their
//   loads overlap; each lane sums its entries' products over the valid rows
//   in row order, so nothing is reduced.
// - 14 <= C <= 33: the same, but each lane owns a tile of the C x C square
//   (a 4 x 8 grid of tiles of up to 9 x 5), so that a row costs it 14
//   shared loads for 45 products instead of two loads a product; it keeps
//   the tile's entries on and above the diagonal. Shared-memory loads, not
//   bytes, bound the short blocks of wide C (R = 37, C = 33). Tiles waste
//   the products below the diagonal, so at small C entries are faster.
//   Above C = 8 chunks are smaller (~2 KB), so that more warps share an SM.
//
// - C > 33 (K > 32 features): the wide form, block_moments_wide. The forms
//   above keep a tile of the C x C square in each lane's registers and
//   already take 168 registers at C = 33, so they cannot grow. Here a CTA
//   computes one T x T tile (ti <= tj) of the upper triangle over one row
//   block, T = 8 MT picked from C so that the tiles cover C with little to
//   spare: the fewest tiles of at most 32 columns, n = ceil(C / 32), each
//   ceil(C / n) columns rounded up to 8 (C = 41 / 43: two tiles of 24, 3
//   tile pairs and 1,728 products a row where 32 x 32 tiles take 3,072; C
//   = 101: four of 32). Where the tiles are many (at least 4 an SM) the CTA
//   is one part of 64 threads and stages 32 rows at a time; where they are
//   few (one group of 10,000 rows: 20 blocks), four parts of 64 take turns
//   at the block's stages of 16 rows (part p the stages p, p + 4, ...),
//   four times the warps a tile. A part stages its rows of the tile's two
//   T-column slabs in shared memory by plain coalesced loads (the mask
//   selects a row there, as a zero row: it is never multiplied, so a NaN in
//   a masked row stays out), and each of its threads sums an MT x MT
//   micro-tile, rows i = ty + 8a and columns j = tx + 8b, so that a warp's
//   loads of a row are 4 broadcast addresses and 8 consecutive doubles (no
//   bank conflicts): 2 MT shared loads for MT^2 multiply-adds a row. At the
//   end part 0 adds the other parts' sums in part order (through shared
//   memory). The tile that holds entry (0, 0) also counts the block's
//   valid rows (__syncthreads_count). No bulk copies, so none of the
//   16-byte rules above apply to it. Work items (block, tile) go
//   block-major over a grid-stride loop, so consecutive CTAs read one
//   block's rows and the block's other tiles find them in L2. What bounds
//   it: a row costs 8C + 1 bytes and C(C + 1) operations, so operations
//   over the tensor cores' 67 TFLOP/s pass bytes over 3.35 TB/s near C =
//   160 (at C = 41-101 bytes bound it); tiles read a block's row up to
//   tiles times (from L2), and a diagonal or ragged tile computes entries
//   it drops. The FP64 tensor-core product (DMMA) is the later redesign.
//
// Two passes, no atomics, so results are identical run to run:
//   1. block_moments / block_moments_wide: the block partials [S, C(C+1)/2
//      + 1] as above.
//   2. group_sums: one thread per (group, entry) adds its group's block
//      partials in block order and writes both triangles of M (zeros for a
//      group without blocks).
// Supports 1 <= C <= kMaxWideCols (entry indices are 32-bit): C <= 33 takes
// the register forms, larger C the wide form.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
// Zp bytes a stage holds, about: for C <= 8, and for larger C
constexpr int kRowChunkBytes = 8192;
constexpr int kEntryChunkBytes = 2048;
constexpr int kMaxCols = 33;
// the wide form: a tile of 8 MT x 8 MT (MT = 3 or 4) a CTA of P parts of
// 64 threads (P = 4 where the tiles are fewer than kFewTilesPerSm an SM,
// else 1), a part's stage 32 rows at P = 1 and 16 at P = 4; C(C + 1) / 2 +
// 1 entries must fit an int
constexpr int kWidePart = 64;
constexpr int kFewTilesPerSm = 4;
constexpr int64_t kMaxWideCols = 65534;
// CTAs an SM must hold: caps the registers at 168 a thread, so that the
// tiles of wide C fit three CTAs an SM
constexpr int kMinBlocks = 3;
constexpr int kBarBytes = kWarps * kStages * 8;  // one mbarrier per stage
constexpr unsigned kFull = 0xffffffffu;

// Upper-triangle entry e -> (i, j), i <= j, row-major.
__device__ __forceinline__ void entry_ij(int e, int C, int* i, int* j) {
  int r = 0;
  while (r < C && e >= C - r) {
    e -= C - r;
    ++r;
  }
  *i = r;
  *j = r + e;
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

// One chunk of a row block: its rows in device memory and where they land
// in a stage. Every lane computes the same from the chunk's first row.
struct Chunk {
  const double* z;  // the chunk's Zp rows
  const uint8_t* m;  // their mask bytes
  int rows;
  int z_shift;  // bytes from a 16-byte boundary to z: double 0's offset in the stage
  int m_shift;  // the same for m and mask byte 0 in the stage's mask area
};

__device__ __forceinline__ Chunk chunk_at(const double* zp, const uint8_t* wp,
                                          int64_t row0, int rows, int C) {
  Chunk k;
  k.z = zp + row0 * C;
  k.m = wp + row0;
  k.rows = rows;
  k.z_shift = static_cast<int>(reinterpret_cast<uintptr_t>(k.z) & 15);  // 0 or 8
  k.m_shift = static_cast<int>(reinterpret_cast<uintptr_t>(k.m) & 15);
  return k;
}

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Lane 0: arm the stage's barrier with the chunk's bytes, rounded out to
// 16-byte words, and start the two bulk copies.
__device__ __forceinline__ void issue(const Chunk& k, int C, uint32_t stage,
                                      int z_bytes, uint32_t bar) {
  const uint32_t zb = static_cast<uint32_t>(round16(k.z_shift + 8 * k.rows * C));
  const uint32_t mb = static_cast<uint32_t>(round16(k.m_shift + k.rows));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(zb + mb) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(stage), "l"(reinterpret_cast<const uint8_t*>(k.z) - k.z_shift), "r"(zb),
         "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(stage + z_bytes), "l"(k.m - k.m_shift), "r"(mb), "r"(bar)
      : "memory");
}

// C <= 8: lane l sums rows l, l + 32, ... of every chunk of its block.
template <int C>
struct RowSums {
  static constexpr int kEntries = C * (C + 1) / 2;
  double acc[kEntries];
  int cnt;

  __device__ __forceinline__ RowSums(int, int) : cnt(0) {
#pragma unroll
    for (int e = 0; e < kEntries; ++e) acc[e] = 0.0;
  }

  __device__ __forceinline__ void row(const double (&v)[C], bool ok) {
    cnt += ok ? 1 : 0;
    double x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = ok ? v[c] : 0.0;
    int e = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = i; j < C; ++j) {
        acc[e] = fma(x[i], x[j], acc[e]);
        ++e;
      }
    }
  }

  __device__ __forceinline__ void add(const double* zs, const uint8_t* ms,
                                      int rows, int lane) {
    for (int r = lane; r < rows; r += 32) {
      double v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = zs[r * C + c];
      row(v, ms[r] != 0);
    }
  }

  // the block's sums into out[0 .. kEntries] (count last), then zero
  __device__ __forceinline__ void flush(double* out, int lane) {
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      double v = acc[e];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (lane == e % 32) out[e] = v;
      acc[e] = 0.0;
    }
    const int n = __reduce_add_sync(kFull, cnt);
    if (lane == kEntries % 32) out[kEntries] = static_cast<double>(n);
    cnt = 0;
  }
};

// 9 <= C <= 13: lane l owns entries l, l + 32, ... (at most KPL) and sums
// their products over every valid row of the block in row order.
template <int KPL>
struct EntrySums {
  double acc[KPL];
  int ij[KPL];  // i << 8 | j of each owned entry
  int C, entries, cnt;

  __device__ __forceinline__ EntrySums(int lane, int C_)
      : C(C_), entries(C_ * (C_ + 1) / 2), cnt(0) {
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      int i = 0, j = 0;
      if (lane + 32 * k < entries) entry_ij(lane + 32 * k, C, &i, &j);
      ij[k] = i << 8 | j;
      acc[k] = 0.0;
    }
  }

  // rows r .. r + U - 1 in order; a masked row's products are formed and
  // dropped by a select, so its values never reach a sum
  template <int U>
  __device__ __forceinline__ void rows_at(const double* zs, const uint8_t* ms,
                                          int r, int lane) {
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = ms[r + u] != 0;
      cnt += ok[u] ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      if (lane + 32 * k < entries) {
        const double* vi = zs + r * C + (ij[k] >> 8);
        const double* vj = zs + r * C + (ij[k] & 255);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const double f = fma(vi[u * C], vj[u * C], acc[k]);
          acc[k] = ok[u] ? f : acc[k];
        }
      }
    }
  }

  __device__ __forceinline__ void add(const double* zs, const uint8_t* ms,
                                      int rows, int lane) {
    int r = 0;
    for (; r + 4 <= rows; r += 4) rows_at<4>(zs, ms, r, lane);
    for (; r < rows; ++r) rows_at<1>(zs, ms, r, lane);
  }

  __device__ __forceinline__ void flush(double* out, int lane) {
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      if (lane + 32 * k < entries) out[lane + 32 * k] = acc[k];
      acc[k] = 0.0;
    }
    if (lane == 0) out[entries] = static_cast<double>(cnt);
    cnt = 0;
  }
};

// 14 <= C <= 33: the C x C square in a 4 x 8 grid of A x B tiles, one a
// lane. Each lane sums its tile's products over the valid rows in row order
// from A + B values a row, and writes the tile's entries with i <= j.
template <int A, int B>
struct TileSums {
  double acc[A][B];
  int i0, j0, C, cnt;

  __device__ __forceinline__ TileSums(int lane, int C_)
      : i0(lane / 8 * A), j0(lane % 8 * B), C(C_), cnt(0) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int b = 0; b < B; ++b) acc[a][b] = 0.0;
    }
  }

  __device__ __forceinline__ void add(const double* zs, const uint8_t* ms,
                                      int rows, int) {
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const bool ok = ms[r] != 0;  // the row is selected, not multiplied
      cnt += ok ? 1 : 0;
      const double* v = zs + r * C;
      double x[A], y[B];
#pragma unroll
      for (int a = 0; a < A; ++a) x[a] = (ok && i0 + a < C) ? v[i0 + a] : 0.0;
#pragma unroll
      for (int b = 0; b < B; ++b) y[b] = (ok && j0 + b < C) ? v[j0 + b] : 0.0;
#pragma unroll
      for (int a = 0; a < A; ++a) {
#pragma unroll
        for (int b = 0; b < B; ++b) acc[a][b] = fma(x[a], y[b], acc[a][b]);
      }
    }
  }

  __device__ __forceinline__ void flush(double* out, int lane) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int i = i0 + a;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int j = j0 + b;
        // entry (i, j) of the row-major upper triangle
        if (i <= j && j < C) out[i * C - i * (i - 1) / 2 + (j - i)] = acc[a][b];
        acc[a][b] = 0.0;
      }
    }
    if (lane == 0) out[C * (C + 1) / 2] = static_cast<double>(cnt);
    cnt = 0;
  }
};

template <class Sums>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_moments(const double* __restrict__ zp, const uint8_t* __restrict__ wp,
              int64_t S, int64_t R, int C, int chunk_rows, int stage_bytes,
              int z_bytes, int slots, double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  if (first >= S) return;  // the whole warp leaves together
  const int64_t nch = (R + chunk_rows - 1) / chunk_rows;
  const int64_t total = (S - first + stride - 1) / stride * nch;
  const uint32_t bars = shared_addr(smem) + 8u * kStages * warp;
  unsigned char* ring = smem + kBarBytes + static_cast<int64_t>(kStages) * stage_bytes * warp;
  const uint32_t ring_addr = shared_addr(ring);

  // work item q: chunk q % nch of the warp's (q / nch)-th block
  auto chunk = [&](int64_t q) {
    const int64_t s = first + q / nch * stride;
    const int64_t r0 = q % nch * chunk_rows;
    const int rows = static_cast<int>(R - r0 < chunk_rows ? R - r0 : chunk_rows);
    return chunk_at(zp, wp, s * R + r0, rows, C);
  };

  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8u * st) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int64_t q = 0; q < kStages && q < total; ++q) {
      issue(chunk(q), C, ring_addr + static_cast<uint32_t>(q * stage_bytes), z_bytes,
            bars + 8u * static_cast<uint32_t>(q));
    }
  }
  __syncwarp();

  Sums sums(lane, C);
  for (int64_t q = 0; q < total; ++q) {
    const int st = static_cast<int>(q % kStages);
    const uint32_t bar = bars + 8u * st;
    wait_parity(bar, static_cast<uint32_t>(q / kStages) & 1u);
    const Chunk k = chunk(q);
    const unsigned char* stage = ring + static_cast<int64_t>(st) * stage_bytes;
    sums.add(reinterpret_cast<const double*>(stage + k.z_shift),
             stage + z_bytes + k.m_shift, k.rows, lane);
    __syncwarp();  // every lane has read the stage before it is refilled
    if (lane == 0 && q + kStages < total) {
      issue(chunk(q + kStages), C, ring_addr + static_cast<uint32_t>(st * stage_bytes),
            z_bytes, bar);
    }
    if (q % nch == nch - 1) sums.flush(partial + (first + q / nch * stride) * slots, lane);
  }
}

// C > 33: work item q = (block q / n_tiles, tile q % n_tiles of the upper
// triangle of tiles x tiles), a tile 8 MT columns wide. Part p of the CTA's
// P takes the stages p, p + P, ... of the block's rows; its thread (ty, tx)
// = (t / 8, t % 8) sums the tile's entries (ty + 8a, tx + 8b), a, b < MT,
// over its rows in row order, and part 0 adds the other parts' sums in
// part order.
template <int MT, int P>
__global__ void __launch_bounds__(kWidePart * P)
block_moments_wide(const double* __restrict__ zp, const uint8_t* __restrict__ wp,
                   int64_t S, int64_t R, int C, int tiles, int slots,
                   double* __restrict__ partial) {
  constexpr int T = 8 * MT;
  constexpr int Rows = P == 1 ? 32 : 16;  // a part's stage
  // the parts' stages: the tile's two slabs (sa, sb); the parts' sums
  // reuse them at the end
  __shared__ double stage[2][P][Rows][T];
  static_assert((P - 1) * kWidePart * MT * MT <= 2 * P * Rows * T, "the parts' sums fit the stages");
  auto& sa = stage[0];
  auto& sb = stage[1];
  double* sums = &stage[0][0][0][0];
  const int tid = static_cast<int>(threadIdx.x);
  const int part = tid / kWidePart, t = tid % kWidePart;
  const int tx = t % 8, ty = t / 8;
  const int64_t n_tiles = static_cast<int64_t>(tiles) * (tiles + 1) / 2;
  for (int64_t q = blockIdx.x; q < S * n_tiles; q += gridDim.x) {
    const int64_t s = q / n_tiles;
    int ti, tj;
    entry_ij(static_cast<int>(q - s * n_tiles), tiles, &ti, &tj);
    const int i0 = ti * T, j0 = tj * T;
    const double* zb = zp + s * R * C;
    const uint8_t* mb = wp + s * R;
    double acc[MT][MT];
#pragma unroll
    for (int a = 0; a < MT; ++a) {
#pragma unroll
      for (int b = 0; b < MT; ++b) acc[a][b] = 0.0;
    }
    int cnt = 0;
    for (int64_t r00 = 0; r00 < R; r00 += P * Rows) {
      const int64_t r0 = r00 + part * Rows;
      const int rows = static_cast<int>(R - r0 < 0 ? 0 : (R - r0 < Rows ? R - r0 : Rows));
      for (int e = t; e < Rows * T; e += kWidePart) {
        const int r = e / T, c = e % T;
        const bool ok = r < rows && mb[r0 + r] != 0;  // selected, not multiplied
        const double* row = zb + (r0 + r) * C;
        sa[part][r][c] = ok && i0 + c < C ? row[i0 + c] : 0.0;
        sb[part][r][c] = ok && j0 + c < C ? row[j0 + c] : 0.0;
      }
      // the barrier that publishes the stages counts their valid rows
      cnt += __syncthreads_count(t < rows && mb[r0 + t] != 0);
      for (int r = 0; r < rows; ++r) {
        double x[MT], y[MT];
#pragma unroll
        for (int a = 0; a < MT; ++a) x[a] = sa[part][r][ty + 8 * a];
#pragma unroll
        for (int b = 0; b < MT; ++b) y[b] = sb[part][r][tx + 8 * b];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
#pragma unroll
          for (int b = 0; b < MT; ++b) acc[a][b] = fma(x[a], y[b], acc[a][b]);
        }
      }
      __syncthreads();  // the stages are read before the next ones land
    }
    if (P > 1 && part > 0) {
#pragma unroll
      for (int a = 0; a < MT; ++a) {
#pragma unroll
        for (int b = 0; b < MT; ++b) sums[((part - 1) * MT * MT + a * MT + b) * kWidePart + t] = acc[a][b];
      }
    }
    if (P > 1) __syncthreads();
    if (part == 0) {
      double* out = partial + s * slots;
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        const int i = i0 + ty + 8 * a;
#pragma unroll
        for (int b = 0; b < MT; ++b) {
          const int j = j0 + tx + 8 * b;
          double v = acc[a][b];
          for (int k = 1; k < P; ++k) v += sums[((k - 1) * MT * MT + a * MT + b) * kWidePart + t];
          if (i <= j && j < C) out[static_cast<int64_t>(i) * C - static_cast<int64_t>(i) * (i - 1) / 2 + (j - i)] = v;
        }
      }
      if (ti == 0 && tj == 0 && t == 0) out[slots - 1] = static_cast<double>(cnt);
    }
    if (P > 1) __syncthreads();  // the sums are read before the next item's stages land
  }
}

__global__ void __launch_bounds__(256)
group_sums(const double* __restrict__ partial,
           const int64_t* __restrict__ offsets, int64_t G, int C, int slots,
           double* __restrict__ M, double* __restrict__ counts) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= G * slots) return;
  const int64_t g = idx / slots;
  const int e = static_cast<int>(idx - g * slots);
  double sum = 0.0;
  for (int64_t b = offsets[g]; b < offsets[g + 1]; ++b) {
    sum += partial[b * slots + e];
  }
  if (e == slots - 1) {
    counts[g] = sum;
    return;
  }
  int i, j;
  entry_ij(e, C, &i, &j);
  double* Mg = M + g * C * C;
  Mg[static_cast<int64_t>(i) * C + j] = sum;
  Mg[static_cast<int64_t>(j) * C + i] = sum;
}

using MomentKernel = void (*)(const double*, const uint8_t*, int64_t, int64_t, int,
                              int, int, int, int, double*);

// C <= 8: lanes own rows; up to 13: lanes own entries; above: tiles
MomentKernel pick(int C) {
  switch (C) {
    case 1: return block_moments<RowSums<1>>;
    case 2: return block_moments<RowSums<2>>;
    case 3: return block_moments<RowSums<3>>;
    case 4: return block_moments<RowSums<4>>;
    case 5: return block_moments<RowSums<5>>;
    case 6: return block_moments<RowSums<6>>;
    case 7: return block_moments<RowSums<7>>;
    case 8: return block_moments<RowSums<8>>;
    default: break;
  }
  if (C <= 10) return block_moments<EntrySums<2>>;  // 45 and 55 entries
  if (C <= 13) return block_moments<EntrySums<3>>;  // up to 91
  if (C <= 16) return block_moments<TileSums<4, 2>>;
  if (C <= 24) return block_moments<TileSums<6, 3>>;
  return block_moments<TileSums<9, 5>>;
}

// Rows of a chunk: about kRowChunkBytes of Zp (at least 32 rows) for
// C <= 8, kEntryChunkBytes (at least 16) above; the block cut into equal
// chunks, rounded up to 16 rows so that a chunk's mask bytes keep the
// block's 16-byte alignment.
int chunk_rows_for(int64_t R, int C) {
  const bool by_rows = C <= 8;
  int64_t target = (by_rows ? kRowChunkBytes : kEntryChunkBytes) / (8 * C);
  const int64_t least = by_rows ? 32 : 16;
  if (target < least) target = least;
  const int64_t n = (R + target - 1) / target;
  const int64_t rows = (R + n - 1) / n;
  return static_cast<int>((rows + 15) & ~int64_t{15});
}

}  // namespace

extern "C" {

// Per-group moments M [G, C, C] and counts [G] of the blocks Zp [S, R, C]
// (contiguous f64), wp [S, R] (bool bytes) and CSR block offsets [G+1]
// (int64). `partial` is caller-allocated scratch of S * (C(C+1)/2 + 1)
// doubles. C <= 33 takes the register forms, 33 < C <= 65,534 the wide
// form. Launches on `stream` without synchronising; returns the CUDA error
// code of the launches (0 on success).
int pols_grouped_moments(const double* zp, const uint8_t* wp,
                         const int64_t* offsets, int64_t S, int64_t R,
                         int64_t C, int64_t G, double* partial, double* M,
                         double* counts, void* stream) {
  if (C < 1 || C > kMaxWideCols || S < 0 || S > INT32_MAX || R < 1 || G < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(C);
  const int slots = static_cast<int>(C * (C + 1) / 2 + 1);
  if (S > 0 && C > kMaxCols) {
    // the fewest tiles of at most 32 columns, each a multiple of 8 wide
    const int64_t n = (C + 31) / 32;
    const int mt = static_cast<int>((C + 8 * n - 1) / (8 * n));
    const int tiles = static_cast<int>((C + 8 * mt - 1) / (8 * mt));
    const int64_t items = S * (static_cast<int64_t>(tiles) * (tiles + 1) / 2);
    const int64_t cap = int64_t{1} << 20;  // the grid-stride loop takes the rest
    const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool few = items < static_cast<int64_t>(kFewTilesPerSm) * sms;
    auto kernel = mt == 3 ? (few ? block_moments_wide<3, 4> : block_moments_wide<3, 1>)
                          : (few ? block_moments_wide<4, 4> : block_moments_wide<4, 1>);
    kernel<<<grid, kWidePart * (few ? 4 : 1), 0, st>>>(zp, wp, S, R, c, tiles, slots, partial);
  } else if (S > 0) {
    const int rows = chunk_rows_for(R, c);
    // room for a chunk's bytes rounded out to 16-byte words
    const int z_bytes = round16(rows * c * 8 + 8);
    const int stage_bytes = z_bytes + round16(rows + 15);
    const size_t smem = kBarBytes + static_cast<size_t>(kWarps) * kStages * stage_bytes;
    const MomentKernel fn = pick(c);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t want = (S + kWarps - 1) / kWarps;
    const int64_t fit = static_cast<int64_t>(per_sm) * sms;
    fn<<<static_cast<unsigned>(want < fit ? want : fit), kThreads, smem, st>>>(
        zp, wp, S, R, c, rows, stage_bytes, z_bytes, slots, partial);
  }
  if (G > 0) {
    const int64_t n = G * static_cast<int64_t>(slots);
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    group_sums<<<blocks, 256, 0, st>>>(partial, offsets, G, c, slots, M, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
