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
// - C > 33 (K > 32 features): the wide form. The forms above keep a tile
//   of the C x C square in each lane's registers and already take 168
//   registers at C = 33, so they cannot grow. Here the products go to the
//   FP64 tensor cores: mma.sync.aligned.m8n8k4.row.col.f64 (DMMA) adds an
//   8 x 4 by 4 x 8 product to an 8 x 8 tile held as two doubles a lane.
//   For a tile (ti, tj) of Z^T Z and four rows r_0..r_3, A(i, k) =
//   Z[r_k, 8 ti + i] and B(k, j) = Z[r_k, 8 tj + j]: lane l holds A(l / 4,
//   l % 4) and B(l % 4, l / 4), i.e. Z[r_{l % 4}, 8 t + l / 4] for t = ti and
//   tj, the same load for either role. So a lane loads one double a column
//   tile and k-step and feeds every tile pair from them; only tiles on or
//   above the diagonal are accumulated. A masked row is selected as zeros
//   (never multiplied, so a NaN in a masked slot stays out), as are the
//   columns past C and the rows past a ragged end.
//   * 34 <= C <= 128, the staged form (block_moments_wide): the square's
//     8-column tiles are grouped in panels (one panel of all ceil(C / 8)
//     <= 6 tiles up to C = 48; panels of 4 tiles above), and a CTA has one
//     warp for each pair of panels (pi <= pj; 1 warp at C <= 48, 3 / 6 / 10
//     up to C = 64 / 96 / 128), so that one CTA covers the whole
//     triangle and reads each row once. Its rows arrive as the register
//     forms' do: 16-row chunks by bulk copy on a ring of four stages and
//     their mbarriers (the same 16-byte rules), thread 0 refilling a stage
//     once every warp has passed the barrier after it. A stage keeps the
//     rows' stride of C doubles, so the k-step's four rows are picked to
//     keep the 8-byte loads off each other's banks: rows r + 4k for odd C,
//     r + 2k for C = 2 mod 4, r + k for C = 4 mod 8 (their starts then lie
//     4 banks apart; C = 0 mod 8 keeps 2- or 4-way conflicts). A work item
//     is a block, or where the blocks are fewer than half the SMs a piece
//     of one (rows_a_piece, chosen by the wrapper: a multiple of 16 rows),
//     so that a single group of 20 blocks still fills the card; each piece
//     writes its own partial. Warp 0 counts the valid rows.
//   * C > 128, the direct form (block_moments_direct): the pairs of 4-tile
//     panels are too many for a CTA, so each warp takes one (block, pair)
//     and loads its fragments straight from device memory (eight lanes read
//     64 contiguous bytes of one row), the block's rows read again from L2
//     by each pair; no stage, so no row width is too large. Pair 0 counts.
//   What bounds it: a row costs 8C + 1 bytes and C(C + 1) operations, so at
//   the tensor cores' 67 TFLOP/s bytes bound it up to C ~ 160 (B: S = 1,280
//   blocks of 512 x 41, 0.23 GB) and operations beyond; a diagonal or
//   ragged tile computes entries it drops (21 tiles at C = 41 for 861
//   entries).
//
// Two passes, no atomics, so results are identical run to run:
//   1. block_moments / block_moments_wide / block_moments_direct: the
//      partials [S pieces, C(C+1)/2 + 1], a block's pieces consecutive
//      (one piece a block but in the staged form's row split).
//   2. group_sums (C <= 33): one thread per (group, entry) adds its group's
//      block partials in block order and writes both triangles of M (zeros
//      for a group without blocks). Above, the partials of each entry are
//      added in block and piece order and both triangles of M get the same
//      bits: group_sums_tile (C <= 64) a CTA a group through shared memory;
//      group_sums_wide one thread per (i, j) of M and group, and where the
//      groups have 32 partials or more on average (the row split of few
//      blocks) eight runs of them in parallel, the runs' sums added in run
//      order.
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
// the wide form: 8 x 8 DMMA tiles; up to kOnePanelCols one panel of at most
// 6 tiles and one warp, up to kStagedMaxCols panels of kPanel tiles, a warp
// a pair of them (at most 10); stages of kWideChunk rows, kWideStages of
// them; C(C + 1) / 2 + 1 entries must fit an int
constexpr int kOnePanelCols = 48;
constexpr int kStagedMaxCols = 128;
constexpr int kPanel = 4;
constexpr int kWideChunk = 16;
constexpr int kWideStages = 4;
constexpr int kWideMaxWarps = 10;
// one-warp CTAs an SM must hold (registers capped at 204 a thread): as many
// as its shared memory holds, so that "grouped_largek"'s 1,280 blocks are
// all resident at once
constexpr int kOneWarpCtas = 10;
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

// acc (d0, d1) += A B of one m8n8k4 f64 step (the fragments above)
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// rows between a k-step's four rows in a stage of stride C: their 8-byte
// loads then start 4 banks apart (see the header)
__host__ __device__ __forceinline__ int row_step(int C) {
  return (C & 1) != 0 ? 4 : ((C & 3) == 2 ? 2 : 1);
}

// The tiles of one warp: panels pi <= pj of P tiles each (ni, nj of them
// inside the square), accumulated over rows.
template <int P>
struct PanelPair {
  double acc[P][P][2];
  int ti0, tj0, ni, nj;
  bool diag;

  __device__ __forceinline__ PanelPair(int pi, int pj, int nt) {
    ti0 = pi * P;
    tj0 = pj * P;
    ni = nt - ti0 < P ? nt - ti0 : P;
    nj = nt - tj0 < P ? nt - tj0 : P;
    diag = pi == pj;
#pragma unroll
    for (int a = 0; a < P; ++a) {
#pragma unroll
      for (int b = 0; b < P; ++b) acc[a][b][0] = acc[a][b][1] = 0.0;
    }
  }

  // one k-step: zr points at column l / 4 of the lane's row, which is
  // selected where ok (else zeros)
  template <bool kDiagOnly>
  __device__ __forceinline__ void step(const double* zr, bool ok, int lane, int C) {
    double fa[P], fb[P];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int ca = (ti0 + t) * 8, cb = (tj0 + t) * 8;
      fa[t] = ok && ca + lane / 4 < C ? zr[ca] : 0.0;
      if (!kDiagOnly) fb[t] = ok && cb + lane / 4 < C ? zr[cb] : 0.0;
    }
    if (kDiagOnly) {
      // every tile on or above the diagonal, with no branch before an mma
      // (a tile past C multiplies zeros): the warp stays converged, so the
      // compiler puts no warp barrier before each
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int b = a; b < P; ++b) dmma(acc[a][b][0], acc[a][b][1], fa[a], fa[b]);
      }
    } else if (diag) {
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int b = a; b < P; ++b) {
          if (b < ni) dmma(acc[a][b][0], acc[a][b][1], fa[a], fa[b]);
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < P; ++a) {
#pragma unroll
        for (int b = 0; b < P; ++b) {
          if (a < ni && b < nj) dmma(acc[a][b][0], acc[a][b][1], fa[a], fb[b]);
        }
      }
    }
  }

  // the tiles' entries with i <= j < C into out (row-major upper triangle)
  __device__ __forceinline__ void write(double* __restrict__ out, int lane, int64_t C) const {
#pragma unroll
    for (int a = 0; a < P; ++a) {
      const int64_t i = (ti0 + a) * 8 + lane / 4;
#pragma unroll
      for (int b = 0; b < P; ++b) {
        if (a >= ni || b >= nj || (diag && b < a)) continue;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int64_t j = (tj0 + b) * 8 + (lane % 4) * 2 + v;
          if (i <= j && j < C) out[i * C - i * (i - 1) / 2 + (j - i)] = acc[a][b][v];
        }
      }
    }
  }
};

// 34 <= C <= 128, the staged form: work item q = piece q % pieces of block
// q / pieces, rows [p piece_rows, (p + 1) piece_rows) of it, in chunks of
// kWideChunk rows on the CTA's ring of stages; warp w takes the w-th pair
// of panels (row-major over pi <= pj; the one panel where kOne).
template <int P, bool kOne>
__global__ void __launch_bounds__(kOne ? 32 : kWideMaxWarps * 32, kOne ? kOneWarpCtas : 1)
block_moments_wide(const double* __restrict__ zp, const uint8_t* __restrict__ wp, int64_t S, int64_t R,
                   int C, int piece_rows, int pieces, int stage_bytes, int z_bytes, int slots,
                   double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  const int nt = (C + 7) / 8;
  int pi = 0, pj = 0;
  if (!kOne) entry_ij(warp, (nt + P - 1) / P, &pi, &pj);
  const int d = row_step(C);
  const uint32_t bars = shared_addr(smem);
  unsigned char* ring = smem + 128;
  const uint32_t ring_addr = shared_addr(ring);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kWideStages; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8u * st) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t used = 0;  // chunks the CTA has taken from its ring: chunk u is in stage u % kWideStages
  for (int64_t q = blockIdx.x; q < S * pieces; q += gridDim.x) {
    const int64_t s = q / pieces;
    const int64_t r0 = (q - s * pieces) * piece_rows;
    const int n = static_cast<int>(R - r0 < piece_rows ? R - r0 : piece_rows);
    const int nch = (n + kWideChunk - 1) / kWideChunk;
    auto chunk = [&](int c) {
      const int rows = n - c * kWideChunk < kWideChunk ? n - c * kWideChunk : kWideChunk;
      return chunk_at(zp, wp, s * R + r0 + static_cast<int64_t>(c) * kWideChunk, rows, C);
    };
    if (threadIdx.x == 0) {
      for (int c = 0; c < kWideStages && c < nch; ++c) {
        const uint32_t st = (used + c) % kWideStages;
        issue(chunk(c), C, ring_addr + st * stage_bytes, z_bytes, bars + 8u * st);
      }
    }
    PanelPair<P> tiles(pi, pj, nt);
    int cnt = 0;
    for (int c = 0; c < nch; ++c, ++used) {
      const uint32_t st = used % kWideStages;
      wait_parity(bars + 8u * st, (used / kWideStages) & 1u);
      const Chunk k = chunk(c);
      const unsigned char* stage = ring + st * stage_bytes;
      const double* zs = reinterpret_cast<const double*>(stage + k.z_shift);
      const uint8_t* ms = stage + z_bytes + k.m_shift;
      cnt += warp == 0 && lane < k.rows && ms[lane] != 0 ? 1 : 0;  // a select, not a branch
#pragma unroll
      for (int j = 0; j < kWideChunk / 4; ++j) {
        const int row = j % d + j / d * 4 * d + d * (lane % 4);
        const bool ok = row < k.rows && ms[row] != 0;  // selected, not multiplied
        tiles.template step<kOne>(zs + row * C + lane / 4, ok, lane, C);
      }
      __syncthreads();  // every warp has read the stage
      if (threadIdx.x == 0 && c + kWideStages < nch) {
        issue(chunk(c + kWideStages), C, ring_addr + st * stage_bytes, z_bytes, bars + 8u * st);
      }
    }
    double* out = partial + q * slots;
    tiles.write(out, lane, C);
    if (warp == 0) {
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) out[slots - 1] = static_cast<double>(cnt);
    }
  }
}

// C > 128, the direct form: warp item q = pair q % np (of panels of P
// tiles) of block q / np, its fragments read from device memory.
template <int P>
__global__ void __launch_bounds__(kThreads)
block_moments_direct(const double* __restrict__ zp, const uint8_t* __restrict__ wp, int64_t S, int64_t R,
                     int C, int slots, double* __restrict__ partial) {
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  const int nt = (C + 7) / 8, npan = (nt + P - 1) / P;
  const int64_t np = static_cast<int64_t>(npan) * (npan + 1) / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kWarps + warp; q < S * np; q += stride) {
    const int64_t s = q / np;
    const int pair = static_cast<int>(q - s * np);
    int pi, pj;
    entry_ij(pair, npan, &pi, &pj);
    PanelPair<P> tiles(pi, pj, nt);
    const double* zb = zp + s * R * C;
    const uint8_t* mb = wp + s * R;
    int cnt = 0;
    for (int64_t r = 0; r < R; r += 4) {
      const int64_t row = r + lane % 4;
      const bool ok = row < R && mb[row] != 0;  // selected, not multiplied
      cnt += ok && lane < 4 ? 1 : 0;
      tiles.template step<false>(zb + row * C + lane / 4, ok, lane, C);
    }
    double* out = partial + s * slots;
    tiles.write(out, lane, C);
    if (pair == 0) {
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) out[slots - 1] = static_cast<double>(cnt);
    }
  }
}

// C <= 33: one thread per (group, entry) adds its group's block partials
// in block order and writes both triangles of M (zeros for a group without
// blocks).
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

// 33 < C <= kSumTileCols: a CTA a group (groups blockIdx.x, + gridDim.x,
// ...) adds its partials entry by entry, in block and piece order, into its
// triangle in shared memory, then writes both triangles of M row by row (so
// the stores coalesce) and the count.
constexpr int kSumTileCols = 64;

__global__ void __launch_bounds__(256)
group_sums_tile(const double* __restrict__ partial, const int64_t* __restrict__ offsets, int64_t G, int C,
                int slots, int pieces, double* __restrict__ M, double* __restrict__ counts) {
  extern __shared__ double tri[];  // slots doubles: the upper triangle row-major, then the count
  const int cc = C * C;
  for (int64_t g = blockIdx.x; g < G; g += gridDim.x) {
    const int64_t lo = offsets[g] * pieces, hi = offsets[g + 1] * pieces;
    for (int e = threadIdx.x; e < slots; e += blockDim.x) {
      double sum = 0.0;
      for (int64_t b = lo; b < hi; ++b) sum += partial[b * slots + e];
      tri[e] = sum;
    }
    __syncthreads();
    for (int ij = threadIdx.x; ij < cc; ij += blockDim.x) {
      const int i = ij / C, j = ij - i * C;
      const int a = i < j ? i : j, b = i < j ? j : i;
      M[g * cc + ij] = tri[a * C - a * (a - 1) / 2 + (b - a)];
    }
    if (threadIdx.x == 0) counts[g] = tri[slots - 1];
    __syncthreads();  // the triangle is read before the next group's sums
  }
}

// the partials of a group a wide group sum splits in kSumParts runs (the
// row split of few blocks gives a group many); below that, one run
constexpr int kSumParts = 8;
constexpr int kSumSplitAt = 32;

// C > 33: a block of 256 / kParts entries x kParts runs, over the groups
// blockIdx.y, + gridDim.y, ...; entry (i, j) of M, j fastest (so the stores
// coalesce), and the count last. Each run adds a contiguous run of the
// group's partials (block by block, a block's pieces in order), four loads
// in flight; the runs' sums are added in run order. One run: the partials
// in order, as group_sums does. C <= 65,534, so C^2 + 1 fits 32 bits.
template <int kParts>
__global__ void __launch_bounds__(256)
group_sums_wide(const double* __restrict__ partial, const int64_t* __restrict__ offsets, int64_t G, int C,
                int slots, int pieces, double* __restrict__ M, double* __restrict__ counts) {
  constexpr int kEntries = 256 / kParts;
  __shared__ double runs[kParts > 1 ? 256 : 1];
  const int lane_e = static_cast<int>(threadIdx.x) % kEntries, part = static_cast<int>(threadIdx.x) / kEntries;
  const uint32_t uc = static_cast<uint32_t>(C), cc = uc * uc;
  const uint32_t ij = blockIdx.x * kEntries + lane_e;
  const bool live = ij <= cc;
  int64_t e = slots - 1;  // ij == C^2: the count
  if (ij < cc) {
    const uint32_t i = ij / uc, j = ij - i * uc;
    const int64_t a = i < j ? i : j, b = i < j ? j : i;
    e = a * C - a * (a - 1) / 2 + (b - a);  // entry (a, b) of the row-major upper triangle
  }
  for (int64_t g = blockIdx.y; g < G; g += gridDim.y) {
    const int64_t lo = offsets[g] * pieces, hi = offsets[g + 1] * pieces;
    const int64_t per = (hi - lo + kParts - 1) / kParts;
    const int64_t b0 = lo + part * per, b1 = b0 + per < hi ? b0 + per : hi;
    double sum = 0.0;
    if (live) {
      for (int64_t b = b0; b < b1; b += 4) {
        double v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = partial[(b + u < b1 ? b + u : b1 - 1) * slots + e];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (b + u < b1) sum += v[u];
        }
      }
    }
    if (kParts > 1) {
      runs[threadIdx.x] = sum;
      __syncthreads();
      if (part == 0) {
        sum = 0.0;
#pragma unroll
        for (int w = 0; w < kParts; ++w) sum += runs[w * kEntries + lane_e];
      }
      __syncthreads();
    }
    if (live && part == 0) {
      if (ij == cc) {
        counts[g] = sum;
      } else {
        M[g * cc + ij] = sum;
      }
    }
  }
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
// (int64). A block is read in pieces of piece_rows rows, pieces =
// ceil(R / piece_rows) of them: piece_rows >= R (one piece) except in the
// wide form's staged path (34 <= C <= 128), where it may be a multiple of
// 16 below R. `partial` is caller-allocated scratch of S * pieces *
// (C(C+1)/2 + 1) doubles. C <= 33 takes the register forms, 33 < C <=
// 65,534 the wide form. Launches on `stream` without synchronising;
// returns the CUDA error code of the launches (0 on success).
int pols_grouped_moments(const double* zp, const uint8_t* wp,
                         const int64_t* offsets, int64_t S, int64_t R,
                         int64_t C, int64_t G, int64_t piece_rows, double* partial, double* M,
                         double* counts, void* stream) {
  if (C < 1 || C > kMaxWideCols || S < 0 || S > INT32_MAX || R < 1 || G < 0 || piece_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool staged = C > kMaxCols && C <= kStagedMaxCols;
  if (piece_rows < R && (!staged || piece_rows % kWideChunk != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pieces = piece_rows < R ? (R + piece_rows - 1) / piece_rows : 1;
  if (S * pieces > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(C);
  const int slots = static_cast<int>(C * (C + 1) / 2 + 1);
  const int64_t cap = int64_t{1} << 20;  // a larger grid: the grid-stride loops take the rest
  if (S > 0 && staged) {
    const bool one = C <= kOnePanelCols;
    const int nt = (c + 7) / 8, npan = one ? 1 : (nt + kPanel - 1) / kPanel;
    const int warps = npan * (npan + 1) / 2;
    // room for a chunk's bytes rounded out to 16-byte words
    const int z_bytes = round16(kWideChunk * c * 8 + 8);
    const int stage_bytes = z_bytes + round16(kWideChunk + 15);
    const int smem = 128 + kWideStages * stage_bytes;
    auto kernel = one ? block_moments_wide<6, true> : block_moments_wide<kPanel, false>;
    // the largest carveout: as many CTAs an SM as its shared memory holds
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t items = S * pieces;
    kernel<<<static_cast<unsigned>(items < cap ? items : cap), warps * 32, smem, st>>>(
        zp, wp, S, R, c, static_cast<int>(piece_rows < R ? piece_rows : R), static_cast<int>(pieces),
        stage_bytes, z_bytes, slots, partial);
  } else if (S > 0 && C > kMaxCols) {
    const int64_t npan = ((C + 7) / 8 + kPanel - 1) / kPanel;
    const int64_t blocks = (S * (npan * (npan + 1) / 2) + kWarps - 1) / kWarps;
    block_moments_direct<kPanel><<<static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads, 0, st>>>(
        zp, wp, S, R, c, slots, partial);
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
  if (G > 0 && C <= kMaxCols) {
    const int64_t n = G * static_cast<int64_t>(slots);
    const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
    group_sums<<<blocks, 256, 0, st>>>(partial, offsets, G, c, slots, M, counts);
  } else if (G > 0) {
    // runs of the partials where a group has many of them on average
    const bool split = S * pieces >= kSumSplitAt * G;
    const int per_block = split ? 256 / kSumParts : 256;
    if (!split && C <= kSumTileCols) {
      group_sums_tile<<<static_cast<unsigned>(G < 65535 ? G : 65535), 256, slots * sizeof(double), st>>>(
          partial, offsets, G, c, slots, static_cast<int>(pieces), M, counts);
      return static_cast<int>(cudaGetLastError());
    }
    const dim3 grid(static_cast<unsigned>((C * C + 1 + per_block - 1) / per_block),
                    static_cast<unsigned>(G < 65535 ? G : 65535));
    if (split) {
      group_sums_wide<kSumParts><<<grid, 256, 0, st>>>(partial, offsets, G, c, slots, static_cast<int>(pieces), M,
                                                       counts);
    } else {
      group_sums_wide<1><<<grid, 256, 0, st>>>(partial, offsets, G, c, slots, static_cast<int>(pieces), M, counts);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned above.
const char* pols_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
