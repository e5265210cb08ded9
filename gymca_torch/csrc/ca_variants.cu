// S4: four formulations of one dense windy-CA step, on K1's band-and-cluster
// layout.
//
// Replaces the TPU probe scripts/exp_ca_variants.py::run_variant and its
// bodies kernel_banded, kernel_bool, kernel_fma and kernel_swar.  Every env
// of an (N, H, W) int8 grid holding EMPTY, TREE, FIRE = 0, 3, 25 takes one
// windy step in place, with the gusts of weights (N, 8) int32 (0 or
// PROPAGATION = 8, NEIGHBOR_OFFSETS order; a direction is on where its
// weight is > 0), and counts (N, 2) int32 = [trees, fires] of the new grid.
// The four formulations give the same grid and counts:
//   banded  the int32 score 2^11 * g + sum_d w_d * g[neighbour d] (0 outside
//           the grid), decoded by windy_breaks' thresholds;
//   bool    fire -> empty, tree -> fire where some gusted neighbour is fire,
//           from OR-ed fire masks;
//   fma     the banded score in float32 with explicit __fmaf_rn (exact: the
//           score stays below 2^17);
//   swar    four cells per 32-bit word (byte k of word c is column 4c + k):
//           fire masks by __vcmpeq4, a column shift is a byte shift with a
//           __funnelshift carry from the next word (zero at the grid's
//           edges, never across rows), counts by __popc.  Needs W % 4 == 0.
//
// One layout for all four, K1's (csrc/windy_sparse.cu), so the probe
// compares formulations on the layout the main path uses:
//   * one thread-block cluster of kCluster blocks per env.  Block b owns rows
//     [b * band, (b+1) * band), band = ceil(H / kCluster), and stages them
//     with one halo row each side.  The kernel is persistent: it is launched
//     at the clusters the card holds at once (cudaOccupancyMaxActiveClusters)
//     and cluster c walks envs c, c + clusters, ...  (At 256 envs that is a
//     full round and one partly full; two even rounds of 128 measured slower
//     on an H100: the first round's extra warps count for more than the tail);
//   * staging as bytes, not bit masks (banded and fma need cell values).  A
//     band's rows, halos included, are contiguous in memory, so where
//     W % 16 == 0 and the grid is 16-byte aligned one thread brings them in
//     with one cp.async.bulk (global -> shared) that completes on an
//     mbarrier.  Otherwise the block loads them as words (W % 4 == 0 and a
//     4-byte aligned grid) or as bytes, rows padded to whole words with
//     EMPTY, which is the outside fill;
//   * two stages: right after an env's cluster barrier the bulk copy of the
//     cluster's next env goes into the other stage, so it is in flight while
//     this env is computed and stored (2 * (band + 2) * W bytes a block);
//   * a cluster barrier between every block's last read of an env's grid and
//     the first write to it: halo rows are read by one block and written by
//     its neighbour, exactly as in K1;
//   * the bulk form's lanes take 4 words (16 cells) of 4 or 8 rows in a
//     column each: a 16-byte shared load a row, the words left and right of
//     it from the neighbouring lanes by shuffles, a rolling window of 3 rows,
//     each word stepped by its formulation's step_word, and a 16-byte store a
//     row.  The other forms step a word at a time from the 3 x 3 words in
//     shared memory;
//   * counts without atomics: each warp reduces its counts by shuffles into
//     a slot of its own; after the next cluster barrier the first warp of
//     block 0 sums every block's slots over distributed shared memory and
//     writes counts[e].  The slots alternate with the env's parity, so the
//     sum is exact and needs no zeroing pass.
//
// What bounds it on an H100.  Bytes: the grid read and written once,
// 2 * N * H * W, plus the weights and counts: 33.56 MB at 256 x 256^2, 10.02
// us at 3.35 TB/s, though at that size the 16 MiB of grid stay in the 50 MB
// L2 across the probe's in-place steps, so HBM is no floor there; 537 MB at
// 4096 x 256^2, 160.3 us.  Instructions: every formulation but swar does
// tens of operations a cell, so each is held to the larger of its bytes and
// its instructions, the busiest pipe of the SM for the inner loop's SASS
// (chip_smoke.py counts them in cuobjdump -sass of this build, with
// gymca_torch/probes/sass.py).  Measured on an H100 at 1,980 MHz: banded
// 115, bool 154, fma 121 and swar 47 instructions a 4-cell word; at 4096 x
// 256^2 that bounds them at 231 us (issue), 511 (int32 ALU), 243 (issue)
// and, for swar, the 160 us of bytes (its ALU time is 148).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;     // blocks (row bands) per env
constexpr int kMinBlocks = 6;   // blocks per SM the register budget must allow
constexpr int kEmpty = 0, kTree = 3, kFire = 25;
constexpr int kIdentity = 2048;
constexpr int kKeep = kIdentity * kTree;
constexpr int kPropagate = kIdentity * kTree + 8 * kFire;
constexpr int kConsume = kIdentity * kFire;
constexpr int kMaxShared = 232448 - 256;  // less the static barriers and count slots

enum { kBanded = 0, kBool = 1, kFma = 2, kSwar = 3 };

// Rows of 4 words a lane steps in the bulk form, the faster of 4 and 8 for
// each formulation on an H100 (8 for the lighter windows of bool and swar).
template <int V>
constexpr int kRowsPerLane = V == kBool || V == kSwar ? 8 : 4;

// Cell k in -1..4 of row i of the 3 x 3 word window (k = -1: the last cell
// of the left word; k = 4: the first cell of the right word).
__device__ __forceinline__ int cell(const uint32_t (&x)[3][3], int i, int k) {
  if (k < 0) return int(x[i][0] >> 24);
  if (k > 3) return int(x[i][2] & 0xFFu);
  return int((x[i][1] >> (8 * k)) & 0xFFu);
}

// The swar word from the fire masks f of its 3 x 3 window and its own cells.
__device__ __forceinline__ uint32_t swar_word(const uint32_t (&f)[3][3], uint32_t centre,
                                              const int (&wt)[8], int& trees, int& fires) {
  const uint32_t fire4 = 0x19191919u;
  uint32_t gate[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) gate[d] = wt[d] > 0 ? 0xFFFFFFFFu : 0u;
  // Row i = 1 + dr; the gates of (dr, +1) and (dr, -1) are d = 2, 4, 7 and
  // d = 0, 3, 5.  pre_p[j]: fire seen from column +1, of word j; pre_m: -1.
  uint32_t pre_p[3], pre_m[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    pre_p[j] = (f[0][j] & gate[2]) | (f[1][j] & gate[4]) | (f[2][j] & gate[7]);
    pre_m[j] = (f[0][j] & gate[0]) | (f[1][j] & gate[3]) | (f[2][j] & gate[5]);
  }
  uint32_t acc = (f[0][1] & gate[1]) | (f[2][1] & gate[6]);
  acc |= __funnelshift_r(pre_p[1], pre_p[2], 8);  // cell k takes cell k + 1
  acc |= __funnelshift_l(pre_m[0], pre_m[1], 8);  // cell k takes cell k - 1
  const uint32_t tree = __vcmpeq4(centre, 0x03030303u);
  const uint32_t burn = tree & acc;
  const uint32_t keep = tree & ~burn;
  trees += __popc(keep & 0x01010101u);
  fires += __popc(burn & 0x01010101u);
  return (burn & fire4) | (keep & 0x03030303u);
}

template <int V>
__device__ __forceinline__ uint32_t step_word(const uint32_t (&x)[3][3], const int (&wt)[8],
                                              int& trees, int& fires) {
  constexpr int dr[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  constexpr int dc[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  if constexpr (V == kSwar) {
    uint32_t f[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) f[i][j] = __vcmpeq4(x[i][j], 0x19191919u);
    return swar_word(f, x[1][1], wt, trees, fires);
  } else {
    uint32_t out = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = cell(x, 1, k);
      int nv;
      if constexpr (V == kBanded) {
        int signal = kIdentity * g;
#pragma unroll
        for (int d = 0; d < 8; ++d) signal += wt[d] * cell(x, 1 + dr[d], k + dc[d]);
        nv = signal >= kConsume ? kEmpty
             : signal >= kPropagate ? kFire
             : signal >= kKeep ? kTree : kEmpty;
      } else if constexpr (V == kFma) {
        float signal = float(kIdentity) * float(g);
#pragma unroll
        for (int d = 0; d < 8; ++d)
          signal = __fmaf_rn(float(wt[d]), float(cell(x, 1 + dr[d], k + dc[d])), signal);
        nv = signal >= float(kConsume) ? kEmpty
             : signal >= float(kPropagate) ? kFire
             : signal >= float(kKeep) ? kTree : kEmpty;
      } else {  // kBool
        int any = 0;
#pragma unroll
        for (int d = 0; d < 8; ++d)
          any |= int(wt[d] > 0) & int(cell(x, 1 + dr[d], k + dc[d]) == kFire);
        nv = g == kFire ? kEmpty : (g == kTree && any ? kFire : g);
      }
      trees += nv == kTree;
      fires += nv == kFire;
      out |= uint32_t(nv) << (8 * k);
    }
    return out;
  }
}

// --- the bulk copy and its barrier (PTX) ---------------------------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(bar)) : "memory");
}

// One thread: arm `bar` for `bytes` and copy them from global `src` to shared
// `dst` (both 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(shared_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(shared_addr(dst)), "l"(src), "r"(bytes), "r"(shared_addr(bar)) : "memory");
}

// Waits for the completion of phase `parity` of `bar`.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(shared_addr(bar)), "r"(parity) : "memory");
}

// --- stepping a band ------------------------------------------------------------------

// Row `k` of the staged band around 4-word unit column c4 for the bulk form:
// its words 4 c4 - 1 .. 4 c4 + 4 (zero outside the grid or past the staged
// rows).  The middle four are one 16-byte shared load; the outer two come
// from the neighbouring lanes, which hold the units left and right of this
// one, or from shared memory at the warp's ends.  Every lane takes part.
__device__ __forceinline__ void load_row(const uint32_t* st, int k, int last, int gr, int h,
                                         int ww, int c4, int upr, uint32_t (&x)[6]) {
  const int lane = threadIdx.x & 31;
  const bool in = k <= last && gr >= 0 && gr < h;
  const uint32_t* row = st + k * ww;
  const uint4 m = in ? reinterpret_cast<const uint4*>(row)[c4] : make_uint4(0, 0, 0, 0);
  uint32_t left = __shfl_up_sync(0xFFFFFFFFu, m.w, 1);
  uint32_t right = __shfl_down_sync(0xFFFFFFFFu, m.x, 1);
  if (lane == 0 && in && c4 > 0) left = row[4 * c4 - 1];
  if (lane == 31 && in && c4 + 1 < upr) right = row[4 * c4 + 4];
  x[0] = c4 > 0 ? left : 0u;
  x[1] = m.x;
  x[2] = m.y;
  x[3] = m.z;
  x[4] = m.w;
  x[5] = c4 + 1 < upr ? right : 0u;
}

// The bulk form.  A lane takes 4 words (16 cells) of kRowsPerLane<V> rows in
// a column: it loads rows r - 1 and r, then for each of its rows the next one,
// steps the row's 4 words by the formulation's step_word from the rolling
// 3-row window and writes them with one 16-byte store.  `st` holds grid row
// r at staged row r - r0 + 1, ww words a row (ww % 4 == 0); rows [r0, r1)
// are written to `g`.
template <int V>
__device__ __forceinline__ void step_quads(const uint32_t* st, int8_t* g, int r0, int r1,
                                           int h, int w, int ww, const int (&wt)[8],
                                           int& trees, int& fires) {
  const int lane = threadIdx.x & 31;
  const int upr = ww >> 2;  // 4-word unit columns a row
  const int rows = r1 - r0, last = rows + 1;
  const int units = (rows + kRowsPerLane<V> - 1) / kRowsPerLane<V> * upr;
  // This lane's unit as (row group, column), and the step to its next one.
  int grp = threadIdx.x / upr, c4 = threadIdx.x - grp * upr;
  const int dgrp = kThreads / upr, dc4 = kThreads - dgrp * upr;
  // Warps walk whole runs of 32 units, so every lane takes part in the
  // shuffles; lanes past the end load zeros and store nothing.
#pragma unroll 1
  for (int u0 = threadIdx.x & ~31; u0 < units; u0 += kThreads) {
    const bool live = u0 + lane < units;
    const int k0 = grp * kRowsPerLane<V>;  // staged row above the lane's first row
    uint32_t x[3][6];
    load_row(st, k0, last, r0 + k0 - 1, h, ww, c4, upr, x[0]);
    load_row(st, k0 + 1, last, r0 + k0, h, ww, c4, upr, x[1]);
    // swar: each word's fire mask once a row, rolled with the rows.
    uint32_t fm[3][6];
    if constexpr (V == kSwar) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) fm[i][j] = __vcmpeq4(x[i][j], 0x19191919u);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerLane<V>; ++i) {
      const int k = k0 + i + 2;
      load_row(st, k, last, r0 + k - 1, h, ww, c4, upr, x[2]);
      uint32_t out[4];
      int t = 0, f = 0;
      if constexpr (V == kSwar) {
#pragma unroll
        for (int j = 0; j < 6; ++j) fm[2][j] = __vcmpeq4(x[2][j], 0x19191919u);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t win[3][3] = {{fm[0][q], fm[0][q + 1], fm[0][q + 2]},
                                      {fm[1][q], fm[1][q + 1], fm[1][q + 2]},
                                      {fm[2][q], fm[2][q + 1], fm[2][q + 2]}};
          out[q] = swar_word(win, x[1][q + 1], wt, t, f);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t win[3][3] = {{x[0][q], x[0][q + 1], x[0][q + 2]},
                                      {x[1][q], x[1][q + 1], x[1][q + 2]},
                                      {x[2][q], x[2][q + 1], x[2][q + 2]}};
          out[q] = step_word<V>(win, wt, t, f);
        }
      }
      const int br = k0 + i;  // band row
      if (live && br < rows) {
        *reinterpret_cast<uint4*>(g + (size_t)(r0 + br) * w + 16 * c4) =
            make_uint4(out[0], out[1], out[2], out[3]);
        trees += t;
        fires += f;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        x[0][j] = x[1][j];
        x[1][j] = x[2][j];
        if constexpr (V == kSwar) {
          fm[0][j] = fm[1][j];
          fm[1][j] = fm[2][j];
        }
      }
    }
    c4 += dc4;
    grp += dgrp;
    if (c4 >= upr) {
      c4 -= upr;
      ++grp;
    }
  }
}

// The other forms: a thread per word; `words`: stored as one 32-bit word
// (W % 4 == 0, 4-byte aligned), else cell by cell.
template <int V>
__device__ __forceinline__ void step_words(const uint32_t* st, int8_t* g, int r0, int r1,
                                           int h, int w, int ww, bool words,
                                           const int (&wt)[8], int& trees, int& fires) {
  const int units = (r1 - r0) * ww;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int br = u / ww, c = u - br * ww;
    uint32_t x[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int gr = r0 + br - 1 + i;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int cc = c + j - 1;
        x[i][j] = (gr >= 0 && gr < h && cc >= 0 && cc < ww) ? st[(br + i) * ww + cc] : 0u;
      }
    }
    const uint32_t out = step_word<V>(x, wt, trees, fires);
    const int r = r0 + br;
    if (words) {
      reinterpret_cast<uint32_t*>(g + (size_t)r * w)[c] = out;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * c + k < w) g[(size_t)r * w + 4 * c + k] = int8_t(out >> (8 * k));
    }
  }
}

// counts[0], counts[1] = the sums of every block's count slots `slot` (the
// first warp of block 0, over distributed shared memory).
__device__ __forceinline__ void sum_counts(cg::cluster_group& cluster, int* slot, int* out) {
  const int lane = threadIdx.x & 31;
  int trees = 0, fires = 0;
  for (int j = lane; j < kCluster * kWarps; j += 32) {
    const int* remote = cluster.map_shared_rank(slot + 2 * (j % kWarps), j / kWarps);
    trees += remote[0];
    fires += remote[1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    trees += __shfl_xor_sync(0xFFFFFFFFu, trees, o);
    fires += __shfl_xor_sync(0xFFFFFFFFu, fires, o);
  }
  if (lane == 0) {
    out[0] = trees;
    out[1] = fires;
  }
}

// BULK: W % 16 == 0 and a 16-byte aligned grid (the bulk copy, 4-word lanes,
// 16-byte stores).  Otherwise `words`: W % 4 == 0 and a 4-byte aligned grid.
template <int V, bool BULK>
__device__ __forceinline__ void ca_body(int8_t* __restrict__ grid,
                                        const int* __restrict__ weights,
                                        int* __restrict__ counts, int n, int h, int w, int band,
                                        bool words) {
  extern __shared__ uint4 smem[];
  __shared__ uint64_t full[2];                // the two stages' bulk-copy barriers
  __shared__ int slots[2][kWarps][2];         // each warp's [trees, fires], by env parity

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int clusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ww = (w + 3) >> 2;                                  // words a staged row
  const int r0 = min(rank * band, h), r1 = min(r0 + band, h);  // the rows this block owns
  const int rs = max(r0 - 1, 0), re = min(r1 + 1, h);           // the rows it stages
  const bool busy = r0 < r1;
  const size_t cells = (size_t)h * w;
  const int stage_words = (band + 2) * ww;
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  const int first = (rs - r0 + 1) * ww;  // staged row s holds grid row r0 - 1 + s

  if (BULK && threadIdx.x == 0) {
    barrier_init(&full[0]);
    barrier_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (BULK && busy && threadIdx.x == 0)
    bulk_load(stages + first, grid + (size_t)cid * cells + (size_t)rs * w,
              uint32_t((re - rs) * w), &full[0]);

  int it = 0;
  for (int e = cid; e < n; e += clusters, ++it) {
    const int s = it & 1;
    uint32_t* st = stages + s * stage_words;
    int8_t* g = grid + (size_t)e * cells;
    int wt[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) wt[d] = weights[e * 8 + d];

    // 1. This block's rows of env e, halos included, in stage s.
    if (BULK) {
      if (busy) barrier_wait(&full[s], (it >> 1) & 1);
    } else if (busy && words) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(g + (size_t)rs * w);
      for (int i = threadIdx.x; i < (re - rs) * ww; i += kThreads) st[first + i] = src[i];
    } else if (busy) {
      uint8_t* sb = reinterpret_cast<uint8_t*>(st + first);
      const int pitch = 4 * ww;
      for (int i = threadIdx.x; i < (re - rs) * pitch; i += kThreads) {
        const int r = i / pitch, col = i - r * pitch;
        sb[i] = col < w ? uint8_t(g[(size_t)(rs + r) * w + col]) : uint8_t(kEmpty);
      }
    }
    // 2. Every block of the cluster has read its rows of env e: writes may
    //    begin.  Every block's count slots of the previous env are written,
    //    and every thread is done with the other stage.
    cluster.sync();
    if (BULK && busy && threadIdx.x == 0 && e + clusters < n)
      bulk_load(stages + (s ^ 1) * stage_words + first,
                grid + (size_t)(e + clusters) * cells + (size_t)rs * w,
                uint32_t((re - rs) * w), &full[s ^ 1]);
    if (it > 0 && rank == 0 && warp == 0)
      sum_counts(cluster, &slots[s ^ 1][0][0], counts + 2 * (e - clusters));

    // 3. Step rows [r0, r1) into the grid; the warp's counts into its slot.
    int trees = 0, fires = 0;
    if (busy) {
      if (BULK) step_quads<V>(st, g, r0, r1, h, w, ww, wt, trees, fires);
      else step_words<V>(st, g, r0, r1, h, w, ww, words, wt, trees, fires);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      trees += __shfl_xor_sync(0xFFFFFFFFu, trees, o);
      fires += __shfl_xor_sync(0xFFFFFFFFu, fires, o);
    }
    if (lane == 0) {
      slots[s][warp][0] = trees;
      slots[s][warp][1] = fires;
    }
  }
  // 4. The last env's counts; no block exits while block 0 reads its slots.
  cluster.sync();
  if (it > 0 && rank == 0 && warp == 0)
    sum_counts(cluster, &slots[(it - 1) & 1][0][0], counts + 2 * (cid + (it - 1) * clusters));
  cluster.sync();
}

#define CA_KERNEL(NAME, V)                                                              \
  template <bool BULK>                                                                  \
  __global__ void __launch_bounds__(kThreads, kMinBlocks)                               \
      NAME(int8_t* grid, const int* weights, int* counts, int n, int h, int w, int band, \
           bool words) {                                                                \
    ca_body<V, BULK>(grid, weights, counts, n, h, w, band, words);                      \
  }

CA_KERNEL(ca_banded_kernel, kBanded)
CA_KERNEL(ca_bool_kernel, kBool)
CA_KERNEL(ca_fma_kernel, kFma)
CA_KERNEL(ca_swar_kernel, kSwar)
#undef CA_KERNEL

using Kernel = void (*)(int8_t*, const int*, int*, int, int, int, int, bool);
const Kernel kKernels[4][2] = {
    {ca_banded_kernel<false>, ca_banded_kernel<true>},
    {ca_bool_kernel<false>, ca_bool_kernel<true>},
    {ca_fma_kernel<false>, ca_fma_kernel<true>},
    {ca_swar_kernel<false>, ca_swar_kernel<true>},
};

int band_rows(int h) { return (h + kCluster - 1) / kCluster; }

// Dynamic shared memory of one block: two stages of its band and halo rows,
// rows padded to words.
int shared_bytes(int h, int w) { return 2 * (band_rows(h) + 2) * 4 * ((w + 3) / 4); }

cudaLaunchConfig_t cluster_config(int blocks, int smem, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared-memory opt-in where it needs one (past 48 KiB).
cudaError_t allow_shared(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Clusters of `kernel` the card holds at once with `smem` bytes a block,
// into `*n`, remembered per kernel and size (its shared-memory opt-in set).
// A failed query, or none resident, is returned for the launch to report.
cudaError_t resident_clusters(int variant, bool bulk, int smem, int* n) {
  static int cached[4][2] = {}, cached_smem[4][2] = {};
  if (!cached[variant][bulk] || cached_smem[variant][bulk] != smem) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(kCluster, smem, &attr);
    int c = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&c, kKernels[variant][bulk], &cfg);
    if (err != cudaSuccess) return err;
    if (c < 1) return cudaErrorInvalidConfiguration;
    cached[variant][bulk] = c;
    cached_smem[variant][bulk] = smem;
  }
  *n = cached[variant][bulk];
  return cudaSuccess;
}

bool valid(int variant, int h, int w) {
  return variant >= 0 && variant <= 3 && h > 0 && w > 0 && (variant != kSwar || w % 4 == 0) &&
         shared_bytes(h, w) <= kMaxShared;
}

}  // namespace

// Launches formulation `variant` (0 banded, 1 bool, 2 fma, 3 swar) on
// `stream`; returns the launch's cudaError_t (0 on success).  grid: (n, h,
// w) int8, updated in place; weights (n, 8) int32; counts (n, 2) int32; all
// contiguous on the device.
extern "C" int ca_variant_launch(int variant, void* grid, const void* weights, void* counts,
                                 int n, int h, int w, void* stream) {
  if (n <= 0) return 0;
  if (!valid(variant, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = shared_bytes(h, w);
  const uintptr_t at = reinterpret_cast<uintptr_t>(grid);
  const bool bulk = w % 16 == 0 && at % 16 == 0;
  const bool words = w % 4 == 0 && at % 4 == 0;
  const Kernel kernel = kKernels[variant][bulk];
  cudaError_t err = allow_shared(kernel, smem);
  int clusters = 0;
  if (err == cudaSuccess) err = resident_clusters(variant, bulk, smem, &clusters);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(kCluster * min(clusters, n), smem, &attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<int8_t*>(grid),
                           static_cast<const int*>(weights), static_cast<int*>(counts), n, h, w,
                           band_rows(h), words);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
