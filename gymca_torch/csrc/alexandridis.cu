// K2 and K3: the fused Alexandridis wildfire step, one thread block per
// (env, 32 x 64 tile), for every lattice size.
//
// Replaces the TPU kernels gymca_tpu/ops/pallas_alexandridis.py::
// alexandridis_fused_step: its single-program branch (_alexandridis_kernel,
// up to ~320^2) and its row-band tiled branch (_alexandridis_tiled_kernel,
// 512^2 to 2048^2).  Both compute one function; on the TPU they differ only
// in how VMEM holds the lattice.  Here one spatially tiled kernel serves
// every size.  For every cell of env e, out of place:
//   heat    = sum_{r=1..R} c_r * box_r(fire)            (float32, r = 1..R)
//   dousing = c1 * box_1(d > 0) + c2 * box_2(d > 0)      (c1 = inner-border,
//                                                        c2 = border)
//   base    = (heat - dousing) * vdf
//   p_d     = base * wind[e, d] * exp_slope[e, d]        (d: Moore offsets)
//   ignite  = u < 1 - prod_d max(1 - p_d * fire_d, 0)    (fire_d: the fire
//                                                        mask shifted, zero
//                                                        outside the grid)
//   new     = tree & ignite ? fire : (fire & age <= 1 ? empty : g)
//   age'    = new fire ? age_min + bits % span : age, minus 1 where g burns.
// box_r is the exact integer count of fire (or doused) cells in the
// Chebyshev window of radius r, zero outside the grid.
//
// The draws (u, bits) of a cell are threefry2x32 under the env's two seed
// words with the flat cell index r * W + c as the counter: u = (b1 >> 8) *
// 2^-24, bits = b2.  They depend on (seed, cell) only, never on the tiling,
// so gymca_torch/ops/alexandridis_kernel.py's plain version reproduces them.
// The TPU kernel drew from the TPU's hardware generator, seeded per (env,
// step) and per (env, band) when tiled; its claim, and this kernel's, is
// distributional equivalence with the XLA path.
//
// Float order: every float multiply, add and subtract is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc
// never contracts into a fused multiply-add.  The plain PyTorch version does
// the same operations one at a time, so the two agree bit for bit.
//
// What bounds it on an H100: bytes, and they depend on the data.  Only a
// "candidate" (a tree with a burning Moore neighbour) can ignite; every other
// cell's output is fixed by its grid value and age (burnout at age <= 1, age
// - 1 where it burns, a copy elsewhere), because where no neighbour burns
// the product is exactly 1.0f and u < 1 - 1.0f is false for every u >= 0.
// So every cell reads grid and age and writes grid and age (10 B); a cell
// within 2 of a candidate reads dousing (1 B); a candidate also reads vdf
// (2 B) and the exp_slope plane of each burning neighbour (2 B each), and
// hashes its draws (threefry's 77 int32 operations).  Dense fire reads the
// 29 B of the earlier design.  The design:
//   * a thread owns 8 cells of a row in two groups of 4, at columns 4 g and
//     32 + 4 g of the tile (g = its column group), so a 32 x 64 tile is one
//     pass of 256 threads and a warp covers 4 rows: each group's grid as a
//     4-byte load and its age as one float4, lane-contiguous across the
//     warp; the thread's grid and age are loaded first and stay in flight
//     while the block stages its masks;
//   * the block stages the fire mask of its tile and one row each side as
//     bit rows (128 bits per row, one 32-byte sector per side), each warp
//     issuing all of its rows' loads before it packs them; from them each
//     thread finds its candidates with shifts;
//   * a block vote (__syncthreads_count) sends a tile without candidates
//     down the cheap rule: no dousing, no table, no plane, no draw;
//   * a working tile stages the rest of its R-cell fire halo and its dousing
//     mask as bit rows (box_1 and box_2 are popcounts of 5-bit windows);
//     with more than kDenseThreads threads holding candidates it builds one
//     integer summed-area table of fire, a column per thread, each entry a
//     popcount of the column's bit range added to a register (no dependent
//     shared-memory chain), so every fire box sum is four shared-memory
//     reads; a sparser tile sums each box from its row windows instead;
//   * each warp lists its candidates in shared memory and its lanes take
//     them 32 at a time, so a lane does not idle while another lane of its
//     warp hashes its eighth candidate: a lane reads the candidate's vdf and
//     the planes of its burning directions (2-byte loads, in flight while
//     the sums are made), hashes threefry, and writes the draw's outcome
//     over the entry for the owner to read back;
//   * 64 registers a thread (__launch_bounds__ with 4 blocks an SM), the
//     occupancy at which the step ran fastest.
// Tensor cores are no use here (the TPU kernel's banded matmuls were a TPU
// schedule for box sums, not a matrix product).
//
// Ablations, the counterpart of the TPU kernel's `ablate` (profiling only,
// outputs wrong by construction; the env never asks for them), each a
// compile-time instance that skips one phase so the phase's time shows:
//   kBoxes   heat = 8 * fire and dousing = the dousing mask of the cell
//            itself: no summed-area table, no dousing windows;
//   kIgnite  no_ignite = max(1 - 0.1 * base, 0): no exp_slope reads, no
//            8-direction product; every tree can ignite, so every tree is
//            a candidate (the dense path, with a table in every tile);
//   kPrng    u = 0.5 and new ages = age_min: no threefry.
// Instance kNone is the step itself.  Each instance has a vector form (W a
// multiple of 8 and 16-byte aligned planes) and a scalar form for any W.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kCells = 8;  // cells of a row per thread, two groups of 4 (cell_col)
constexpr int kThreads = kTileH * kTileW / kCells;
constexpr int kMaxRadius = 32;
constexpr int kRowWords = 4;  // a staged bit row: tile columns [-32, 96)
constexpr int kWarps = kThreads / 32;
constexpr int kStageBatch = 6;  // staged rows a warp loads before it packs them
constexpr int kMinBlocks = 4;   // blocks per SM the register budget must allow: 64 registers
constexpr int kMaxRowRadius = 15;  // row windows of 2r + 1 <= 31 bits
// Threads with candidates past which a tile builds its summed-area table;
// below it each candidate sums its boxes from the staged rows (on an H100
// this paid on main-path launches, where the few working tiles hold a fire
// front, and cost a few percent on dense fire).
constexpr int kDenseThreads = 64;

enum { kNone = 0, kBoxes = 1, kIgnite = 2, kPrng = 3 };

// Moore offset d in NEIGHBOR_OFFSETS order: (-1,-1) (-1,0) (-1,1) (0,-1)
// (0,1) (1,-1) (1,0) (1,1); compile-time in unrolled loops.
__host__ __device__ constexpr int dir_dr(int d) { return d < 3 ? -1 : (d < 5 ? 0 : 1); }
__host__ __device__ constexpr int dir_dc(int d) {
  return (d == 0 || d == 3 || d == 5) ? -1 : ((d == 1 || d == 6) ? 0 : 1);
}

struct Params {
  float coeff[kMaxRadius];  // heat coefficients c_1 .. c_R, float32
  int radius;               // R
  int halo;                 // max(R, 2)
  float dous_c1, dous_c2;   // inner - border, border
  int empty, tree, fire;
  int age_min, age_span;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax and gymca_torch.rng compute it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// Tile column of cell k (0..7) of the thread with column group g (0..7):
// two groups of 4 cells, at 4 g and 32 + 4 g, so that a warp's 16-byte age
// loads and stores are lane-contiguous (8 adjacent cells per thread, two
// float4 32 bytes apart across the lanes, streamed slower on an H100).
__device__ __forceinline__ int cell_col(int g, int k) { return 4 * g + (k & 3) + 32 * (k >> 2); }

__device__ __forceinline__ float bf16_to_float(uint32_t b) {
  return __uint_as_float(b << 16);
}

// Bit k of the result is the top bit of byte k of `m`.
__device__ __forceinline__ uint32_t byte_msb_nibble(uint32_t m) {
  return ((m & 0x80808080u) * 0x00204081u) >> 28;
}

// Four bytes of row `row` (a pointer to column 0) at columns [col, col+4),
// with a byte mask of those inside [0, w); bytes outside read as 0.
template <bool kVec>
__device__ __forceinline__ uint32_t load4(const int8_t* row, int col, int w, uint32_t& inb) {
  if (kVec) {  // w % 8 == 0: four bytes are all inside or all outside
    if (col >= 0 && col < w) {
      inb = 0xFFFFFFFFu;
      return __ldg(reinterpret_cast<const uint32_t*>(row + col));
    }
    inb = 0u;
    return 0u;
  }
  uint32_t v = 0;
  inb = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (col + b >= 0 && col + b < w) {
      v |= uint32_t(uint8_t(__ldg(row + col + b))) << (8 * b);
      inb |= 0xFFu << (8 * b);
    }
  }
  return v;
}

// Stage one mask of tile rows [-halo, 32 + halo) as bit rows: word q of row
// i holds tile columns [32 q - 32, 32 q), bit = column - (32 q - 32).  One
// warp per row, a lane per 4 columns; cells outside the grid are 0.
// kDous: the mask is d > 0; else g == fire.
template <bool kVec, bool kDous>
__device__ __forceinline__ void stage_bits(const int8_t* plane, uint32_t* bits, int r0, int c0,
                                           int halo, int h, int w, int fire, int i_lo,
                                           int eh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t fire4 = uint32_t(uint8_t(fire)) * 0x01010101u;
  // Staged rows [i_lo, eh), in batches, each row's load issued before any is
  // waited on.
  for (int i0 = i_lo + warp; i0 < eh; i0 += kStageBatch * kWarps) {
    uint32_t v[kStageBatch], inb[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int gr = r0 - halo + i0 + b * kWarps;
      v[b] = 0u;
      inb[b] = 0u;
      if (i0 + b * kWarps < eh && gr >= 0 && gr < h)
        v[b] = load4<kVec>(plane + (size_t)gr * w, c0 - 32 + 4 * lane, w, inb[b]);
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int i = i0 + b * kWarps;
      if (i >= eh) break;  // uniform across the warp
      const uint32_t m = (kDous ? __vcmpgts4(v[b], 0u) : __vcmpeq4(v[b], fire4)) & inb[b];
      uint32_t word = byte_msb_nibble(m) << (4 * (lane & 7));
      word |= __shfl_xor_sync(0xFFFFFFFFu, word, 1);
      word |= __shfl_xor_sync(0xFFFFFFFFu, word, 2);
      word |= __shfl_xor_sync(0xFFFFFFFFu, word, 4);
      if ((lane & 7) == 0) bits[i * kRowWords + (lane >> 3)] = word;
    }
  }
}

// n <= 16 bits of a staged row starting at bit `lo` (0 <= lo, lo + n <= 128).
__device__ __forceinline__ uint32_t row_window(const uint32_t* row, int lo, int n) {
  const int q = lo >> 5;
  const uint32_t next = q + 1 < kRowWords ? row[q + 1] : 0u;
  return __funnelshift_r(row[q], next, lo & 31) & ((1u << n) - 1u);
}

// The sum of v over the warp's lanes below this one; `total` over all 32.
__device__ __forceinline__ int warp_prefix(int v, int lane, int& total) {
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += u;
  }
  total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  return incl - v;
}

// One candidate's draw outcome: the sampled age offset (b2 % span) when it
// ignites, else -1.  `entry`: the owner lane << 3 | the owner's cell k.
template <int kAblate>
__device__ __forceinline__ int candidate(uint32_t entry, int warp, int halo, int r0, int c0,
                                         int w, size_t plane, int e, bool dense,
                                         const int* sat, int sw,
                                         const uint32_t* fbits, const uint32_t* dbits,
                                         const uint16_t* __restrict__ vdf,
                                         const uint16_t* __restrict__ exp_slope,
                                         const float* s_wind, uint32_t k0, uint32_t k1,
                                         const Params& p) {
  const int t = warp * 32 + int(entry >> 3), k = int(entry & 7);
  const int li = t / (kTileW / kCells), lj = cell_col(t % (kTileW / kCells), k);
  const size_t at = (size_t)(r0 + li) * w + c0 + lj;  // flat cell index
  const int ei = li + halo, ej = lj + halo;  // table coordinates
  const int bit = 32 + lj;                   // this cell's bit in a staged row
  // The burning directions, in NEIGHBOR_OFFSETS order, from the staged rows.
  uint32_t dirs = 0;
  if (kAblate != kIgnite) {
    const uint32_t* frow = fbits + ei * kRowWords;
    const uint32_t up = row_window(frow - kRowWords, bit - 1, 3);
    const uint32_t mid = row_window(frow, bit - 1, 3);
    const uint32_t dn = row_window(frow + kRowWords, bit - 1, 3);
    dirs = up | (mid & 1u) << 3 | (mid >> 2) << 4 | dn << 5;
  }
  // The planes first: their loads are in flight while the sums are made.
  const uint32_t vdf_k = __ldg(vdf + e * plane + at);
  uint32_t es[8];
#pragma unroll
  for (int d = 0; d < 8; ++d)
    es[d] = ((dirs >> d) & 1u)
                ? uint32_t(__ldg(exp_slope +
                                 ((size_t)e * 9 + (1 + dir_dr(d)) * 3 + (1 + dir_dc(d))) * plane +
                                 at))
                : 0u;
  const uint32_t* drow = dbits + ei * kRowWords;
  float heat = 0.0f, dousing;
  if (kAblate == kBoxes) {
    const uint32_t* frow = fbits + ei * kRowWords;
    heat = ((frow[bit >> 5] >> (bit & 31)) & 1u) ? 8.0f : 0.0f;
    dousing = ((drow[bit >> 5] >> (bit & 31)) & 1u) ? 1.0f : 0.0f;
  } else {
    if (dense) {
      // box_r = S(ei+r+1, ej+r+1) - S(ei-r, ej+r+1) - S(ei+r+1, ej-r) + S(ei-r, ej-r):
      // four corners, each one step along a diagonal of the table per radius.
      const int* s0 = sat + ei * sw + ej;
      const int* lo_hi = s0 + 2 * sw + 2;  // S(ei+r+1, ej+r+1) at r = 1
      const int* up_hi = s0 - sw + 2;      // S(ei-r, ej+r+1)
      const int* lo_lo = s0 + 2 * sw - 1;  // S(ei+r+1, ej-r)
      const int* up_lo = s0 - sw - 1;      // S(ei-r, ej-r)
      for (int r = 1; r <= p.radius; ++r) {
        const int box = *lo_hi - *up_hi - *lo_lo + *up_lo;
        heat = __fadd_rn(heat, __fmul_rn(p.coeff[r - 1], float(box)));
        lo_hi += sw + 1;
        up_hi += 1 - sw;
        lo_lo += sw - 1;
        up_lo -= sw + 1;
      }
    } else {
      // box_r as popcounts of the 2r + 1 row windows of width 2r + 1.
      const uint32_t* frow = fbits + ei * kRowWords;
      for (int r = 1; r <= p.radius; ++r) {
        int box = 0;
        for (int dr = -r; dr <= r; ++dr)
          box += __popc(row_window(frow + dr * kRowWords, bit - r, 2 * r + 1));
        heat = __fadd_rn(heat, __fmul_rn(p.coeff[r - 1], float(box)));
      }
    }
    int d1 = 0, d2 = 0;  // bits 1..3 of a 5-cell window are the 3-cell one
#pragma unroll
    for (int dr = -2; dr <= 2; ++dr) {
      const uint32_t v = row_window(drow + dr * kRowWords, bit - 2, 5);
      d2 += __popc(v);
      if (dr >= -1 && dr <= 1) d1 += __popc(v & 0xEu);
    }
    dousing = __fadd_rn(__fmul_rn(p.dous_c1, float(d1)), __fmul_rn(p.dous_c2, float(d2)));
  }
  uint32_t b1 = 0, b2 = 0;
  float u = 0.5f;
  if (kAblate != kPrng) {
    threefry2x32(k0, k1, 0u, uint32_t(at), b1, b2);
    u = __fmul_rn(__uint2float_rn(b1 >> 8), 5.9604644775390625e-8f);  // 2^-24
  }
  const float base = __fmul_rn(__fsub_rn(heat, dousing), bf16_to_float(vdf_k));
  float no_ignite = 1.0f;
  if (kAblate == kIgnite) {
    no_ignite = fmaxf(__fsub_rn(1.0f, __fmul_rn(base, 0.1f)), 0.0f);
  } else {
    // Directions without fire multiply by 1.0f: skipping them is exact.
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if ((dirs >> d) & 1u) {
        const float pd = __fmul_rn(__fmul_rn(base, s_wind[d]), bf16_to_float(es[d]));
        no_ignite = __fmul_rn(no_ignite, fmaxf(__fsub_rn(1.0f, pd), 0.0f));
      }
    }
  }
  if (!(u < __fsub_rn(1.0f, no_ignite))) return -1;
  return kAblate == kPrng ? 0 : int(b2 % uint32_t(p.age_span));
}

template <int kAblate, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
alexandridis_kernel(const int8_t* __restrict__ grid, const float* __restrict__ age,
                    const int8_t* __restrict__ dous, const uint16_t* __restrict__ vdf,
                    const uint16_t* __restrict__ exp_slope, const float* __restrict__ wind,
                    const uint32_t* __restrict__ seeds, int8_t* __restrict__ out_grid,
                    float* __restrict__ out_age, int h, int w, const Params p) {
  extern __shared__ uint32_t smem[];
  __shared__ float s_wind[8];
  __shared__ uint32_t s_list[kThreads * kCells];  // each warp's candidates, then outcomes
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int halo = p.halo;
  const int eh = kTileH + 2 * halo, ew = kTileW + 2 * halo;
  const int sw = ew + 1;  // the summed-area table carries a zero row and column
  uint32_t* fbits = smem;
  uint32_t* dbits = fbits + eh * kRowWords;
  int* sat = reinterpret_cast<int*>(dbits + eh * kRowWords);
  const size_t plane = (size_t)h * w;
  const int8_t* g = grid + (size_t)e * plane;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. This thread's 8 cells, two groups of 4 at tile columns col[0] and
  //    col[1]: grid and age into registers, in flight while the block
  //    stages its masks.
  const int li = threadIdx.x / (kTileW / kCells), grp = threadIdx.x % (kTileW / kCells);
  const int col[2] = {cell_col(grp, 0), cell_col(grp, 4)};
  const int gr = r0 + li;
  const bool row_in = gr < h;
  const size_t row_at = (size_t)gr * w + c0;  // flat index of the tile row's first cell
  int gv[kCells] = {0, 0, 0, 0, 0, 0, 0, 0};
  float a[kCells] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t inb = 0;  // bit k: cell k lies on the grid
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t at = row_at + col[q];
    if (kVec) {  // w % 8 == 0: a group is all on the grid or all off it
      if (row_in && c0 + col[q] < w) {
        inb |= 0xFu << (4 * q);
        const uint32_t gw = __ldg(reinterpret_cast<const uint32_t*>(g + at));
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(age + e * plane + at));
#pragma unroll
        for (int k = 0; k < 4; ++k) gv[4 * q + k] = int8_t((gw >> (8 * k)) & 0xFFu);
        a[4 * q] = a4.x;
        a[4 * q + 1] = a4.y;
        a[4 * q + 2] = a4.z;
        a[4 * q + 3] = a4.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (row_in && c0 + col[q] + k < w) {
          inb |= 1u << (4 * q + k);
          gv[4 * q + k] = __ldg(g + at + k);
          a[4 * q + k] = __ldg(age + e * plane + at + k);
        }
      }
    }
  }
  if (threadIdx.x < 8) s_wind[threadIdx.x] = wind[e * 8 + threadIdx.x];

  // 2. The fire mask of the tile and a row each side, as bit rows (the rest
  //    of the halo only where a tile works).
  stage_bits<kVec, false>(g, fbits, r0, c0, halo, h, w, p.fire, halo - 1, halo + kTileH + 1);
  __syncthreads();

  // 3. Candidates: trees with a burning Moore neighbour (every tree for
  //    kIgnite).  A group's fire neighbourhood: the bits of tile columns
  //    col - 1 .. col + 4 in the rows above, at and below.
  uint32_t tree_m = 0, burn_m = 0;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    tree_m |= uint32_t(gv[k] == p.tree) << k;
    burn_m |= uint32_t(gv[k] == p.fire) << k;
  }
  tree_m &= inb;
  burn_m &= inb;
  uint32_t cand = tree_m;
  if (kAblate != kIgnite) {
    const uint32_t* frow = fbits + (li + halo) * kRowWords;
    uint32_t near = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t v = row_window(frow - kRowWords, 31 + col[q], 6) |
                         row_window(frow, 31 + col[q], 6) |
                         row_window(frow + kRowWords, 31 + col[q], 6);
      near |= ((v | (v >> 1) | (v >> 2)) & 0xFu) << (4 * q);
    }
    cand &= near;
  }

  // 4. A tile without candidates takes the cheap rule; a working tile stages
  //    dousing and builds the fire table.
  // Dense: more threads with candidates than kDenseThreads, or a radius
  // whose windows pass 31 bits; a sparse tile sums its few boxes by rows.
  const int working = __syncthreads_count(cand != 0);
  const bool work = working > 0;
  const bool dense = working > kDenseThreads || p.radius > kMaxRowRadius;
  if (work) {
    stage_bits<kVec, true>(dous + (size_t)e * plane, dbits, r0, c0, halo, h, w, 0, 0, eh);
    if (kAblate != kBoxes) {
      stage_bits<kVec, false>(g, fbits, r0, c0, halo, h, w, p.fire, 0, halo - 1);
      stage_bits<kVec, false>(g, fbits, r0, c0, halo, h, w, p.fire, halo + kTileH + 1, eh);
      __syncthreads();  // the table reads every staged fire row
      // sat[i * sw + j] = fire cells in staged rows [0, i), tile columns
      // [-halo, j - halo): a thread per column j (ew + 1 <= 129 <= kThreads),
      // each row's count a popcount of its bit range [32 - halo, 32 - halo +
      // j) added to a register.  A sparse tile builds none.
      const int j = threadIdx.x;
      if (dense && j <= ew) {
        uint32_t m[kRowWords];
#pragma unroll
        for (int q = 0; q < kRowWords; ++q) {
          const int lo = max(32 - halo - 32 * q, 0), hi = min(32 - halo + j - 32 * q, 32);
          m[q] = hi <= lo ? 0u : (hi - lo == 32 ? ~0u : ((1u << (hi - lo)) - 1u) << lo);
        }
        int acc = 0;
        sat[j] = 0;
#pragma unroll 4
        for (int i = 0; i < eh; ++i) {
          const uint4 rw = *reinterpret_cast<const uint4*>(fbits + i * kRowWords);
          acc += __popc(rw.x & m[0]) + __popc(rw.y & m[1]) + __popc(rw.z & m[2]) +
                 __popc(rw.w & m[3]);
          sat[(i + 1) * sw + j] = acc;
        }
      }
    }
    __syncthreads();
  }

  // 5. The rule.  Every cell: burnout and ageing.  Candidates: each warp
  //    lists its own, its lanes take them 32 at a time (heat, dousing,
  //    base, the product over burning directions, draws) and write each
  //    outcome over its entry; the owners read theirs back.
  int nv[kCells];
  float na[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const bool burning = (burn_m >> k) & 1u;
    nv[k] = (burning && a[k] <= 1.0f) ? p.empty : gv[k];
    na[k] = burning ? __fsub_rn(a[k], 1.0f) : a[k];
  }
  if (work) {
    uint32_t* list = s_list + warp * 32 * kCells;
    int total;
    const int before = warp_prefix(__popc(cand), lane, total);
#pragma unroll
    for (int k = 0, slot = before; k < kCells; ++k)
      if ((cand >> k) & 1u) list[slot++] = uint32_t(lane << 3 | k);
    __syncwarp();
    const uint32_t k0 = seeds[2 * e], k1 = seeds[2 * e + 1];
    for (int i = lane; i < total; i += 32)
      list[i] = uint32_t(candidate<kAblate>(list[i], warp, halo, r0, c0, w, plane, e, dense,
                                            sat, sw,
                                            fbits, dbits, vdf, exp_slope, s_wind, k0, k1, p));
    __syncwarp();
#pragma unroll
    for (int k = 0, slot = before; k < kCells; ++k) {
      if ((cand >> k) & 1u) {
        const int res = int(list[slot++]);
        if (res >= 0) {  // a tree ignites: it was not burning
          nv[k] = p.fire;
          na[k] = float(p.age_min + res);
        }
      }
    }
  }

  // 6. Write back every cell of the tile (out of place).
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t at = e * plane + row_at + col[q];
    if (kVec) {
      if ((inb >> (4 * q)) & 1u) {
        uint32_t gw = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) gw |= uint32_t(uint8_t(nv[4 * q + k])) << (8 * k);
        *reinterpret_cast<uint32_t*>(out_grid + at) = gw;
        *reinterpret_cast<float4*>(out_age + at) =
            make_float4(na[4 * q], na[4 * q + 1], na[4 * q + 2], na[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((inb >> (4 * q + k)) & 1u) {
          out_grid[at + k] = int8_t(nv[4 * q + k]);
          out_age[at + k] = na[4 * q + k];
        }
      }
    }
  }
}

// Dynamic shared memory of one block for a given halo: the fire and dousing
// bit rows, 4 words each for each of TH + 2h rows, and the (TH+2h+1) x
// (TW+2h+1) int32 summed-area table.
int shared_bytes(int halo) {
  const int eh = kTileH + 2 * halo, ew = kTileW + 2 * halo;
  return 2 * eh * kRowWords * (int)sizeof(uint32_t) + (eh + 1) * (ew + 1) * (int)sizeof(int);
}

template <int kAblate, bool kVec>
cudaError_t launch_instance(const void* grid, const void* age, const void* dous,
                            const void* vdf, const void* exp_slope, const void* wind,
                            const void* seeds, void* out_grid, void* out_age, int n, int h,
                            int w, const Params& p, cudaStream_t stream) {
  const auto kernel = alexandridis_kernel<kAblate, kVec>;
  const int smem = shared_bytes(p.halo);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 blocks((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(grid), static_cast<const float*>(age),
      static_cast<const int8_t*>(dous), static_cast<const uint16_t*>(vdf),
      static_cast<const uint16_t*>(exp_slope), static_cast<const float*>(wind),
      static_cast<const uint32_t*>(seeds), static_cast<int8_t*>(out_grid),
      static_cast<float*>(out_age), h, w, p);
  return cudaGetLastError();
}

template <int kAblate>
cudaError_t launch_ablation(bool vec, const void* grid, const void* age, const void* dous,
                            const void* vdf, const void* exp_slope, const void* wind,
                            const void* seeds, void* out_grid, void* out_age, int n, int h,
                            int w, const Params& p, cudaStream_t stream) {
  return vec ? launch_instance<kAblate, true>(grid, age, dous, vdf, exp_slope, wind, seeds,
                                              out_grid, out_age, n, h, w, p, stream)
             : launch_instance<kAblate, false>(grid, age, dous, vdf, exp_slope, wind, seeds,
                                               out_grid, out_age, n, h, w, p, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Launches the step on `stream`; returns the launch's cudaError_t (0 on
// success).  grid, dous: (n, h, w) int8; age, out_age: (n, h, w) float32;
// vdf: (n, h, w) bfloat16 and exp_slope (n, 3, 3, h, w) bfloat16, as raw
// 16-bit words; wind (n, 8) float32; seeds (n, 2) uint32; out_grid (n, h, w)
// int8; all contiguous on the device.  coeff: `radius` host float32 values.
// ablate: kNone for the step, else the ablation instance to launch.  The
// vector form runs when w % 8 == 0 and every plane is 16-byte aligned.
extern "C" int alexandridis_launch(const void* grid, const void* age, const void* dous,
                                   const void* vdf, const void* exp_slope, const void* wind,
                                   const void* seeds, void* out_grid, void* out_age, int n,
                                   int h, int w, const float* coeff, int radius,
                                   float dous_c1, float dous_c2, int empty, int tree,
                                   int fire, int age_min, int age_span, int ablate,
                                   void* stream) {
  if (n <= 0) return 0;
  if (radius < 1 || radius > kMaxRadius || age_span < 1 || n > 65535 || ablate < kNone ||
      ablate > kPrng)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  for (int r = 0; r < kMaxRadius; ++r) p.coeff[r] = r < radius ? coeff[r] : 0.0f;
  p.radius = radius;
  p.halo = radius > 2 ? radius : 2;
  p.dous_c1 = dous_c1;
  p.dous_c2 = dous_c2;
  p.empty = empty;
  p.tree = tree;
  p.fire = fire;
  p.age_min = age_min;
  p.age_span = age_span;
  const bool vec = w % 8 == 0 && aligned16(grid) && aligned16(age) && aligned16(dous) &&
                   aligned16(vdf) && aligned16(exp_slope) && aligned16(out_grid) &&
                   aligned16(out_age);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(A) \
  launch_ablation<A>(vec, grid, age, dous, vdf, exp_slope, wind, seeds, out_grid, out_age, n, h, w, p, s)
  switch (ablate) {
    case kBoxes: return LAUNCH(kBoxes);
    case kIgnite: return LAUNCH(kIgnite);
    case kPrng: return LAUNCH(kPrng);
    default: return LAUNCH(kNone);
  }
#undef LAUNCH
}
