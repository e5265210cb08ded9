// K1: the sparse windy-Bulldozer step: a light pass over every env, then
// the CA envs in row bands, one thread-block cluster per env.
//
// Replaces the TPU kernel gymca_tpu/ops/pallas_kernels.py::windy_fused_step
// (_windy_sparse_kernel).  For every env e of an (N, H, W) int8 or int32
// grid, updated in place:
//   * CA env (params[e].do_ca): replay the deferred edits
//     edits[e, :edit_counts[e]] (row | col << 16, each set to `empty`), then
//     fire -> empty; tree -> fire if some in-grid Moore neighbour is fire and
//     that direction's gust succeeded (weights[e, i] > 0, NEIGHBOR_OFFSETS
//     order), else tree; anything else -> empty.  Then the shot: if `shoot`
//     and (row, col) is a tree on the NEW grid it becomes empty and hit = 1.
//     counts[e] = {trees, fires, hit} of the final grid.
//   * modify-only env (!do_ca && shoot): tree -> empty at (row, col);
//     counts[e] = {0, 0, hit}.
//   * every other env: grid untouched, counts[e] = {0, 0, 0}.
// Grids must hold only {empty, tree, fire}, as the env's grids do.
//
// What bounds it on an H100: bytes.  A CA env reads and writes its whole
// grid once (2 * H * W * itemsize bytes); the update itself is a few integer
// operations per cell; an idle env costs its params and counts.  The design
// (windy_sparse_launch issues two kernels on the stream):
//   * the light pass, one thread per env: zero counts, the modify-only shot,
//     and the CA envs' indices appended to a device list (a counter and N
//     slots of scratch the wrapper keeps).  The host never learns the count;
//   * the CA pass, launched at a fixed size (the clusters the card can hold
//     at once: 186 on an H100 at 256 x 256), walks that list in a grid-
//     stride loop, one cluster of 4 blocks of 128 threads per env.  Block b
//     of a cluster owns rows [b * band, (b+1) * band), band = ceil(H / 4):
//     64 rows at 256 x 256, 16 KiB of int8.  So the ~317 CA envs of a main-
//     path step take two rounds, not one block each beside 3,800 idle ones;
//   * a block stages its band and one halo row each side as tree / fire bit
//     masks in shared memory (32 cells per word), a thread per 32-cell word
//     of an int8 row (two 16-byte loads, 5 words in flight per thread;
//     int32 rows 4 cells a lane, rows of other widths a cell a lane), and
//     replays the edits that fall in those rows (halo rows too: edits act
//     before the stencil).  Cells are classified 4 bytes at a time (a
//     zero-byte test on the word xor the value), not one by one;
//   * a cluster barrier then separates every read of the env's grid from
//     the first write to it, which keeps the in-place contract with halo
//     rows read by one block and written by its neighbour;
//   * the stencil is the boolean "any gusted fire neighbour" form of the
//     windy score decode, on 32-cell words; each output word of 4 cells is
//     built from the burn / keep bits (a nibble spread to bytes with one
//     multiply), not cell by cell;
//   * counts are integers: each block adds its band's to counts[e] with
//     global atomics after the light pass zeroed them, so the sum is exact;
//   * the last cluster to finish zeroes the list's counter for the next call.
// Why clusters and not a second kernel with halo copies: the halo rows stay
// where they were read, and the barrier costs less than a launch.
// A band's two bit masks take 8 * (band + 2) * ceil(W / 32) bytes of shared
// memory (4.1 KiB at 256 x 256); the wrapper rejects grids past 227 KiB.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kCluster = 4;     // blocks (row bands) per CA env
constexpr int kUnroll = 5;      // slices each thread loads before it converts them
constexpr int kMinBlocks = 6;   // blocks per SM the register budget must allow: 85 registers
constexpr int kLightThreads = 256;

// A lane's slice of a 32-cell word: PER cells in NV 16-byte vectors (VEC:
// the whole word of an int8 row, 4 cells of an int32 row) or one cell.  G
// lanes share a word; slot q covers bits [sub*PER, sub*PER+PER) of word
// q / G, sub = q % G.
template <typename T, bool VEC>
struct Slice {
  static constexpr int PER = VEC ? (sizeof(T) == 1 ? 32 : 4) : 1;
  static constexpr int NV = VEC ? PER * int(sizeof(T)) / 16 : 1;
  static constexpr int G = 32 / PER;
  static constexpr uint32_t MASK = PER == 32 ? ~0u : (1u << PER) - 1u;
};

// Loads slot q's cells into `raw` (16-byte vectors, or the cell itself in
// raw[0].x); false when the slot lies past the rows or its row.  `g` points
// at the first row of the range; words number rows from there.
template <typename T, bool VEC>
__device__ __forceinline__ bool slice_load(const T* g, int q, int nslots, int w, int ww,
                                           uint4 (&raw)[Slice<T, VEC>::NV]) {
  using S = Slice<T, VEC>;
  if (q >= nslots) return false;
  const int word = q / S::G, sub = q % S::G;
  if (VEC) {
    const uint4* src = reinterpret_cast<const uint4*>(g + (size_t)word * 32 + sub * S::PER);
#pragma unroll
    for (int v = 0; v < S::NV; ++v) raw[v] = src[v];
    return true;
  }
  const int r = word / ww, col = (word - r * ww) * 32 + sub;
  if (col >= w) return false;
  *reinterpret_cast<T*>(&raw[0]) = g[(size_t)r * w + col];
  return true;
}

// Bit k of the result: byte k of x equals byte k of v4 (any byte values:
// the zero-byte test on x ^ v4, with no carry between bytes).
__device__ __forceinline__ uint32_t eq_nibble(uint32_t x, uint32_t v4) {
  const uint32_t y = x ^ v4;
  const uint32_t nonzero = ((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y;  // bit 7: byte != 0
  return ((~nonzero & 0x80808080u) * 0x00204081u) >> 28;
}

// The tree and fire bits of slot `sub`'s cells, at their place in the word.
template <typename T, bool VEC>
__device__ __forceinline__ void classify(const uint4 (&raw)[Slice<T, VEC>::NV], int sub,
                                         T t_tree, T t_fire, uint32_t& tb, uint32_t& fb) {
  using S = Slice<T, VEC>;
  tb = 0;
  fb = 0;
  if constexpr (VEC && sizeof(T) == 1) {  // 32 cells, 4 per 32-bit word
    const uint32_t t4 = uint32_t(uint8_t(t_tree)) * 0x01010101u;
    const uint32_t f4 = uint32_t(uint8_t(t_fire)) * 0x01010101u;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw[0]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tb |= eq_nibble(words[i], t4) << (4 * i);
      fb |= eq_nibble(words[i], f4) << (4 * i);
    }
  } else {
    const T* cells = reinterpret_cast<const T*>(&raw[0]);
#pragma unroll
    for (int b = 0; b < S::PER; ++b) {
      tb |= uint32_t(cells[b] == t_tree) << b;
      fb |= uint32_t(cells[b] == t_fire) << b;
    }
    tb <<= sub * S::PER;
    fb <<= sub * S::PER;
  }
}

// OR of v over the G lanes that share a word (G divides 32; groups aligned).
template <int G>
__device__ __forceinline__ uint32_t group_or(uint32_t v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t fire_word(const uint32_t* fire_m, int s, int j, int ww) {
  return (j >= 0 && j < ww) ? fire_m[s * ww + j] : 0u;
}

// Bytes 0x01 where bit k (k < 4) of n is set: bit k moves to bit 8 k.
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// The cells of slot `sub` of a word, from its burn and keep bits: fire where
// burn, tree where keep, empty elsewhere (the two are disjoint).
template <typename T, bool VEC>
__device__ __forceinline__ void decode(uint32_t burn, uint32_t keep, int sub, T t_empty,
                                       T t_tree, T t_fire, uint4 (&out)[Slice<T, VEC>::NV]) {
  using S = Slice<T, VEC>;
  const uint32_t b = burn >> (sub * S::PER), k = keep >> (sub * S::PER);
  if constexpr (VEC && sizeof(T) == 1) {  // 32 cells: eight 4-cell words
    const uint32_t e4 = uint32_t(uint8_t(t_empty)) * 0x01010101u;
    const uint32_t te = e4 ^ (uint32_t(uint8_t(t_tree)) * 0x01010101u);
    const uint32_t fe = e4 ^ (uint32_t(uint8_t(t_fire)) * 0x01010101u);
    uint32_t* words = reinterpret_cast<uint32_t*>(&out[0]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t bm = spread4((b >> (4 * i)) & 0xFu) * 0xFFu;
      const uint32_t km = spread4((k >> (4 * i)) & 0xFu) * 0xFFu;
      words[i] = e4 ^ (bm & fe) ^ (km & te);
    }
  } else {  // int32 cells (4 per vector) or one cell: a mask per cell
    T* cells = reinterpret_cast<T*>(&out[0]);
#pragma unroll
    for (int c = 0; c < S::PER; ++c) {
      const uint32_t bm = 0u - ((b >> c) & 1u), km = 0u - ((k >> c) & 1u);
      cells[c] = T((bm & uint32_t(t_fire)) | (km & uint32_t(t_tree)) |
                   (~(bm | km) & uint32_t(t_empty)));
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void slice_store(T* g, int q, int w, int ww,
                                            const uint4 (&v)[Slice<T, VEC>::NV]) {
  using S = Slice<T, VEC>;
  const int word = q / S::G, sub = q % S::G;
  if (VEC) {
    uint4* dst = reinterpret_cast<uint4*>(g + (size_t)word * 32 + sub * S::PER);
#pragma unroll
    for (int i = 0; i < S::NV; ++i) dst[i] = v[i];
    return;
  }
  const int r = word / ww, col = (word - r * ww) * 32 + sub;
  if (col < w) g[(size_t)r * w + col] = *reinterpret_cast<const T*>(&v[0]);
}

// The light pass: one thread per env.  scratch[0] counts the CA envs listed
// in scratch[2 ..]; scratch[1] counts the CA pass's finished clusters.
template <typename T>
__global__ void __launch_bounds__(kLightThreads)
windy_light_kernel(T* __restrict__ grid, const int* __restrict__ params,
                   int* __restrict__ counts, int* __restrict__ scratch, int n, int h, int w,
                   int empty, int tree) {
  const int e = blockIdx.x * kLightThreads + threadIdx.x;
  if (e >= n) return;
  int hit = 0;
  if (params[e * 4 + 0]) {  // do_ca
    scratch[2 + atomicAdd(scratch, 1)] = e;
  } else if (params[e * 4 + 3] > 0) {  // shoot at (row, col)
    T* cell = grid + (size_t)e * h * w + (size_t)params[e * 4 + 1] * w + params[e * 4 + 2];
    if (*cell == T(tree)) {
      *cell = T(empty);
      hit = 1;
    }
  }
  counts[e * 3 + 0] = 0;
  counts[e * 3 + 1] = 0;
  counts[e * 3 + 2] = hit;
}

// The CA pass: cluster c takes listed envs c, c + clusters, ...
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
windy_band_kernel(T* __restrict__ grid, const int* __restrict__ weights,
                  const int* __restrict__ params, const int* __restrict__ edits,
                  const int* __restrict__ edit_counts, int* __restrict__ counts,
                  int* __restrict__ scratch, int h, int w, int k, int band, int empty, int tree,
                  int fire) {
  using S = Slice<T, VEC>;
  extern __shared__ uint32_t smem[];
  __shared__ int s_tree, s_fire, s_n_ca;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int clusters = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  const int ww = (w + 31) >> 5;  // 32-cell words per row
  const int srows = band + 2;    // staged rows: the band and a halo row each side
  uint32_t* tree_m = smem;
  uint32_t* fire_m = smem + srows * ww;
  const T t_empty = T(empty), t_tree = T(tree), t_fire = T(fire);
  if (threadIdx.x == 0) {
    s_tree = 0;
    s_fire = 0;
    s_n_ca = *reinterpret_cast<volatile int*>(scratch);
  }
  __syncthreads();
  const int n_ca = s_n_ca;
  const int r0 = min(rank * band, h), r1 = min(r0 + band, h);  // this block's rows
  const int rs = max(r0 - 1, 0), re = min(r1 + 1, h);           // rows it reads

  int e_next = cid < n_ca ? scratch[2 + cid] : 0;
  for (int task = cid; task < n_ca; task += clusters) {
    const int e = e_next;
    // The env's words, loaded now and used after the staging barrier: the
    // loads are in flight with the grid's.
    const int row = params[e * 4 + 1], col = params[e * 4 + 2];
    const bool shoot = params[e * 4 + 3] > 0;
    const int n_edits = min(edit_counts[e], k);
    const int my_edit = threadIdx.x < k ? edits[(size_t)e * k + threadIdx.x] : 0;
    int wt[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wt[i] = weights[e * 8 + i];
    if (task + clusters < n_ca) e_next = scratch[2 + task + clusters];
    T* g = grid + (size_t)e * h * w;

    // 1. Stage rows [rs, re) as bit masks; staged row s is grid row r0 - 1 + s,
    //    and rows outside the grid stay 0.
    for (int i = threadIdx.x; i < srows * ww; i += kThreads) {
      const int r = r0 - 1 + i / ww;
      if (r < rs || r >= re) {
        tree_m[i] = 0u;
        fire_m[i] = 0u;
      }
    }
    const int off = (rs - (r0 - 1)) * ww;  // first loaded word in the staged rows
    const int nslots = (re - rs) * ww * S::G;
    const T* src = g + (size_t)rs * w;
    for (int q0 = 0; q0 < nslots; q0 += kThreads * kUnroll) {
      uint4 raw[kUnroll][S::NV];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        ok[u] = slice_load<T, VEC>(src, q0 + u * kThreads + threadIdx.x, nslots, w, ww, raw[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * kThreads + threadIdx.x;
        uint32_t tb = 0, fb = 0;
        if (ok[u]) classify<T, VEC>(raw[u], q % S::G, t_tree, t_fire, tb, fb);
        tb = group_or<S::G>(tb);  // every lane of the warp takes part
        fb = group_or<S::G>(fb);
        if (q < nslots && q % S::G == 0) {
          tree_m[off + q / S::G] = tb;
          fire_m[off + q / S::G] = fb;
        }
      }
    }
    __syncthreads();

    // 2. Replay the deferred edits that fall in the staged rows.
    for (int i = threadIdx.x; i < n_edits; i += kThreads) {
      const int wrd = i == threadIdx.x ? my_edit : edits[(size_t)e * k + i];
      const int r = wrd & 0xFFFF, c = wrd >> 16;
      if (r >= rs && r < re && c >= 0 && c < w) {
        const uint32_t keep = ~(1u << (c & 31));
        const int at = (r - (r0 - 1)) * ww + (c >> 5);
        atomicAnd(&tree_m[at], keep);
        atomicAnd(&fire_m[at], keep);
      }
    }
    // 3. Every block of the cluster has read this env's grid: writes may begin.
    __syncthreads();
    cluster.sync();

    // 4. Stencil, decode, shot, counts and write-back of rows [r0, r1).
    uint32_t gate[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) gate[i] = wt[i] > 0 ? ~0u : 0u;
    // NEIGHBOR_OFFSETS order: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1)
    int my_tree = 0, my_fire = 0;
    const int mslots = (r1 - r0) * ww * S::G;
    T* dst = g + (size_t)r0 * w;
    for (int q = threadIdx.x; q < mslots; q += kThreads) {
      const int word = q / S::G, sub = q % S::G;
      const int s = 1 + word / ww, j = word % ww;  // staged row, word column
      // pre_m / pre_p: fire neighbours at column offset -1 / +1, by word column.
      uint32_t pre_m[3], pre_p[3];  // word columns j-1, j, j+1
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const uint32_t up = fire_word(fire_m, s - 1, j - 1 + x, ww);
        const uint32_t mid = fire_word(fire_m, s, j - 1 + x, ww);
        const uint32_t dn = fire_word(fire_m, s + 1, j - 1 + x, ww);
        pre_m[x] = (up & gate[0]) | (mid & gate[3]) | (dn & gate[5]);
        pre_p[x] = (up & gate[2]) | (mid & gate[4]) | (dn & gate[7]);
      }
      const uint32_t acc = (fire_word(fire_m, s - 1, j, ww) & gate[1]) |
                           (fire_word(fire_m, s + 1, j, ww) & gate[6]) |
                           (pre_p[1] >> 1) | (pre_p[2] << 31) |
                           (pre_m[1] << 1) | (pre_m[0] >> 31);
      const uint32_t tw = tree_m[s * ww + j];
      const uint32_t burn = tw & acc;
      uint32_t keep = tw & ~acc;
      const uint32_t mine = S::MASK << (sub * S::PER);
      if (shoot && r0 + s - 1 == row && j == (col >> 5)) {
        const uint32_t bit = 1u << (col & 31);
        if ((bit & mine) && (keep & bit)) {
          keep &= ~bit;
          counts[e * 3 + 2] = 1;  // one cell, one thread: no race
        }
      }
      my_tree += __popc(keep & mine);
      my_fire += __popc(burn & mine);
      uint4 out[S::NV];
      decode<T, VEC>(burn, keep, sub, t_empty, t_tree, t_fire, out);
      slice_store<T, VEC>(dst, q, w, ww, out);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      my_tree += __shfl_xor_sync(0xffffffffu, my_tree, o);
      my_fire += __shfl_xor_sync(0xffffffffu, my_fire, o);
    }
    if ((threadIdx.x & 31) == 0 && (my_tree | my_fire)) {
      atomicAdd(&s_tree, my_tree);
      atomicAdd(&s_fire, my_fire);
    }
    // 5. The band's counts into counts[e] (zeroed by the light pass); the
    //    barrier also frees the staged masks for the next env.
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s_tree) atomicAdd(&counts[e * 3 + 0], s_tree);
      if (s_fire) atomicAdd(&counts[e * 3 + 1], s_fire);
      s_tree = 0;
      s_fire = 0;
    }
  }

  // 6. Every block has read the list's counter: the last cluster resets it.
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&scratch[1], 1) == clusters - 1) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
}

// Clusters of the band kernel the card holds at once (at least one).
template <typename T, bool VEC>
int resident_clusters(size_t smem) {
  static int cached = 0;
  static size_t cached_smem = 0;
  if (cached && cached_smem == smem) return cached;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, windy_band_kernel<T, VEC>, &cfg) != cudaSuccess ||
      n < 1) {
    cudaGetLastError();  // clear it: the launch below reports any real fault
    n = 1;
  }
  cached = n;
  cached_smem = smem;
  return n;
}

template <typename T, bool VEC>
cudaError_t launch(void* grid, const void* weights, const void* params, const void* edits,
                   const void* edit_counts, void* counts, void* scratch, int n, int h, int w,
                   int k, int empty, int tree, int fire, cudaStream_t stream) {
  const int band = (h + kCluster - 1) / kCluster;
  const size_t smem = 2 * sizeof(uint32_t) * (size_t)(band + 2) * ((w + 31) / 32);
  auto kernel = windy_band_kernel<T, VEC>;
  // Only bands past 48 KiB of masks need the opt-in; 256 x 256 takes 2.2 KiB.
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  windy_light_kernel<T><<<(n + kLightThreads - 1) / kLightThreads, kLightThreads, 0, stream>>>(
      static_cast<T*>(grid), static_cast<const int*>(params), static_cast<int*>(counts),
      static_cast<int*>(scratch), n, h, w, empty, tree);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster * min(resident_clusters<T, VEC>(smem), n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<T*>(grid),
                           static_cast<const int*>(weights), static_cast<const int*>(params),
                           static_cast<const int*>(edits),
                           static_cast<const int*>(edit_counts), static_cast<int*>(counts),
                           static_cast<int*>(scratch), h, w, k, band, empty, tree, fire);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream` (two kernels); returns the first cudaError_t that
// is not 0.  grid: (n, h, w) int8 (itemsize 1) or int32 (itemsize 4),
// updated in place; weights (n, 8), params (n, 4) [do_ca, row, col, shoot],
// edits (n, k), edit_counts (n,), counts (n, 3): all int32, contiguous, on
// the device.  scratch: n + 2 int32 on the device, all 0 before the first
// call; each call leaves it as it found it, so calls on one stream may
// share it.
extern "C" int windy_sparse_launch(void* grid, int itemsize, const void* weights,
                                   const void* params, const void* edits,
                                   const void* edit_counts, void* counts, void* scratch,
                                   int n, int h, int w, int k, int empty, int tree, int fire,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (w % 32 == 0) && (reinterpret_cast<uintptr_t>(grid) % 16 == 0);
  if (itemsize == 1)
    return vec ? launch<int8_t, true>(grid, weights, params, edits, edit_counts, counts,
                                      scratch, n, h, w, k, empty, tree, fire, s)
               : launch<int8_t, false>(grid, weights, params, edits, edit_counts, counts,
                                       scratch, n, h, w, k, empty, tree, fire, s);
  if (itemsize == 4)
    return vec ? launch<int32_t, true>(grid, weights, params, edits, edit_counts, counts,
                                       scratch, n, h, w, k, empty, tree, fire, s)
               : launch<int32_t, false>(grid, weights, params, edits, edit_counts, counts,
                                        scratch, n, h, w, k, empty, tree, fire, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CA pass's clusters the card holds at once for an int8 (itemsize 1) or
// int32 grid of h x w, in the vector form when w % 32 == 0: the size the
// pass is launched at.
extern "C" int windy_sparse_clusters(int itemsize, int h, int w) {
  const int band = (h + kCluster - 1) / kCluster;
  const size_t smem = 2 * sizeof(uint32_t) * (size_t)(band + 2) * ((w + 31) / 32);
  const bool vec = w % 32 == 0;
  if (itemsize == 1) return vec ? resident_clusters<int8_t, true>(smem)
                                 : resident_clusters<int8_t, false>(smem);
  return vec ? resident_clusters<int32_t, true>(smem) : resident_clusters<int32_t, false>(smem);
}
