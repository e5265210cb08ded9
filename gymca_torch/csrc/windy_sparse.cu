// K1: the sparse windy-Bulldozer step, one thread block per env.
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
// operations per cell.  The design keeps device-memory traffic at that
// minimum and the arithmetic word-parallel:
//   * the block stages its env as two bit masks in shared memory (tree, fire;
//     one bit per cell, 32 cells per word: 16 KiB at 256x256), so the stencil
//     reads neighbours from shared memory and never from device memory again;
//   * loads and stores are 16-byte vectors, lane-contiguous across the warp,
//     several in flight per thread (rows of a multiple of 32 cells; other
//     widths take a one-cell-per-lane path);
//   * the stencil is the boolean "any gusted fire neighbour" form of the
//     windy score decode, on 32-cell words: three row bands combined per
//     column shift, then one funnel of shifts across word borders;
//   * idle envs cost one block that reads its params and exits; skipped grids
//     are never read or written.
// Grids whose two bit masks exceed the 227 KiB of shared memory a block may
// use (8 * H * ceil(W / 32) bytes: 16 KiB at 256x256 int8 or int32, too much
// from about 1024x1024) are rejected by the wrapper, not banded.
// The grid is updated in place, as the reference aliases it in -> out: every
// read of an env's grid happens before the block's first barrier, every write
// after it, and no other block touches that env.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // slices each thread loads before it converts them

// A lane's slice of a 32-cell word: PER cells, one 16-byte vector (VEC) or
// one cell.  G lanes share a word; slot q covers bits [sub*PER, sub*PER+PER)
// of word q / G, sub = q % G.
template <typename T, bool VEC>
struct Slice {
  static constexpr int PER = VEC ? 16 / int(sizeof(T)) : 1;
  static constexpr int G = 32 / PER;
};

// Loads slot q's cells into `raw` (a 16-byte vector, or the cell itself in
// raw.x); false when the slot lies past the grid or its row.
template <typename T, bool VEC>
__device__ __forceinline__ bool slice_load(const T* g, int q, int nslots, int w, int ww,
                                           uint4& raw) {
  using S = Slice<T, VEC>;
  if (q >= nslots) return false;
  const int word = q / S::G, sub = q % S::G;
  if (VEC) {
    raw = *reinterpret_cast<const uint4*>(g + (size_t)word * 32 + sub * S::PER);
    return true;
  }
  const int r = word / ww, col = (word - r * ww) * 32 + sub;
  if (col >= w) return false;
  *reinterpret_cast<T*>(&raw) = g[(size_t)r * w + col];
  return true;
}

template <typename T, bool VEC>
__device__ __forceinline__ void slice_store(T* g, int q, int w, int ww,
                                            const T (&cells)[Slice<T, VEC>::PER]) {
  using S = Slice<T, VEC>;
  const int word = q / S::G, sub = q % S::G;
  if (VEC) {
    uint4 v;
    T* c = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int b = 0; b < S::PER; ++b) c[b] = cells[b];
    *reinterpret_cast<uint4*>(g + (size_t)word * 32 + sub * S::PER) = v;
    return;
  }
  const int r = word / ww, col = (word - r * ww) * 32 + sub;
  if (col < w) g[(size_t)r * w + col] = cells[0];
}

// OR of v over the G lanes that share a word (G divides 32; groups aligned).
template <int G>
__device__ __forceinline__ uint32_t group_or(uint32_t v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t fire_word(const uint32_t* fire_m, int r, int j,
                                              int h, int ww) {
  return (r >= 0 && r < h && j >= 0 && j < ww) ? fire_m[r * ww + j] : 0u;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
windy_sparse_kernel(T* __restrict__ grid, const int* __restrict__ weights,
                    const int* __restrict__ params, const int* __restrict__ edits,
                    const int* __restrict__ edit_counts, int* __restrict__ counts,
                    int h, int w, int k, int empty, int tree, int fire) {
  using S = Slice<T, VEC>;
  extern __shared__ uint32_t smem[];
  __shared__ int s_tree, s_fire, s_hit;

  const int e = blockIdx.x;
  const int do_ca = params[e * 4 + 0];
  const int row = params[e * 4 + 1], col = params[e * 4 + 2];
  const bool shoot = params[e * 4 + 3] > 0;
  T* g = grid + (size_t)e * h * w;
  const T t_empty = T(empty), t_tree = T(tree), t_fire = T(fire);

  if (!do_ca) {
    if (threadIdx.x == 0) {
      int hit = 0;
      if (shoot) {
        T* cell = g + (size_t)row * w + col;
        if (*cell == t_tree) {
          *cell = t_empty;
          hit = 1;
        }
      }
      counts[e * 3 + 0] = 0;
      counts[e * 3 + 1] = 0;
      counts[e * 3 + 2] = hit;
    }
    return;
  }

  const int ww = (w + 31) >> 5;  // 32-cell words per row
  const int nwords = h * ww;
  const int nslots = nwords * S::G;
  uint32_t* tree_m = smem;
  uint32_t* fire_m = smem + nwords;
  if (threadIdx.x == 0) {
    s_tree = 0;
    s_fire = 0;
    s_hit = 0;
  }

  // 1. Stage the grid as tree / fire bit masks (cells past the row end stay 0).
  for (int q0 = 0; q0 < nslots; q0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ok[u] = slice_load<T, VEC>(g, q0 + u * kThreads + threadIdx.x, nslots, w, ww, raw[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads + threadIdx.x;
      uint32_t tb = 0, fb = 0;
      if (ok[u]) {
        const T* cells = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int b = 0; b < S::PER; ++b) {
          tb |= uint32_t(cells[b] == t_tree) << b;
          fb |= uint32_t(cells[b] == t_fire) << b;
        }
        const int shift = (q % S::G) * S::PER;
        tb <<= shift;
        fb <<= shift;
      }
      tb = group_or<S::G>(tb);  // every lane of the warp takes part
      fb = group_or<S::G>(fb);
      if (q < nslots && q % S::G == 0) {
        tree_m[q / S::G] = tb;
        fire_m[q / S::G] = fb;
      }
    }
  }
  __syncthreads();

  // 2. Replay the deferred edits: each empties one cell before the stencil.
  const int n_edits = min(edit_counts[e], k);
  for (int i = threadIdx.x; i < n_edits; i += kThreads) {
    const int wrd = edits[(size_t)e * k + i];
    const int r = wrd & 0xFFFF, c = wrd >> 16;
    if (r < h && c >= 0 && c < w) {
      const uint32_t keep = ~(1u << (c & 31));
      atomicAnd(&tree_m[r * ww + (c >> 5)], keep);
      atomicAnd(&fire_m[r * ww + (c >> 5)], keep);
    }
  }
  __syncthreads();

  // 3. Stencil, decode, shot, counts and write-back, one lane slice at a time.
  uint32_t gate[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) gate[i] = weights[e * 8 + i] > 0 ? ~0u : 0u;
  // NEIGHBOR_OFFSETS order: (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1)
  int my_tree = 0, my_fire = 0;
  for (int q = threadIdx.x; q < nslots; q += kThreads) {
    const int word = q / S::G, sub = q % S::G;
    const int r = word / ww, j = word - r * ww;
    // pre_m / pre_p: fire neighbours at column offset -1 / +1, by word column.
    uint32_t pre_m[3], pre_p[3];  // word columns j-1, j, j+1
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const uint32_t up = fire_word(fire_m, r - 1, j - 1 + x, h, ww);
      const uint32_t mid = fire_word(fire_m, r, j - 1 + x, h, ww);
      const uint32_t dn = fire_word(fire_m, r + 1, j - 1 + x, h, ww);
      pre_m[x] = (up & gate[0]) | (mid & gate[3]) | (dn & gate[5]);
      pre_p[x] = (up & gate[2]) | (mid & gate[4]) | (dn & gate[7]);
    }
    const uint32_t acc = (fire_word(fire_m, r - 1, j, h, ww) & gate[1]) |
                         (fire_word(fire_m, r + 1, j, h, ww) & gate[6]) |
                         (pre_p[1] >> 1) | (pre_p[2] << 31) |
                         (pre_m[1] << 1) | (pre_m[0] >> 31);
    const uint32_t tw = tree_m[word];
    const uint32_t burn = tw & acc;
    uint32_t keep = tw & ~acc;
    const uint32_t mine = ((1u << S::PER) - 1u) << (sub * S::PER);  // PER <= 16
    if (shoot && r == row && j == (col >> 5)) {
      const uint32_t bit = 1u << (col & 31);
      if ((bit & mine) && (keep & bit)) {
        keep &= ~bit;
        s_hit = 1;
      }
    }
    my_tree += __popc(keep & mine);
    my_fire += __popc(burn & mine);
    T cells[S::PER];
#pragma unroll
    for (int b = 0; b < S::PER; ++b) {
      const int bit = sub * S::PER + b;
      cells[b] = ((burn >> bit) & 1u) ? t_fire : (((keep >> bit) & 1u) ? t_tree : t_empty);
    }
    slice_store<T, VEC>(g, q, w, ww, cells);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    my_tree += __shfl_xor_sync(0xffffffffu, my_tree, o);
    my_fire += __shfl_xor_sync(0xffffffffu, my_fire, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_tree, my_tree);
    atomicAdd(&s_fire, my_fire);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    counts[e * 3 + 0] = s_tree;
    counts[e * 3 + 1] = s_fire;
    counts[e * 3 + 2] = s_hit;
  }
}

template <typename T, bool VEC>
cudaError_t launch(void* grid, const void* weights, const void* params, const void* edits,
                   const void* edit_counts, void* counts, int n, int h, int w, int k,
                   int empty, int tree, int fire, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(uint32_t) * (size_t)h * ((w + 31) / 32);
  auto kernel = windy_sparse_kernel<T, VEC>;
  // Only grids past 48 KiB of masks (W * H > 196608 cells) need the opt-in;
  // 256x256 takes 16 KiB and skips this call on the hot path.
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n, kThreads, smem, stream>>>(
      static_cast<T*>(grid), static_cast<const int*>(weights), static_cast<const int*>(params),
      static_cast<const int*>(edits), static_cast<const int*>(edit_counts),
      static_cast<int*>(counts), h, w, k, empty, tree, fire);
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream`; returns the launch's cudaError_t (0 on success).
// grid: (n, h, w) int8 (itemsize 1) or int32 (itemsize 4), updated in place;
// weights (n, 8), params (n, 4) [do_ca, row, col, shoot], edits (n, k),
// edit_counts (n,), counts (n, 3): all int32, contiguous, on the device.
extern "C" int windy_sparse_launch(void* grid, int itemsize, const void* weights,
                                   const void* params, const void* edits,
                                   const void* edit_counts, void* counts, int n, int h,
                                   int w, int k, int empty, int tree, int fire,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (w % 32 == 0) && (reinterpret_cast<uintptr_t>(grid) % 16 == 0);
  if (itemsize == 1)
    return vec ? launch<int8_t, true>(grid, weights, params, edits, edit_counts, counts, n, h,
                                      w, k, empty, tree, fire, s)
               : launch<int8_t, false>(grid, weights, params, edits, edit_counts, counts, n,
                                       h, w, k, empty, tree, fire, s);
  if (itemsize == 4)
    return vec ? launch<int32_t, true>(grid, weights, params, edits, edit_counts, counts, n,
                                       h, w, k, empty, tree, fire, s)
               : launch<int32_t, false>(grid, weights, params, edits, edit_counts, counts, n,
                                        h, w, k, empty, tree, fire, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
