// S4: four formulations of one dense windy-CA step, one thread block per env.
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
// One layout for all four, so the probe compares formulations and not
// layouts: the block stages its env's grid in shared memory (64 KiB at
// 256^2; rows padded to whole words with EMPTY, which is the outside fill),
// then each thread steps whole words: it reads the 3 x 3 words around its
// word from shared memory, computes the word's four new cells and writes
// them back in place.  Every read of the env's grid in device memory happens
// before the block's first barrier, every write after it.
//
// What bounds it on an H100: bytes.  The grid is read and written once,
// 2 * H * W bytes per env; the step is a few integer operations per cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kEmpty = 0, kTree = 3, kFire = 25;
constexpr int kIdentity = 2048;
constexpr int kKeep = kIdentity * kTree;
constexpr int kPropagate = kIdentity * kTree + 8 * kFire;
constexpr int kConsume = kIdentity * kFire;
constexpr int kMaxShared = 232448 - 2 * (kThreads / 32) * 4;  // static counts below

enum { kBanded = 0, kBool = 1, kFma = 2, kSwar = 3 };

// Cell k in -1..4 of row i of the 3 x 3 word window (k = -1: the last cell
// of the left word; k = 4: the first cell of the right word).
__device__ __forceinline__ int cell(const uint32_t (&x)[3][3], int i, int k) {
  if (k < 0) return int(x[i][0] >> 24);
  if (k > 3) return int(x[i][2] & 0xFFu);
  return int((x[i][1] >> (8 * k)) & 0xFFu);
}

template <int V>
__device__ __forceinline__ uint32_t step_word(const uint32_t (&x)[3][3], const int (&wt)[8],
                                              int& trees, int& fires) {
  constexpr int dr[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  constexpr int dc[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  if constexpr (V == kSwar) {
    const uint32_t fire4 = 0x19191919u;
    uint32_t f[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) f[i][j] = __vcmpeq4(x[i][j], fire4);
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
    const uint32_t tree = __vcmpeq4(x[1][1], 0x03030303u);
    const uint32_t burn = tree & acc;
    const uint32_t keep = tree & ~burn;
    trees += __popc(keep & 0x01010101u);
    fires += __popc(burn & 0x01010101u);
    return (burn & fire4) | (keep & 0x03030303u);
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

// Sum of every thread's two counts into out[0], out[1].
__device__ __forceinline__ void block_counts(int trees, int fires, int* out) {
  __shared__ int partial[2][kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    trees += __shfl_down_sync(0xFFFFFFFFu, trees, off);
    fires += __shfl_down_sync(0xFFFFFFFFu, fires, off);
  }
  if (lane == 0) {
    partial[0][warp] = trees;
    partial[1][warp] = fires;
  }
  __syncthreads();
  if (warp == 0) {
    trees = lane < kThreads / 32 ? partial[0][lane] : 0;
    fires = lane < kThreads / 32 ? partial[1][lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      trees += __shfl_down_sync(0xFFFFFFFFu, trees, off);
      fires += __shfl_down_sync(0xFFFFFFFFu, fires, off);
    }
    if (lane == 0) {
      out[0] = trees;
      out[1] = fires;
    }
  }
}

// vec: W % 16 == 0 and the grid 16-byte aligned (staged with 16-byte
// loads); words: W % 4 == 0 and the grid 4-byte aligned (written back one
// word at a time).  Otherwise cell by cell.
template <int V>
__device__ __forceinline__ void ca_body(int8_t* __restrict__ grid,
                                        const int* __restrict__ weights,
                                        int* __restrict__ counts, int h, int w, bool vec,
                                        bool words) {
  extern __shared__ uint4 smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const int e = blockIdx.x;
  const int ww = (w + 3) / 4, pitch = 4 * ww;
  int8_t* g = grid + (size_t)e * h * w;

  // 1. Stage the grid, rows padded to whole words with EMPTY.
  if (vec) {
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    for (int i = threadIdx.x; i < h * w / 16; i += kThreads) smem[i] = g4[i];
  } else {
    uint8_t* sb = reinterpret_cast<uint8_t*>(smem);
    for (int i = threadIdx.x; i < h * pitch; i += kThreads) {
      const int r = i / pitch, col = i - r * pitch;
      sb[i] = col < w ? uint8_t(g[(size_t)r * w + col]) : uint8_t(kEmpty);
    }
  }
  int wt[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) wt[d] = weights[e * 8 + d];
  __syncthreads();

  // 2. Step word by word, in place.
  int trees = 0, fires = 0;
  for (int u = threadIdx.x; u < h * ww; u += kThreads) {
    const int r = u / ww, c = u - r * ww;
    uint32_t x[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int rr = r + i - 1;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int cc = c + j - 1;
        x[i][j] = (rr >= 0 && rr < h && cc >= 0 && cc < ww) ? s[rr * ww + cc] : 0u;
      }
    }
    const uint32_t out = step_word<V>(x, wt, trees, fires);
    if (words) {
      reinterpret_cast<uint32_t*>(g)[u] = out;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * c + k < w) g[(size_t)r * w + 4 * c + k] = int8_t(out >> (8 * k));
    }
  }
  block_counts(trees, fires, counts + 2 * e);
}

#define CA_KERNEL(NAME, V)                                                              \
  __global__ void __launch_bounds__(kThreads)                                          \
      NAME(int8_t* grid, const int* weights, int* counts, int h, int w, bool vec,       \
           bool words) {                                                                \
    ca_body<V>(grid, weights, counts, h, w, vec, words);                                \
  }

CA_KERNEL(ca_banded_kernel, kBanded)
CA_KERNEL(ca_bool_kernel, kBool)
CA_KERNEL(ca_fma_kernel, kFma)
CA_KERNEL(ca_swar_kernel, kSwar)
#undef CA_KERNEL

using Kernel = void (*)(int8_t*, const int*, int*, int, int, bool, bool);
const Kernel kKernels[4] = {ca_banded_kernel, ca_bool_kernel, ca_fma_kernel, ca_swar_kernel};

// Shared memory of one block for an h x w grid: rows padded to words.
int shared_bytes(int h, int w) { return h * 4 * ((w + 3) / 4); }

}  // namespace

// Launches formulation `variant` (0 banded, 1 bool, 2 fma, 3 swar) on
// `stream`; returns the launch's cudaError_t (0 on success).  grid: (n, h,
// w) int8, updated in place; weights (n, 8) int32; counts (n, 2) int32; all
// contiguous on the device.
extern "C" int ca_variant_launch(int variant, void* grid, const void* weights, void* counts,
                                 int n, int h, int w, void* stream) {
  if (n <= 0) return 0;
  const int smem = shared_bytes(h, w);
  if (variant < 0 || variant > 3 || h <= 0 || w <= 0 || (variant == kSwar && w % 4 != 0) ||
      smem > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kKernels[variant];
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const uintptr_t at = reinterpret_cast<uintptr_t>(grid);
  const bool vec = w % 16 == 0 && at % 16 == 0;
  const bool words = w % 4 == 0 && at % 4 == 0;
  kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(grid), static_cast<const int*>(weights), static_cast<int*>(counts),
      h, w, vec, words);
  return cudaGetLastError();
}
