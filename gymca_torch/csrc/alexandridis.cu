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
// What bounds it on an H100: bytes.  Per cell it must read the grid (1 B),
// age (4), dousing (1), vdf (2) and the 8 direction planes of exp_slope
// (16; the centre plane is never read) and write grid (1) and age (4):
// 29 B, 122 MB per launch at 64 x 256^2.  The operations, mostly the 20
// threefry rounds, take about three quarters of that time at the card's
// int32 rate.  The design reads each input once from device memory:
//   * a block stages its tile's fire and dousing masks with an R-cell halo
//     (R = max(radius, 2); out-of-grid halo cells read as zero, the tiled
//     TPU kernel's masking) as two integer summed-area tables in shared
//     memory, so every box sum is four shared-memory reads;
//   * the fire neighbours of the ignition test come from the staged mask;
//   * age, vdf and exp_slope are read once, lane-contiguous across a warp.
// Simple first: no TMA, no vector loads, no tensor cores (the TPU kernel's
// banded matmuls were a TPU schedule for box sums, not a matrix product).
//
// Ablations, the counterpart of the TPU kernel's `ablate` (profiling only,
// outputs wrong by construction; the env never asks for them), each a
// compile-time instance that skips one phase so the phase's time shows:
//   kBoxes   heat = 8 * fire and dousing = the dousing mask of the cell
//            itself: no summed-area tables;
//   kIgnite  no_ignite = max(1 - 0.1 * base, 0): no exp_slope reads, no
//            8-direction product;
//   kPrng    u = 0.5 and new ages = age_min: no threefry.
// Instance kNone is the step itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kMaxRadius = 32;

enum { kNone = 0, kBoxes = 1, kIgnite = 2, kPrng = 3 };

// Moore offsets in NEIGHBOR_OFFSETS order.
__constant__ int kDr[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDc[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

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

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(uint32_t(b) << 16);
}

template <int kAblate>
__global__ void __launch_bounds__(kThreads)
alexandridis_kernel(const int8_t* __restrict__ grid, const float* __restrict__ age,
                    const int8_t* __restrict__ dous, const uint16_t* __restrict__ vdf,
                    const uint16_t* __restrict__ exp_slope, const float* __restrict__ wind,
                    const uint32_t* __restrict__ seeds, int8_t* __restrict__ out_grid,
                    float* __restrict__ out_age, int h, int w, const Params p) {
  extern __shared__ int smem[];
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int halo = p.halo;
  const int eh = kTileH + 2 * halo, ew = kTileW + 2 * halo;
  const int sw = ew + 1;  // summed-area tables carry a zero row and column
  int* sat_f = smem;
  int* sat_d = sat_f + (eh + 1) * sw;
  int8_t* fire_m = reinterpret_cast<int8_t*>(sat_d + (eh + 1) * sw);
  const size_t plane = (size_t)h * w;
  const int8_t* g = grid + (size_t)e * plane;
  const int8_t* d = dous + (size_t)e * plane;

  // 1. Stage the masks of the tile and its halo; zero outside the grid.
  if constexpr (kAblate != kBoxes) {
    for (int i = threadIdx.x; i < sw; i += kThreads) {
      sat_f[i] = 0;
      sat_d[i] = 0;
    }
    for (int i = threadIdx.x; i < eh; i += kThreads) {
      sat_f[(i + 1) * sw] = 0;
      sat_d[(i + 1) * sw] = 0;
    }
  }
  for (int idx = threadIdx.x; idx < eh * ew; idx += kThreads) {
    const int i = idx / ew, j = idx - i * ew;
    const int gr = r0 - halo + i, gc = c0 - halo + j;
    int f = 0, dd = 0;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
      const size_t at = (size_t)gr * w + gc;
      f = g[at] == p.fire;
      if constexpr (kAblate != kBoxes) dd = d[at] > 0;
    }
    fire_m[idx] = int8_t(f);
    if constexpr (kAblate != kBoxes) {
      sat_f[(i + 1) * sw + j + 1] = f;
      sat_d[(i + 1) * sw + j + 1] = dd;
    }
  }
  __syncthreads();

  // 2. Summed-area tables: running sums along rows, then down columns.
  if constexpr (kAblate != kBoxes) {
    for (int t = threadIdx.x; t < 2 * eh; t += kThreads) {
      int* row = (t < eh ? sat_f : sat_d) + (t % eh + 1) * sw;
      int acc = 0;
      for (int j = 1; j <= ew; ++j) {
        acc += row[j];
        row[j] = acc;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * ew; t += kThreads) {
      int* col = (t < ew ? sat_f : sat_d) + t % ew + 1;
      int acc = 0;
      for (int i = 1; i <= eh; ++i) {
        acc += col[i * sw];
        col[i * sw] = acc;
      }
    }
    __syncthreads();
  }

  // 3. The rule, one cell per thread at a time, lanes along a row.
  float wd[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) wd[k] = wind[e * 8 + k];
  const uint32_t k0 = seeds[2 * e], k1 = seeds[2 * e + 1];
  for (int cell = threadIdx.x; cell < kTileH * kTileW; cell += kThreads) {
    const int li = cell / kTileW, lj = cell - li * kTileW;
    const int gr = r0 + li, gc = c0 + lj;
    if (gr >= h || gc >= w) continue;
    const int ei = li + halo, ej = lj + halo;
    // box_r over ext rows ei-r..ei+r and columns ej-r..ej+r
#define BOX(S, r)                                                                 \
  ((S)[(ei + (r) + 1) * sw + ej + (r) + 1] - (S)[(ei - (r)) * sw + ej + (r) + 1] - \
   (S)[(ei + (r) + 1) * sw + ej - (r)] + (S)[(ei - (r)) * sw + ej - (r)])
    const size_t at = (size_t)gr * w + gc;
    const size_t cell_at = (size_t)e * plane + at;
    float heat = 0.0f, dousing;
    if constexpr (kAblate == kBoxes) {
      heat = fire_m[ei * ew + ej] ? 8.0f : 0.0f;
      dousing = d[at] > 0 ? 1.0f : 0.0f;
    } else {
      for (int r = 1; r <= p.radius; ++r)
        heat = __fadd_rn(heat, __fmul_rn(p.coeff[r - 1], float(BOX(sat_f, r))));
      dousing = __fadd_rn(__fmul_rn(p.dous_c1, float(BOX(sat_d, 1))),
                          __fmul_rn(p.dous_c2, float(BOX(sat_d, 2))));
    }
#undef BOX
    const float base = __fmul_rn(__fsub_rn(heat, dousing), bf16_to_float(vdf[cell_at]));

    float no_ignite = 1.0f;
    if constexpr (kAblate == kIgnite) {
      no_ignite = fmaxf(__fsub_rn(1.0f, __fmul_rn(base, 0.1f)), 0.0f);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dr = kDr[k], dc = kDc[k];
        const float es =
            bf16_to_float(exp_slope[((size_t)e * 9 + (1 + dr) * 3 + (1 + dc)) * plane + at]);
        const float pd = __fmul_rn(__fmul_rn(base, wd[k]), es);
        const float term = fire_m[(ei + dr) * ew + ej + dc] ? __fsub_rn(1.0f, pd) : 1.0f;
        no_ignite = __fmul_rn(no_ignite, fmaxf(term, 0.0f));
      }
    }

    uint32_t b1 = 0, b2 = 0;
    float u = 0.5f;
    if constexpr (kAblate != kPrng) {
      threefry2x32(k0, k1, 0u, uint32_t(at), b1, b2);
      u = __fmul_rn(__uint2float_rn(b1 >> 8), 5.9604644775390625e-8f);  // 2^-24
    }
    const bool ignite = u < __fsub_rn(1.0f, no_ignite);

    const int gv = g[at];
    const float a = age[cell_at];
    const bool burning = gv == p.fire;
    const int nv = (gv == p.tree && ignite) ? p.fire : ((burning && a <= 1.0f) ? p.empty : gv);
    float na = (nv == p.fire && !burning)
                   ? float(p.age_min + (kAblate == kPrng ? 0 : int(b2 % uint32_t(p.age_span))))
                   : a;
    if (burning) na = __fsub_rn(na, 1.0f);
    out_grid[cell_at] = int8_t(nv);
    out_age[cell_at] = na;
  }
}

// Shared memory of one block for a given halo: two (TH+2h+1) x (TW+2h+1)
// int32 summed-area tables and the (TH+2h) x (TW+2h) int8 fire mask.
int shared_bytes(int halo) {
  const int eh = kTileH + 2 * halo, ew = kTileW + 2 * halo;
  return 2 * (eh + 1) * (ew + 1) * (int)sizeof(int) + eh * ew;
}

}  // namespace

// Launches the step on `stream`; returns the launch's cudaError_t (0 on
// success).  grid, dous: (n, h, w) int8; age, out_age: (n, h, w) float32;
// vdf: (n, h, w) bfloat16 and exp_slope (n, 3, 3, h, w) bfloat16, as raw
// 16-bit words; wind (n, 8) float32; seeds (n, 2) uint32; out_grid (n, h, w)
// int8; all contiguous on the device.  coeff: `radius` host float32 values.
// ablate: kNone for the step, else the ablation instance to launch.
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
  const auto kernel = ablate == kBoxes    ? alexandridis_kernel<kBoxes>
                      : ablate == kIgnite ? alexandridis_kernel<kIgnite>
                      : ablate == kPrng   ? alexandridis_kernel<kPrng>
                                          : alexandridis_kernel<kNone>;
  const int smem = shared_bytes(p.halo);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 blocks((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(grid), static_cast<const float*>(age),
      static_cast<const int8_t*>(dous), static_cast<const uint16_t*>(vdf),
      static_cast<const uint16_t*>(exp_slope), static_cast<const float*>(wind),
      static_cast<const uint32_t*>(seeds), static_cast<int8_t*>(out_grid),
      static_cast<float*>(out_age), h, w, p);
  return cudaGetLastError();
}
