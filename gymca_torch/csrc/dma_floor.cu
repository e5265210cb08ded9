// S6: the streaming floor of the Alexandridis step.
//
// Replaces the TPU probe scripts/bench_fused_ca.py::dma_floor: a kernel
// that moves exactly the bytes the Alexandridis kernel (alexandridis.cu)
// must move and computes nothing, so its time is the least the card takes to
// move them.  For every env e of (N, H, W):
//   out_grid = grid, out_age = age + 1                  (int8, float32)
// and it reads what the step reads besides: dousing (int8), vdf (bfloat16),
// the 8 direction planes of exp_slope (N, 3, 3, H, W) bfloat16 (the centre
// plane is no input of the step and is not read), wind (N, 8) float32 and
// seeds (N, 2) int64: 29 bytes per cell and 48 per env.  So that the compiler
// keeps those loads, their 32-bit words are XOR-ed into fold[e] (int32,
// zero on entry; XOR is order-free, so the atomics across blocks give one
// answer).
//
// What bounds it: bytes, by construction.  A block takes one env's span of
// 16 * 256 cells; each stream of the span is read (and written) as 16-byte
// vectors, consecutive lanes on consecutive vectors, and every load of a
// thread is issued before any of its values is used.  Planes of H * W cells
// must hold whole vectors: H * W % 16 == 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 16 * kThreads;  // cells of one env per block

__device__ __forceinline__ uint32_t xor4(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }

__device__ __forceinline__ uint4 plus_one(uint4 v) {
  return make_uint4(__float_as_uint(__fadd_rn(__uint_as_float(v.x), 1.0f)),
                    __float_as_uint(__fadd_rn(__uint_as_float(v.y), 1.0f)),
                    __float_as_uint(__fadd_rn(__uint_as_float(v.z), 1.0f)),
                    __float_as_uint(__fadd_rn(__uint_as_float(v.w), 1.0f)));
}

__global__ void __launch_bounds__(kThreads)
dma_floor_kernel(const uint4* __restrict__ grid, const uint4* __restrict__ age,
                 const uint4* __restrict__ dous, const uint4* __restrict__ vdf,
                 const uint4* __restrict__ slope, const uint32_t* __restrict__ wind,
                 const uint32_t* __restrict__ seeds, uint4* __restrict__ out_grid,
                 uint4* __restrict__ out_age, int* __restrict__ fold, int plane) {
  const int e = blockIdx.y, t = threadIdx.x;
  const int first = blockIdx.x * kSpan;                // first cell of the span in the env
  const int cells = min(kSpan, plane - first);         // a multiple of 16
  const size_t at = (size_t)e * plane + first;         // first cell of the span
  // Vectors per stream in the span: 16 cells (int8), 8 (bfloat16), 4 (float32).
  const int n8 = cells / 16, n16 = cells / 8, n32 = cells / 4;
  uint4 g = {}, d = {}, a[4] = {}, v[2] = {}, s[8][2] = {};
  const bool has8 = t < n8;
  if (has8) {
    g = grid[at / 16 + t];
    d = dous[at / 16 + t];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (t + i * kThreads < n32) a[i] = age[at / 4 + t + i * kThreads];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (t + i * kThreads < n16) v[i] = vdf[at / 8 + t + i * kThreads];
#pragma unroll
  for (int k = 0, p = 0; k < 9; ++k) {
    if (k == 4) continue;  // the centre plane
    const size_t base = (((size_t)e * 9 + k) * plane + first) / 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (t + i * kThreads < n16) s[p][i] = slope[base + t + i * kThreads];
    ++p;
  }
  if (has8) out_grid[at / 16 + t] = g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (t + i * kThreads < n32) out_age[at / 4 + t + i * kThreads] = plus_one(a[i]);
  uint32_t acc = xor4(d) ^ xor4(v[0]) ^ xor4(v[1]);  // lanes past the span hold zeros
#pragma unroll
  for (int p = 0; p < 8; ++p) acc ^= xor4(s[p][0]) ^ xor4(s[p][1]);
  if (blockIdx.x == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc ^= wind[8 * e + i];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc ^= seeds[4 * e + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (t % 32 == 0 && acc != 0) atomicXor(fold + e, int(acc));
}

}  // namespace

// Launches the probe on `stream`; returns the launch's cudaError_t (0 on
// success).  grid, dous, out_grid: (n, h, w) int8; age, out_age: (n, h, w)
// float32; vdf (n, h, w) and exp_slope (n, 3, 3, h, w) bfloat16; wind (n, 8)
// float32; seeds (n, 2) int64; fold (n,) int32 zeros; all contiguous on the
// device and 16-byte aligned; h * w % 16 == 0.
extern "C" int dma_floor_launch(const void* grid, const void* age, const void* dous,
                                const void* vdf, const void* exp_slope, const void* wind,
                                const void* seeds, void* out_grid, void* out_age, void* fold,
                                int n, int h, int w, void* stream) {
  if (n <= 0) return 0;
  const long long plane = (long long)h * w;
  if (plane % 16 != 0 || plane <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(int((plane + kSpan - 1) / kSpan), n);
  dma_floor_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(grid), static_cast<const uint4*>(age),
      static_cast<const uint4*>(dous), static_cast<const uint4*>(vdf),
      static_cast<const uint4*>(exp_slope), static_cast<const uint32_t*>(wind),
      static_cast<const uint32_t*>(seeds), static_cast<uint4*>(out_grid),
      static_cast<uint4*>(out_age), static_cast<int*>(fold), int(plane));
  return cudaGetLastError();
}
