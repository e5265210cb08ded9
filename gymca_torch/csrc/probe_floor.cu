// S1, S2, S3 and S5: the launch floor of a kernel over N envs, by envs per
// block, parameter table and count output layout.
//
// Replaces the TPU probes scripts/exp_counts_out.py (build_w1, build_dma),
// scripts/exp_launch_floor.py (run_launch, make_run_launch, run_smem_only),
// scripts/exp_kernel_overhead.py (make_noop, make_noop_fori) and
// scripts/exp_floor.py (build): no-op kernels over K1's (N, 256, 256) int8
// grid, aliased and never touched, that differ in what each program reads
// and writes.  Here one kernel covers the family, with runtime arguments:
//   envs_per_block  B, the envs one block walks (a program's block on the
//                   TPU);
//   table_w         0, 1, 8 or 16 int32 params per env, read by the env's
//                   thread (on the TPU an SMEM block the pipeline moved
//                   whether the body read it or not; an unused pointer costs
//                   the card nothing, so the reads are made explicit and
//                   kept alive);
//   counts_w        0, 1 or 4 int32 counts per env written: [p[e, 4],
//                   p[e, 5], 0, 0] where table_w >= 6 (exp_kernel_overhead's
//                   function), else [1, 0, 0, 0].  On the TPU only each
//                   program's first slot was defined and the rest of the
//                   output was whatever was there; every slot here is
//                   written, a defined superset;
//   staged          the counterpart of build_dma: the block builds its counts
//                   in shared memory and writes them with one bulk copy
//                   (cp.async.bulk, shared -> global, TMA), which needs
//                   B * counts_w and N * counts_w to be multiples of 4 (16-byte
//                   sizes and addresses).
// The grid pointer is passed and never dereferenced: the counterpart of
// pl.ANY plus aliasing.
//
// What bounds it: the launch itself, up to a few hundred envs per block.
// Its bytes (the table read, the counts written) take well under a
// microsecond at 4096 envs across the card.  Where one block walks thousands
// of envs (S3's 4096 envs per block), the work is confined to one SM by the
// probe's definition: the bound is then the launch floor plus the bytes at
// the bandwidth one SM reaches, and what stands between the two is memory
// latency.  So a block takes up to 1024 threads, and each thread issues the
// table loads of all its envs in a batch (up to 8 16-byte loads: 4 envs of
// an 8-wide row, 2 of a 16-wide one) before any store, then writes each
// env's counts, 4 of them as one int4.  At 4096 envs a block that is one
// pass of loads and one of stores, not 16 dependent passes.  The staged form
// keeps its one bulk copy a block.
//
// one_sm_copy_kernel is no probe but the yardstick of that bound: the rate
// one SM reaches, measured with a loader that owes nothing to the probe.
// One block, one thread driving the bulk-copy engine (TMA), copies `bytes`
// from `src` to `dst` through kCopyStages shared-memory stages of
// kCopyChunk bytes: each chunk comes in by cp.async.bulk on its stage's
// mbarrier and goes out by a bulk store, and a stage is refilled once its
// store has read it, so the loads and stores of different chunks are in
// flight together.  No thread touches the data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kVectorsInFlight = 8;  // 16-byte table loads a thread issues before it stores

// Every loaded word is folded into a value that a store the host never asks
// for (counts_w < 0) would write, so no load is dropped as unused.
template <int TW>
__global__ void __launch_bounds__(kMaxThreads)
probe_floor_kernel(const int8_t* grid, const int* __restrict__ table, int* __restrict__ counts,
                   int n, int envs_per_block, int counts_w, int staged) {
  constexpr int NV = TW > 1 ? TW / 4 : 1;                       // 16-byte vectors a row
  constexpr int BATCH = TW > 1 ? kVectorsInFlight / NV : 4;     // envs a thread loads at once
  extern __shared__ int4 staged_counts[];
  int* sc = reinterpret_cast<int*>(staged_counts);
  (void)grid;
  const int e0 = blockIdx.x * envs_per_block;
  const int nb = min(envs_per_block, n - e0);
  int fold = 0;
  for (int i0 = 0; i0 < nb; i0 += BATCH * blockDim.x) {
    // 1. Every load of the batch, then 2. every store.
    int4 v[BATCH][NV];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * blockDim.x + threadIdx.x;
      if (i >= nb) continue;
      const int e = e0 + i;
      if (TW == 1) {
        v[b][0].x = table[e];
      } else if (TW > 1) {  // 8 or 16: whole 16-byte vectors
        const int4* row = reinterpret_cast<const int4*>(table + (size_t)e * TW);
#pragma unroll
        for (int q = 0; q < NV; ++q) v[b][q] = row[q];
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * blockDim.x + threadIdx.x;
      if (i >= nb) continue;
      const int e = e0 + i;
      int c0 = 1, c1 = 0;
      if (TW == 1) fold ^= v[b][0].x;
      if (TW > 1) {
        c0 = v[b][1].x;
        c1 = v[b][1].y;
#pragma unroll
        for (int q = 0; q < NV; ++q) fold ^= v[b][q].x ^ v[b][q].y ^ v[b][q].z ^ v[b][q].w;
      }
      if (counts_w == 1) {
        if (staged) sc[i] = c0;
        else counts[e] = c0;
      } else if (counts_w == 4) {
        const int4 c = make_int4(c0, c1, 0, 0);
        if (staged) staged_counts[i] = c;
        else reinterpret_cast<int4*>(counts)[e] = c;
      }
    }
  }
  if (counts_w < 0) counts[0] = fold;
  if (staged && counts_w > 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(sc));
      int* dst = counts + (size_t)e0 * counts_w;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(dst), "r"(src), "r"(nb * counts_w * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  }
}

using Kernel = void (*)(const int8_t*, const int*, int*, int, int, int, int);

constexpr int kCopyChunk = 16 * 1024;
constexpr int kCopyStages = 8;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Arms `bar` for `bytes` and copies them from global `src` to shared `dst`.
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

__global__ void one_sm_copy_kernel(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                                   long long bytes) {
  extern __shared__ __align__(128) int8_t stage[];
  __shared__ __align__(8) uint64_t full[kCopyStages];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kCopyStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(&full[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const long long chunks = (bytes + kCopyChunk - 1) / kCopyChunk;
  auto size = [&](long long c) {
    const long long left = bytes - c * kCopyChunk;
    return static_cast<uint32_t>(left < kCopyChunk ? left : kCopyChunk);
  };
  auto load = [&](long long c) {
    const int s = c % kCopyStages;
    bulk_load(stage + s * kCopyChunk, src + c * kCopyChunk, size(c), &full[s]);
  };
  for (long long c = 0; c < chunks && c < kCopyStages; ++c) load(c);
  for (long long c = 0; c < chunks; ++c) {
    const int s = c % kCopyStages;
    barrier_wait(&full[s], static_cast<uint32_t>((c / kCopyStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + c * kCopyChunk), "r"(shared_addr(stage + s * kCopyChunk)),
                 "r"(size(c)) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // Refill the stage of chunk c - 1 once its store (all but chunk c's) has
    // read it.
    if (c >= 1 && c - 1 + kCopyStages < chunks) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(c - 1 + kCopyStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

Kernel kernel_for(int table_w) {
  switch (table_w) {
    case 0: return probe_floor_kernel<0>;
    case 1: return probe_floor_kernel<1>;
    case 8: return probe_floor_kernel<8>;
    case 16: return probe_floor_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

// Launches the probe on `stream`; returns the launch's cudaError_t (0 on
// success).  table: (n, table_w) int32 or null when table_w == 0; counts:
// (n, counts_w) int32 or null when counts_w == 0; both contiguous on the
// device, 16-byte aligned.
extern "C" int probe_floor_launch(const void* grid, const void* table, void* counts, int n,
                                  int envs_per_block, int table_w, int counts_w, int staged,
                                  void* stream) {
  if (n <= 0) return 0;
  const bool bad_table = table_w != 0 && table_w != 1 && table_w != 8 && table_w != 16;
  const bool bad_counts = counts_w != 0 && counts_w != 1 && counts_w != 4;
  const bool bad_staged =
      staged && ((envs_per_block * counts_w) % 4 != 0 || ((long long)n * counts_w) % 4 != 0);
  if (envs_per_block < 1 || bad_table || bad_counts || bad_staged ||
      (table_w > 0) != (table != nullptr) || (counts_w > 0) != (counts != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kernel_for(table_w);
  const int smem = staged ? envs_per_block * counts_w * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads =
      envs_per_block < kMaxThreads ? (envs_per_block + 31) / 32 * 32 : kMaxThreads;
  const int blocks = (n + envs_per_block - 1) / envs_per_block;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(grid), static_cast<const int*>(table),
      static_cast<int*>(counts), n, envs_per_block, counts_w, staged);
  return cudaGetLastError();
}

// Launches one_sm_copy_kernel on `stream`: one block copies `bytes` from
// `src` to `dst` (both 16-byte aligned on the device, bytes a multiple of
// 16); returns the launch's cudaError_t (0 on success).
extern "C" int one_sm_copy_launch(const void* src, void* dst, long long bytes, void* stream) {
  if (bytes <= 0) return 0;
  if (bytes % 16 || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kCopyStages * kCopyChunk;
  const cudaError_t err = cudaFuncSetAttribute(
      one_sm_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  one_sm_copy_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(src), static_cast<int8_t*>(dst), bytes);
  return cudaGetLastError();
}
