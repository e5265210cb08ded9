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
// What bounds it: the launch itself.  Its bytes (the table read, the counts
// written) take well under a microsecond at 4096 envs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// Keeps a loaded value alive without using it.
__device__ __forceinline__ void keep(int v) { asm volatile("" ::"r"(v)); }

__global__ void __launch_bounds__(kMaxThreads)
probe_floor_kernel(const int8_t* grid, const int* __restrict__ table, int* __restrict__ counts,
                   int n, int envs_per_block, int table_w, int counts_w, int staged) {
  extern __shared__ int4 staged_counts[];
  int* sc = reinterpret_cast<int*>(staged_counts);
  (void)grid;
  const int e0 = blockIdx.x * envs_per_block;
  const int nb = min(envs_per_block, n - e0);
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const int e = e0 + i;
    int c0 = 1, c1 = 0;
    if (table_w == 1) {
      keep(table[e]);
    } else if (table_w > 1) {  // 8 or 16: whole 16-byte vectors
      const int4* row = reinterpret_cast<const int4*>(table + (size_t)e * table_w);
      for (int q = 0; q < table_w / 4; ++q) {
        const int4 v = row[q];
        if (q == 1) {
          c0 = v.x;
          c1 = v.y;
        }
        keep(v.x ^ v.y ^ v.z ^ v.w);
      }
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
  const int smem = staged ? envs_per_block * counts_w * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = envs_per_block < kMaxThreads ? (envs_per_block + 31) / 32 * 32 : kMaxThreads;
  const int blocks = (n + envs_per_block - 1) / envs_per_block;
  probe_floor_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(grid), static_cast<const int*>(table),
      static_cast<int*>(counts), n, envs_per_block, table_w, counts_w, staged);
  return cudaGetLastError();
}
