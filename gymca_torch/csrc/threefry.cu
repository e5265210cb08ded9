// The key chain's threefry2x32 on the card: one launch per public draw of
// gymca_torch/rng.py (split, fold_in, random_bits, uniform, randint).
//
// Replaces no TPU kernel: the JAX package draws its keys through plain XLA
// (jax 0.9.0's threefry2x32 with jax_threefry_partitionable=True and x64 off,
// jax/_src/prng.py).  The port's eager version (rng.py::threefry_plain) runs
// a hash as ~170 int64 torch operations, each masked back to 32 bits, so a
// draw on the card cost hundreds of launches of host time.  This kernel is
// the same function in one launch, in native uint32 registers.
//
// For each key r of `rows` (the words keys[r * rs] and keys[r * rs + cs],
// int64 holding uint32) and each c in [0, count), with
// (x0, x1) = threefry2x32(key, counter (0, base + c)), it writes
//   kKeys    (rows, count, 2) int64 (x0, x1): split (base 0) and fold_in
//            (base = data, count 1);
//   kBits    (rows, count) int64 x0 ^ x1: random_bits;
//   kUniform (rows, count) float32 from those bits: (bits >> 9) under 1.0f's
//            exponent, minus 1, then max(fma(f, scale, lo), lo) when
//            `affine` (one rounding, as XLA's contracted multiply-add);
//   kRandint (rows, count) int32: the key split into two keys (counters 0
//            and 1), each one's bits at c, then random.py::_randint's
//            arithmetic in uint32: minval + ((hi % span) * mult + lo % span)
//            % span.
//
// What bounds it on an H100: the launch, for the key chain's draws of one
// to a few per key over 4096 keys or fewer; int32 ALU for large draws
// (a fresh grid's 4.19 M uniforms): a hash is 20 rounds of add, rotate and
// xor plus 6 key injections, 73 integer operations, and a uniform's bits
// 3 more, against 4 bytes written an element.  The design: one thread
// per output element in a grid-stride loop over rows * count (32-bit
// indices below 2**31 elements); the key schedule in registers; each
// rotation one funnel shift by a constant; stores coalesced, a key pair as
// one 16-byte store.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads, the most an SM holds
constexpr int kMaxDevices = 64;

enum Form { kKeys = 0, kBits = 1, kUniform = 2, kRandint = 3 };

struct Params {
  float lo, scale;
  int affine;
  uint32_t span, mult;
  int32_t minval;
};

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int a, int b, int c,
                                       int d) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, a) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, b) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, c) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, d) ^ x0;
}

// threefry2x32 of counter (x0, x1) under key (k0, k1), in place
// (prng.py::_threefry2x32_lowering).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint32_t c) {
  uint32_t x0 = 0u, x1 = c;
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

template <int kForm, typename I>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const long long* __restrict__ keys, long long rs, long long cs, I total,
                I count, uint32_t base, void* __restrict__ out, Params p) {
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (I)gridDim.x * kThreads) {
    const I row = i / count;
    const uint32_t c = base + (uint32_t)(i - row * count);
    const long long* key = keys + (long long)row * rs;
    const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[cs];
    if (kForm == kRandint) {
      uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 1u;
      threefry(k0, k1, h0, h1);
      threefry(k0, k1, l0, l1);
      const uint32_t higher = bits_at(h0, h1, c), lower = bits_at(l0, l1, c);
      const uint32_t offset = (higher % p.span) * p.mult + lower % p.span;
      static_cast<int32_t*>(out)[i] = (int32_t)((uint32_t)p.minval + offset % p.span);
    } else if (kForm == kKeys) {
      uint32_t x0 = 0u, x1 = c;
      threefry(k0, k1, x0, x1);
      static_cast<longlong2*>(out)[i] = make_longlong2(x0, x1);
    } else {
      const uint32_t b = bits_at(k0, k1, c);
      if (kForm == kBits) {
        static_cast<long long*>(out)[i] = b;
      } else {
        float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
        if (p.affine) f = fmaxf(__fmaf_rn(f, p.scale, p.lo), p.lo);
        static_cast<float*>(out)[i] = f;
      }
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) cached[dev] = n;
  return n;
}

template <int kForm>
void launch(const long long* keys, long long rs, long long cs, unsigned long long total,
            unsigned long long count, uint32_t base, void* out, Params p, int blocks,
            cudaStream_t s) {
  if (total <= 0x7FFFFFFFull)  // i + the grid's stride stays below 2**32
    threefry_kernel<kForm, uint32_t><<<blocks, kThreads, 0, s>>>(
        keys, rs, cs, (uint32_t)total, (uint32_t)count, base, out, p);
  else
    threefry_kernel<kForm, unsigned long long><<<blocks, kThreads, 0, s>>>(
        keys, rs, cs, total, count, base, out, p);
}

}  // namespace

// Launches the hash of counters base .. base + count - 1 under each of
// `rows` keys on `stream`, written in form `form` (see above) to `out`, a
// contiguous buffer of rows * count elements of the form's type (two int64
// each for kKeys).  Key r's words are keys[r * rs] and keys[r * rs + cs]
// (int64, strides in elements).  base + count <= 2**32.  kUniform reads lo,
// scale and affine; kRandint reads span (>= 1), mult and minval.  Returns
// the cudaError_t of the launch (0 when there is nothing to launch).
extern "C" int threefry_launch(const void* keys, long long rows, long long rs, long long cs,
                               long long count, unsigned int base, int form, void* out,
                               float lo, float scale, int affine, unsigned int span,
                               unsigned int mult, int minval, void* stream) {
  if (rows <= 0 || count <= 0) return 0;
  if (form == kRandint && span == 0u) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned long long total = (unsigned long long)rows * (unsigned long long)count;
  const unsigned long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (unsigned long long)sms * kBlocksPerSm
                               ? want : (unsigned long long)sms * kBlocksPerSm);
  const Params p{lo, scale, affine, span, mult, minval};
  const long long* k = static_cast<const long long*>(keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kKeys: launch<kKeys>(k, rs, cs, total, count, base, out, p, blocks, s); break;
    case kBits: launch<kBits>(k, rs, cs, total, count, base, out, p, blocks, s); break;
    case kUniform: launch<kUniform>(k, rs, cs, total, count, base, out, p, blocks, s); break;
    case kRandint: launch<kRandint>(k, rs, cs, total, count, base, out, p, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
