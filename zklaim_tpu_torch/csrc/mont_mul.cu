// K1: the elementwise Montgomery product, and its fixed-exponent power.
//
// mont_mul
// Replaces: zklaim_tpu/ntt/pallas_ntt.py:_mul_kernel (launched by
// bulk_mul, reached through mont_mul_aos from montgomery.mont_mul_bulk).
//
// What bounds it on the card: memory traffic (3 x 64 B per element in
// the int32 16-bit-limb layout) against 136 integer multiply-adds per
// element; at main-path widths (2^15 - 2^17 elements) the device's share is
// a few microseconds and the call is the host's.  Design: one thread per
// element.  The operands the paths pass -- contiguous (N, 16) tensors, or
// one 16-limb constant for every element -- are read and written as four
// 16-byte vectors an element (mont_mul_vec_kernel, chosen by the launcher
// when every pointer is 16-byte aligned, the limb strides are 1 and the
// element strides 16 or 0); the packing of two 16-bit limbs into a 32-bit
// word stays in registers.  A constant operand is loaded from one address
// by every thread: a broadcast.  Everything else -- a (16, N) plane view,
// an unaligned slice -- goes to mont_mul_kernel with per-operand limb and
// element strides and scalar loads, and never faults.  Staging through
// shared memory was not tried: four direct 16-byte loads a thread already
// use every byte of every sector they touch.
// CTAs are 128 threads (__launch_bounds__(128)): 2^15 elements are 256
// CTAs, so each of the 132 SMs has one or two, and each CTA's four warps
// land on the SM's four schedulers; with 256 threads a CTA, 128 CTAs would
// leave four SMs idle and give the others' schedulers two warps each of one
// dependent chain.  ptxas (CUDA 12.8, sm_90a): 44 registers for both product
// kernels, no spills.
//
// mont_pow
// Replaces: zklaim_tpu/ff/montgomery.py:mont_pow_bits, which under jit is
// one lax.fori_loop over bulk_mul; as a loop of eager calls it would be 256 +
// popcount(e) launches of mont_mul, each a full pass over device memory.  Here the
// whole exponent is ONE launch: one thread per element keeps the
// accumulator and the running square in registers (16 of them) for the
// binary LSB-first chain of the reference, nbits - 1 squarings and
// popcount(e) products (363 for e = q - 2, 380 for e = r - 2).  The
// exponent is public and the same for every element: 8 x 32-bit words and
// a bit length passed by value, so every thread takes the same branch.  A
// fixed 4-bit window would save about 30 of the 363 products for a table
// of 16 elements (128 registers or local memory): not taken.
// What bounds it: 32-bit multiply-adds, and at the paths' 2^15 elements
// (8 warps an SM) the latency of one thread's dependent chain, as in K6.
// Every product is the canonical residue, so any multiplication chain gives
// the reference's limbs.  ptxas: 38 registers (42 with scalar loads), no spills.
#include <cuda_runtime.h>

#include "field.cuh"

#define MUL_THREADS 128
#define POW_THREADS 128

template <int F>
__global__ void __launch_bounds__(MUL_THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, int64_t a_ls, int64_t a_es,
                const int32_t* __restrict__ b, int64_t b_ls, int64_t b_es,
                int32_t* __restrict__ out, int64_t o_ls, int64_t o_es, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a, a_ls, a_es, i);
  Fe y = fe_load(b, b_ls, b_es, i);
  fe_store(out, o_ls, o_es, i, fe_mul<F>(x, y));
}

// contiguous elements (element stride 16) or one constant (element stride 0)
template <int F>
__global__ void __launch_bounds__(MUL_THREADS)
mont_mul_vec_kernel(const int32_t* __restrict__ a, int64_t a_es,
                    const int32_t* __restrict__ b, int64_t b_es,
                    int32_t* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load_vec(a + i * a_es);
  Fe y = fe_load_vec(b + i * b_es);
  fe_store_vec(out + i * 16, fe_mul<F>(x, y));
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

extern "C" int zk_mont_mul(const void* a, long long a_ls, long long a_es,
                           const void* b, long long b_ls, long long b_es,
                           void* out, long long o_ls, long long o_es,
                           long long n, int field, void* stream) {
  if (n <= 0) return 0;
  if (field != ZK_FQ && field != ZK_FR) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + MUL_THREADS - 1) / MUL_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  const bool vec = a_ls == 1 && b_ls == 1 && o_ls == 1 && o_es == 16 &&
                   (a_es == 16 || a_es == 0) && (b_es == 16 || b_es == 0) &&
                   aligned16(a) && aligned16(b) && aligned16(out);
  if (vec) {
    if (field == ZK_FQ) {
      mont_mul_vec_kernel<ZK_FQ><<<blocks, MUL_THREADS, 0, s>>>(pa, a_es, pb, b_es, po, n);
    } else {
      mont_mul_vec_kernel<ZK_FR><<<blocks, MUL_THREADS, 0, s>>>(pa, a_es, pb, b_es, po, n);
    }
  } else if (field == ZK_FQ) {
    mont_mul_kernel<ZK_FQ><<<blocks, MUL_THREADS, 0, s>>>(pa, a_ls, a_es, pb, b_ls, b_es, po, o_ls, o_es, n);
  } else {
    mont_mul_kernel<ZK_FR><<<blocks, MUL_THREADS, 0, s>>>(pa, a_ls, a_es, pb, b_ls, b_es, po, o_ls, o_es, n);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mont_pow
// ---------------------------------------------------------------------------

struct PowExp {
  uint32_t w[8];   // the exponent, little-endian words
};

// a, out: contiguous (n, 16); VEC: both 16-byte aligned
template <int F, bool VEC>
__global__ void __launch_bounds__(POW_THREADS)
mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n,
                PowExp e, int nbits) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe base = VEC ? fe_load_vec(a + i * 16) : fe_load(a, 1, 16, i);
  Fe acc = fe_const(ZK_ONE[F]);
#pragma unroll 1
  for (int bit = 0; bit < nbits; bit++) {
    if ((e.w[bit >> 5] >> (bit & 31)) & 1u) acc = fe_mul<F>(acc, base);
    if (bit + 1 < nbits) base = fe_mul<F>(base, base);
  }
  if (VEC) {
    fe_store_vec(out + i * 16, acc);
  } else {
    fe_store(out, 1, 16, i, acc);
  }
}

template <int F>
static void launch_pow(const int32_t* a, int32_t* out, long long n, const PowExp& e, int nbits,
                       bool vec, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + POW_THREADS - 1) / POW_THREADS);
  if (vec) {
    mont_pow_kernel<F, true><<<blocks, POW_THREADS, 0, s>>>(a, out, n, e, nbits);
  } else {
    mont_pow_kernel<F, false><<<blocks, POW_THREADS, 0, s>>>(a, out, n, e, nbits);
  }
}

// exp_words: 8 words in HOST memory, read before the launch returns
extern "C" int zk_mont_pow(const void* a, void* out, long long n,
                           const unsigned int* exp_words, int nbits, int field, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 256 || (field != ZK_FQ && field != ZK_FR)) {
    return (int)cudaErrorInvalidValue;
  }
  PowExp e;
  for (int j = 0; j < 8; j++) e.w[j] = exp_words[j];
  const bool vec = aligned16(a) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (field == ZK_FQ) {
    launch_pow<ZK_FQ>((const int32_t*)a, (int32_t*)out, n, e, nbits, vec, s);
  } else {
    launch_pow<ZK_FR>((const int32_t*)a, (int32_t*)out, n, e, nbits, vec, s);
  }
  return (int)cudaGetLastError();
}
