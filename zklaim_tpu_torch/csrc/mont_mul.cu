// K1: elementwise Montgomery product on (16, N) limb planes.
//
// Replaces: zklaim_tpu/ntt/pallas_ntt.py:_mul_kernel (launched by
// bulk_mul, reached through mont_mul_aos from montgomery.mont_mul_bulk).
//
// What bounds it on the card: memory traffic (3 x 64 B per element in
// the int32 16-bit-limb layout) against ~70 integer multiply-adds per
// element; at main-path widths (2^15 - 2^17 elements) launch overhead is
// of the same order.  Design: one thread per element; each operand is a
// (16, N) plane view with its own limb and element strides, so a
// contiguous (N, 16) AoS tensor (strides 1, 16), a (16, N) SoA plane
// (strides N, 1) and a broadcast constant (element stride 0) all launch
// without a copy.
#include <cuda_runtime.h>

#include "field.cuh"

template <int F>
__global__ void mont_mul_kernel(const int32_t* __restrict__ a, int64_t a_ls, int64_t a_es,
                                const int32_t* __restrict__ b, int64_t b_ls, int64_t b_es,
                                int32_t* __restrict__ out, int64_t o_ls, int64_t o_es,
                                int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = fe_load(a, a_ls, a_es, i);
  Fe y = fe_load(b, b_ls, b_es, i);
  fe_store(out, o_ls, o_es, i, fe_mul<F>(x, y));
}

extern "C" int zk_mont_mul(const void* a, long long a_ls, long long a_es,
                           const void* b, long long b_ls, long long b_es,
                           void* out, long long o_ls, long long o_es,
                           long long n, int field, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  if (field == ZK_FQ) {
    mont_mul_kernel<ZK_FQ><<<blocks, threads, 0, s>>>(pa, a_ls, a_es, pb, b_ls, b_es, po, o_ls, o_es, n);
  } else if (field == ZK_FR) {
    mont_mul_kernel<ZK_FR><<<blocks, threads, 0, s>>>(pa, a_ls, a_es, pb, b_ls, b_es, po, o_ls, o_es, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
