// K2 (ntt_local) and K3 (ntt_stage): radix-2 DIT butterfly stages over Fr
// on a (16, n) limb plane, in place.  The input is already in bit-reversed
// order (the caller's index_select).
//
// Replaces: zklaim_tpu/ntt/pallas_ntt.py:_local_multi_kernel (K2, driven
// by _stages_local) and :_global_stage_kernel (K3, driven by
// _stage_global).
//
// Twiddles: one flat (16, n - 1) plane holding every stage, stage s (pair
// distance half = 2^s) at offset half - 1, entry r = omega_{2 half}^r in
// Montgomery form -- the per-stage tables of radix2.NTTDomain laid end to
// end.  The TPU's tile-periodic packed twiddle planes are not carried over.
//
// Butterfly (pair j, j + half, r = j mod half): t = tw[r] * x[j + half];
// x[j] = x[j] + t; x[j + half] = x[j] - t.
//
// What bounds it on the card: at n = 2^15 the whole transform is 1 MiB
// and lives in L2, so the bound is the Montgomery multiplies (n/2 per
// stage) and, for K3, one launch per stage.  Design: K2 keeps a tile of
// T elements in shared memory (8 x 32-bit limbs, limb-major so a warp's
// accesses fall in distinct banks) and runs every stage with half < T
// between __syncthreads(); K3 runs one stage with half >= T, one thread
// per butterfly pair, each pair computed once (the Pallas kernel computed
// every pair twice, once per output tile).
#include <cuda_runtime.h>

#include "field.cuh"

__device__ __forceinline__ Fe sm_load(const uint32_t* sm, int tile, int j) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = sm[k * tile + j];
  return r;
}

__device__ __forceinline__ void sm_store(uint32_t* sm, int tile, int j, const Fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) sm[k * tile + j] = a.v[k];
}

__global__ void ntt_local_kernel(int32_t* __restrict__ x, int64_t n,
                                 const int32_t* __restrict__ tw, int64_t tw_ls,
                                 int log_tile, int stages) {
  extern __shared__ uint32_t sm[];                 // [8][tile]
  const int tile = 1 << log_tile;
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    sm_store(sm, tile, j, fe_load(x, n, 1, base + j));
  }
  __syncthreads();
  for (int s = 0; s < stages; s++) {
    const int half = 1 << s;
    for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
      const int r = t & (half - 1);
      const int j = ((t >> s) << (s + 1)) + r;
      Fe a = sm_load(sm, tile, j);
      Fe b = sm_load(sm, tile, j + half);
      Fe w = fe_load(tw, tw_ls, 1, half - 1 + r);
      Fe tb = fe_mul<ZK_FR>(w, b);
      sm_store(sm, tile, j, fe_add<ZK_FR>(a, tb));
      sm_store(sm, tile, j + half, fe_sub<ZK_FR>(a, tb));
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    fe_store(x, n, 1, base + j, sm_load(sm, tile, j));
  }
}

__global__ void ntt_stage_kernel(int32_t* __restrict__ x, int64_t n,
                                 const int32_t* __restrict__ tw, int64_t tw_ls,
                                 int log_half) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const int64_t half = (int64_t)1 << log_half;
  const int64_t r = t & (half - 1);
  const int64_t j = ((t >> log_half) << (log_half + 1)) + r;
  Fe a = fe_load(x, n, 1, j);
  Fe b = fe_load(x, n, 1, j + half);
  Fe w = fe_load(tw, tw_ls, 1, half - 1 + r);
  Fe tb = fe_mul<ZK_FR>(w, b);
  fe_store(x, n, 1, j, fe_add<ZK_FR>(a, tb));
  fe_store(x, n, 1, j + half, fe_sub<ZK_FR>(a, tb));
}

// stages 0 .. stages-1 on every tile of 2^log_tile elements
extern "C" int zk_ntt_local(void* x, long long n, const void* tw, long long tw_ls,
                            int log_tile, int stages, void* stream) {
  const int tile = 1 << log_tile;
  if (n % tile != 0 || stages > log_tile) return (int)cudaErrorInvalidValue;
  const int threads = tile / 2 < 512 ? (tile / 2 > 0 ? tile / 2 : 1) : 512;
  const size_t smem = (size_t)tile * 8 * sizeof(uint32_t);
  const unsigned blocks = (unsigned)(n / tile);
  ntt_local_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)x, n, (const int32_t*)tw, tw_ls, log_tile, stages);
  return (int)cudaGetLastError();
}

// one stage with pair distance 2^log_half
extern "C" int zk_ntt_stage(void* x, long long n, const void* tw, long long tw_ls,
                            int log_half, void* stream) {
  if (((long long)2 << log_half) > n) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n / 2 + threads - 1) / threads);
  ntt_stage_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)x, n, (const int32_t*)tw, tw_ls, log_half);
  return (int)cudaGetLastError();
}
