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
// stage); at the credential path's sizes the launches and each stage's
// dependent products come first.  Design: K2 keeps a tile of T elements
// in shared memory (8 x 32-bit limbs, limb-major so a warp's accesses fall
// in distinct banks) and runs every stage with half < T between
// __syncthreads().  K3 runs a PASS of up to 6 consecutive stages with
// half >= T in one launch: those stages never mix columns (j mod T), so a
// CTA loads C adjacent columns x the 2^G rows the pass pairs, runs the G
// stages in shared memory and writes back once (each pair computed once;
// the Pallas kernel ran one stage a launch and every pair twice).  Which
// passes and C: ntt/gpu_ntt.py:global_passes -- one pass (one launch) at
// n = 2^15, two at 2^20 and 2^22, at most 64 KiB of shared memory a CTA.
// At 2^15 a pass is 256 CTAs of 64 threads, one butterfly a thread a stage:
// five dependent products and their twiddle loads, latency-bound.
// ptxas (CUDA 12.8, sm_90a): K2 40 registers, K3 46, no spills.
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

// One pass: the `stages` consecutive stages s0 .. s0 + stages - 1, all with
// half >= T = 2^log_tile.  Element j = i T + c (row i, column c < T); these
// stages pair rows of one column only, and a pass of G stages pairs rows
// that differ in bits b0 .. b0 + G - 1 of i (b0 = s0 - log_tile).  A CTA
// takes C = 2^log_c adjacent columns and the 2^G rows i = ((hi 2^G + mid)
// << b0) + lo of one (hi, lo), mid = 0 .. 2^G - 1: element e = mid C + cc
// of its shared tile, limb-major as in K2.  Block b: cb = b mod (T / C),
// then lo and hi from b / (T / C).  The twiddle of stage s at the pair whose
// low element has row i and column c is r = j mod 2^s = (i mod 2^(s -
// log_tile)) T + c.
__global__ void ntt_stage_kernel(int32_t* __restrict__ x, int64_t n,
                                 const int32_t* __restrict__ tw, int64_t tw_ls,
                                 int log_tile, int s0, int stages, int log_c) {
  extern __shared__ uint32_t sm[];                 // [8][E], E = 2^stages C
  const int C = 1 << log_c, E = C << stages;
  const int b0 = s0 - log_tile;
  const int64_t b = blockIdx.x;
  const int64_t c0 = (b & ((1 << (log_tile - log_c)) - 1)) << log_c;   // first column
  const int64_t rest = b >> (log_tile - log_c);
  const int64_t lo = rest & (((int64_t)1 << b0) - 1);
  const int64_t hi = rest >> b0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int64_t row = (((hi << stages) + (e >> log_c)) << b0) + lo;
    sm_store(sm, E, e, fe_load(x, n, 1, (row << log_tile) + c0 + (e & (C - 1))));
  }
  __syncthreads();
  for (int u = 0; u < stages; u++) {
    const int64_t half = (int64_t)1 << (s0 + u);
    for (int t = threadIdx.x; t < E / 2; t += blockDim.x) {
      const int cc = t & (C - 1), q = t >> log_c;  // column, pair of the column
      const int low = q & ((1 << u) - 1);          // mid mod 2^u
      const int e0 = ((((q >> u) << (u + 1)) + low) << log_c) + cc;
      const int e1 = e0 + (C << u);
      const int64_t r = ((((int64_t)low << b0) + lo) << log_tile) + c0 + cc;
      Fe a = sm_load(sm, E, e0);
      Fe bv = sm_load(sm, E, e1);
      Fe w = fe_load(tw, tw_ls, 1, half - 1 + r);
      Fe tb = fe_mul<ZK_FR>(w, bv);
      sm_store(sm, E, e0, fe_add<ZK_FR>(a, tb));
      sm_store(sm, E, e1, fe_sub<ZK_FR>(a, tb));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int64_t row = (((hi << stages) + (e >> log_c)) << b0) + lo;
    fe_store(x, n, 1, (row << log_tile) + c0 + (e & (C - 1)), sm_load(sm, E, e));
  }
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

#define NTT_PASS_SHARED_MAX (64 * 1024)

// one pass: stages s0 .. s0 + stages - 1 (all with half >= 2^log_tile) on
// CTAs of 2^log_c columns x 2^stages rows
extern "C" int zk_ntt_stage(void* x, long long n, const void* tw, long long tw_ls,
                            int log_tile, int s0, int stages, int log_c, void* stream) {
  const long long elems = (long long)1 << (stages + log_c);
  if (stages < 1 || log_c < 0 || log_c > log_tile || s0 < log_tile ||
      ((long long)1 << (s0 + stages)) > n || elems * 32 > NTT_PASS_SHARED_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)elems * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ntt_stage_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = elems / 2 < 256 ? (int)(elems / 2) : 256;
  ntt_stage_kernel<<<(unsigned)(n / elems), threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)x, n, (const int32_t*)tw, tw_ls, log_tile, s0, stages, log_c);
  return (int)cudaGetLastError();
}
