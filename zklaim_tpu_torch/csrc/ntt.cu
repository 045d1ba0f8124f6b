// K2 (ntt_local) and K3 (ntt_stage): radix-2 DIT butterfly stages over Fr
// on (16, n) limb planes.
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
// What bounds it on the card: the Montgomery products (n/2 per stage); at
// n = 2^15 the whole transform is 1 MiB and lives in L2, and each stage is
// one product's latency on every thread, so the number of warps in flight
// and the stages' dependent chain come first.
//
// K2 runs every stage with half < T (the tile, 2^log_tile elements) on a
// thread-block CLUSTER of 2^lc CTAs a tile, each holding E = T / 2^lc
// elements in its own shared memory (8 x 32-bit limbs, limb-major) with
// E / 2 threads, one butterfly a thread a stage: at T = 1024 and 4 CTAs a
// cluster, 128 CTAs of 128 threads at n = 2^15, where one CTA a tile gave
// 32 CTAs for the 132 SMs.  The stages with half < E pair elements of one
// CTA and run between __syncthreads(); the lc stages with E <= half < T pair
// CTAs ranks r and r ^ bit: each thread takes one such pair, reads and
// writes both elements, its partner's through distributed shared memory
// (map_shared_rank), and a cluster.sync() closes every such stage (and
// opens the first, where every CTA of the cluster has started).  Every
// twiddle a CTA needs is staged in its shared memory with the elements, in
// one round of loads before the first stage, so no stage waits on device
// memory.  GATHER = true is the transform's entry: element j of the
// transform is row brev_k(j) of the (n, 16) AoS input (its bit reversal,
// __brev(j) >> (32 - k)), read as four 16-byte vectors; the result goes to
// a new (16, n) planes tensor for K3 -- the bit-reversal index_select and the
// transpose to planes happen in the kernel's load.  GATHER = false reads and
// writes (16, n) planes in place (already in bit-reversed order).
//
// A BATCH of B transforms of 2^k runs as one plane of width B 2^k, transform
// b in segment b (plane elements b 2^k .. (b + 1) 2^k - 1): a tile never
// crosses a segment (2^k is a multiple of the tile), and no stage of K2 or
// K3 pairs elements of two segments, so both kernels take the width and k
// apart and run the batch in one launch (K3: one a pass).  The gather entry
// reads the (2^k, B, 16) input: element j of transform b is row
// brev_k(j) B + b.  A thread reads one whole 64-byte row, two full 32-byte
// sectors, whatever B is.
//
// K3 runs a PASS of up to 6 consecutive stages with half >= T in one launch:
// those stages never mix columns (j mod T), so a CTA loads C adjacent
// columns x the 2^G rows the pass pairs, runs the G stages in shared memory
// and writes back once (each pair computed once; the Pallas kernel ran one
// stage a launch and every pair twice).  Which passes and C:
// ntt/gpu_ntt.py:global_passes -- one pass (one launch) at n = 2^15, two at
// 2^20 and 2^22, at most 64 KiB of shared memory a CTA.  At 2^15 a pass is
// 256 CTAs of 64 threads, one butterfly a thread a stage: five dependent
// products and their twiddle loads, latency-bound.
// ptxas (CUDA 12.8, sm_90a): K2 68 registers (both entries), K3 46; no
// spills, no stack frame.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

namespace cg = cooperative_groups;

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

__device__ __forceinline__ void butterfly(uint32_t* lo, uint32_t* hi, int e, int j,
                                          const Fe& w) {
  const Fe a = sm_load(lo, e, j);
  const Fe tb = fe_mul<ZK_FR>(w, sm_load(hi, e, j));
  sm_store(lo, e, j, fe_add<ZK_FR>(a, tb));
  sm_store(hi, e, j, fe_sub<ZK_FR>(a, tb));
}

// Block b of the grid is rank b mod 2^lc of the cluster of tile b >> lc, and
// holds elements j = b E + l, l < E.  Shared memory: [8][E] elements, then
// [8][TW] twiddles, TW = (E - 1) + lc E / 2: the local stages' E - 1 at their
// own offsets (stage s at 2^s - 1), then for cross stage c (half = E 2^c)
// thread t's twiddle at E - 1 + c E / 2 + t.  Cross stage c: thread t of
// rank r takes local element l = ((r >> c) & 1) E / 2 + t of the CTAs
// lo = r & ~2^c and hi = r | 2^c (the pair's low element is lo E + l of the
// tile: twiddle ((lo mod 2^c) E) + l).
template <bool GATHER>
__global__ void ntt_local_kernel(const int32_t* src, int32_t* dst, int64_t n, int log_n,
                                 const int32_t* __restrict__ tw, int64_t tw_ls, int le, int lc) {
  // n: the plane's width, B = n >> log_n transforms of 2^log_n
  extern __shared__ uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int E = 1 << le, H = E >> 1, TW = (E - 1) + lc * H;
  uint32_t* smt = sm + 8 * E;
  const unsigned rank = cluster.block_rank();
  const int64_t base = (int64_t)blockIdx.x << le;
  const int t = threadIdx.x;
  for (int l = t; l < E; l += H) {
    const int64_t j = base + l;
    Fe v;
    if (GATHER) {
      const int64_t seg = j >> log_n, jj = j & (((int64_t)1 << log_n) - 1);
      const int64_t row = (int64_t)(__brev((unsigned)jj) >> (32 - log_n)) * (n >> log_n) + seg;
      v = fe_load_vec(src + (row << 4));
    } else {
      v = fe_load(src, n, 1, j);
    }
    sm_store(sm, E, l, v);
  }
  for (int i = t; i < E - 1; i += H) sm_store(smt, TW, i, fe_load(tw, tw_ls, 1, i));
  for (int c = 0; c < lc; c++) {
    const unsigned lo = rank & ~(1u << c);
    const int l = (((rank >> c) & 1) << (le - 1)) | t;
    const int64_t r = ((int64_t)(lo & ((1u << c) - 1)) << le) + l;
    sm_store(smt, TW, E - 1 + c * H + t, fe_load(tw, tw_ls, 1, ((int64_t)1 << (le + c)) - 1 + r));
  }
  __syncthreads();
  for (int s = 0; s < le; s++) {
    const int half = 1 << s, r = t & (half - 1);
    const int j = ((t >> s) << (s + 1)) + r;
    butterfly(sm + j, sm + j + half, E, 0, sm_load(smt, TW, half - 1 + r));
    __syncthreads();
  }
  for (int c = 0; c < lc; c++) {
    cluster.sync();                 // the partner's last stage is written (and it has started)
    const unsigned bit = 1u << c;
    const int l = (((rank >> c) & 1) << (le - 1)) | t;
    butterfly(cluster.map_shared_rank(sm, rank & ~bit), cluster.map_shared_rank(sm, rank | bit),
              E, l, sm_load(smt, TW, E - 1 + c * H + t));
  }
  cluster.sync();                   // the partners' writes here are done, and none reads here
  for (int l = t; l < E; l += H) fe_store(dst, n, 1, base + l, sm_load(sm, E, l));
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

// the most a zk_ntt_local launch asks for: a tile of 2^10 elements a CTA on a cluster of 8
#define NTT_LOCAL_SHARED_MAX ((1024 + 1023 + 3 * 512) * 8 * 4)

// every stage with half < 2^log_tile on each tile of 2^log_tile elements of
// the n / 2^log_n transforms of 2^log_n in a plane of width n, a tile on a
// cluster of 2^log_cluster CTAs; gather: src is the (2^log_n, n / 2^log_n,
// 16) AoS input (16-byte aligned) and dst new (16, n) planes, else src = dst
// planes
extern "C" int zk_ntt_local(const void* src, void* dst, long long n, int log_n, const void* tw,
                            long long tw_ls, int log_tile, int log_cluster, int gather,
                            void* stream) {
  if (log_n < 1 || log_n > 31 || n < ((long long)1 << log_n) ||
      (n & (((long long)1 << log_n) - 1)) || log_tile < 1 || log_tile > log_n ||
      log_cluster < 0 || log_cluster > 3 || log_cluster >= log_tile ||
      log_tile - log_cluster > 10) {
    return (int)cudaErrorInvalidValue;
  }
  const int le = log_tile - log_cluster, E = 1 << le;
  const size_t smem = (size_t)(E + (E - 1) + log_cluster * (E / 2)) * 8 * sizeof(uint32_t);
  void (*kernel)(const int32_t*, int32_t*, int64_t, int, const int32_t*, int64_t, int, int) =
      gather ? ntt_local_kernel<true> : ntt_local_kernel<false>;
  if (smem > 48 * 1024) {
    // the kernel's limit, shared by every host thread: the largest a launch may ask for
    // (as in zk_msm_finish)
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           NTT_LOCAL_SHARED_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n >> le));
  cfg.blockDim = dim3((unsigned)(E / 2));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)src, (int32_t*)dst,
                                       (int64_t)n, log_n, (const int32_t*)tw, (int64_t)tw_ls,
                                       le, log_cluster);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define NTT_PASS_SHARED_MAX (64 * 1024)

// one pass: stages s0 .. s0 + stages - 1 (all with half >= 2^log_tile) of
// the n / 2^log_n transforms of 2^log_n in a plane of width n, on CTAs of
// 2^log_c columns x 2^stages rows
extern "C" int zk_ntt_stage(void* x, long long n, int log_n, const void* tw, long long tw_ls,
                            int log_tile, int s0, int stages, int log_c, void* stream) {
  const long long elems = (long long)1 << (stages + log_c);
  if (stages < 1 || log_c < 0 || log_c > log_tile || s0 < log_tile || log_n > 31 ||
      s0 + stages > log_n || n < ((long long)1 << log_n) ||
      (n & (((long long)1 << log_n) - 1)) || elems * 32 > NTT_PASS_SHARED_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)elems * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ntt_stage_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           NTT_PASS_SHARED_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = elems / 2 < 256 ? (int)(elems / 2) : 256;
  ntt_stage_kernel<<<(unsigned)(n / elems), threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)x, n, (const int32_t*)tw, tw_ls, log_tile, s0, stages, log_c);
  return (int)cudaGetLastError();
}
