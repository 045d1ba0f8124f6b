// K6 at the card's width: the launches tried against the one K6 runs
// (probes.cu:mont_chain_kernel, one lane a thread in CTAs of 256).  Not part
// of the kernel library (kernels.SOURCES leaves it out): tools/mont_wide_ab.py
// builds this file on its own and times every variant on the same planes,
// so that the comparison behind K6's wide launch can be run again.  Every
// variant computes what K6 computes, K chained fe_mul<ZK_FQ>(v, v) on
// (16, n) limb planes, and each tries another way to overlap the next
// lanes' 64 bytes with this lane's products:
//
//   0 flat        K6's launch: one lane a thread, ceil(n / 256) CTAs
//   1 flat_stcs   the same, stores with the evict-first hint (__stcs)
//   2 ring2       a persistent grid (SMs x the CTAs an SM holds) walking
//                 tiles of 256 lanes; tile t + 1's 16 limb rows are copied
//                 by 4-byte cp.async.ca into the other stage of a two-stage
//                 ring in shared memory (2 x 16 KB) while tile t computes
//   3 ring1       one stage, refilled with the next tile as soon as this
//                 tile's words are read out of it
//   4 ring2_16    two stages filled by 16-byte cp.async.cg, a barrier a
//                 tile (planes whose lane count and stride are multiples of 4)
//   5 regpf       a persistent grid; the next lane's 16 words are loaded
//                 into registers while this lane computes
//   6 lanes2      two lanes a thread (lanes i and i + 256 of a 512-lane tile)
//   7 lanes4      four neighbouring lanes a thread, 16-byte vector loads
//                 and stores (lane count and stride multiples of 4)
//   8 l2pf        K6's launch; once a lane's words are in, its thread
//                 prefetches into L2 the lane one wave of CTAs ahead (the
//                 CTAs all SMs hold at once), so that the next wave's loads
//                 hit L2 and the card's memory stays busy while this wave
//                 computes
//   9 l2pf_stcs   8 with evict-first stores, which leave L2 to the prefetches
//  10 l2bulk      8 with one bulk prefetch a limb row a warp (lane 0 issues
//                 cp.async.bulk.prefetch.L2 of the warp's 128 bytes) in place
//                 of a prefetch a thread (lane count and stride multiples of 4)
//  11 l2bulk_stcs 10 with evict-first stores
#include <cuda_runtime.h>

#include "field.cuh"

#define VAR_THREADS 256

namespace {

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes `a` depend on every word of v: what uses `a` issues once v is loaded.
__device__ __forceinline__ void after(uint64_t& a, const Fe& v) {
  asm volatile("" : "+l"(a) : "r"(v.v[0]), "r"(v.v[1]), "r"(v.v[2]), "r"(v.v[3]), "r"(v.v[4]),
               "r"(v.v[5]), "r"(v.v[6]), "r"(v.v[7]));
}

__device__ __forceinline__ Fe chain(Fe v, int k) {
#pragma unroll 1
  for (int s = 0; s < k; s++) v = fe_mul<ZK_FQ>(v, v);
  return v;
}

template <bool STCS>
__device__ __forceinline__ void store_lane(int32_t* out, int64_t ls, int64_t i, const Fe& v) {
  if (STCS) {
#pragma unroll
    for (int j = 0; j < 8; j++) {
      __stcs(out + (2 * j) * ls + i, (int)(v.v[j] & 0xffffu));
      __stcs(out + (2 * j + 1) * ls + i, (int)(v.v[j] >> 16));
    }
  } else {
    fe_store(out, ls, 1, i, v);
  }
}

// the 16 words of lane t from 16 rows of a shared-memory stage
__device__ __forceinline__ Fe from_stage(const uint32_t (&st)[16][VAR_THREADS], int t) {
  Fe v;
#pragma unroll
  for (int j = 0; j < 8; j++) v.v[j] = st[2 * j][t] | (st[2 * j + 1][t] << 16);
  return v;
}

#define VAR_ARGS                                                                       \
  const int32_t *__restrict__ in, int64_t in_ls, int32_t *__restrict__ out, int64_t out_ls, \
      int64_t n, int k, int64_t wave

template <bool STCS>
__global__ void __launch_bounds__(VAR_THREADS) flat_kernel(VAR_ARGS) {
  const int64_t i = (int64_t)blockIdx.x * VAR_THREADS + threadIdx.x;
  if (i >= n) return;
  store_lane<STCS>(out, out_ls, i, chain(fe_load(in, in_ls, 1, i), k));
}

__global__ void __launch_bounds__(VAR_THREADS, 6) ring2_kernel(VAR_ARGS) {
  __shared__ uint32_t ring[2][16][VAR_THREADS];
  const int t = threadIdx.x;
  const int64_t tiles = (n + VAR_THREADS - 1) / VAR_THREADS;
  auto fetch = [&](int st, int64_t tile) {
    const int64_t i = tile * VAR_THREADS + t;
    if (tile < tiles && i < n) {
#pragma unroll
      for (int j = 0; j < 16; j++) cp_async4(&ring[st][j][t], in + j * in_ls + i);
    }
    cp_async_commit();
  };
  // each thread reads back only the words it copied: no barrier
  int s = 0;
  fetch(0, blockIdx.x);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, s ^= 1) {
    fetch(s ^ 1, tile + gridDim.x);
    cp_async_wait<1>();
    const int64_t i = tile * VAR_THREADS + t;
    if (i < n) fe_store(out, out_ls, 1, i, chain(from_stage(ring[s], t), k));
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(VAR_THREADS, 8) ring1_kernel(VAR_ARGS) {
  __shared__ uint32_t stage[16][VAR_THREADS];
  const int t = threadIdx.x;
  const int64_t tiles = (n + VAR_THREADS - 1) / VAR_THREADS;
  int64_t tile = blockIdx.x;
  if (tile < tiles && tile * VAR_THREADS + t < n) {
#pragma unroll
    for (int j = 0; j < 16; j++) cp_async4(&stage[j][t], in + j * in_ls + tile * VAR_THREADS + t);
  }
  cp_async_commit();
  for (; tile < tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    const int64_t i = tile * VAR_THREADS + t;
    const Fe v = from_stage(stage, t);
    const int64_t ni = (tile + gridDim.x) * VAR_THREADS + t;
    if (tile + gridDim.x < tiles && ni < n) {
      uint64_t a = (uint64_t)(in + ni);
      after(a, v);                                   // the stage is read before it is refilled
#pragma unroll
      for (int j = 0; j < 16; j++) cp_async4(&stage[j][t], (const int32_t*)a + j * in_ls);
    }
    cp_async_commit();
    if (i < n) fe_store(out, out_ls, 1, i, chain(v, k));
  }
}

__global__ void __launch_bounds__(VAR_THREADS, 6) ring2_16_kernel(VAR_ARGS) {
  __shared__ __align__(16) uint32_t ring[2][16][VAR_THREADS];
  const int t = threadIdx.x;
  const int64_t tiles = (n + VAR_THREADS - 1) / VAR_THREADS;
  auto fetch = [&](int st, int64_t tile) {
    if (tile < tiles) {
#pragma unroll
      for (int r = 0; r < 4; r++) {            // 16 rows x 64 chunks of 16 bytes, 4 a thread
        const int c = t + r * VAR_THREADS, row = c / (VAR_THREADS / 4);
        const int col = (c % (VAR_THREADS / 4)) * 4;
        if (tile * VAR_THREADS + col < n)
          cp_async16(&ring[st][row][col], in + row * in_ls + tile * VAR_THREADS + col);
      }
    }
    cp_async_commit();
  };
  int s = 0;
  fetch(0, blockIdx.x);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, s ^= 1) {
    __syncthreads();                             // every thread is done with stage s ^ 1
    fetch(s ^ 1, tile + gridDim.x);
    cp_async_wait<1>();
    __syncthreads();                             // stage s is in, from every thread's copies
    const int64_t i = tile * VAR_THREADS + t;
    if (i < n) fe_store(out, out_ls, 1, i, chain(from_stage(ring[s], t), k));
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(VAR_THREADS, 5) regpf_kernel(VAR_ARGS) {
  const int64_t stride = (int64_t)gridDim.x * VAR_THREADS;
  int64_t i = (int64_t)blockIdx.x * VAR_THREADS + threadIdx.x;
  Fe next;
  if (i < n) next = fe_load(in, in_ls, 1, i);
  for (; i < n; i += stride) {
    const Fe v = next;
    if (i + stride < n) next = fe_load(in, in_ls, 1, i + stride);
    fe_store(out, out_ls, 1, i, chain(v, k));
  }
}

__global__ void __launch_bounds__(VAR_THREADS) lanes2_kernel(VAR_ARGS) {
  const int64_t i = (int64_t)blockIdx.x * 2 * VAR_THREADS + threadIdx.x, i2 = i + VAR_THREADS;
  if (i >= n) return;
  const bool two = i2 < n;
  Fe v = fe_load(in, in_ls, 1, i);
  Fe w = two ? fe_load(in, in_ls, 1, i2) : v;
#pragma unroll 1
  for (int s = 0; s < k; s++) {
    v = fe_mul<ZK_FQ>(v, v);
    w = fe_mul<ZK_FQ>(w, w);
  }
  fe_store(out, out_ls, 1, i, v);
  if (two) fe_store(out, out_ls, 1, i2, w);
}

__global__ void __launch_bounds__(VAR_THREADS) lanes4_kernel(VAR_ARGS) {
  const int64_t i0 = ((int64_t)blockIdx.x * VAR_THREADS + threadIdx.x) * 4;
  if (i0 >= n) return;
  Fe v[4];
#pragma unroll
  for (int j = 0; j < 16; j++) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(in + j * in_ls + i0));
    const uint32_t w[4] = {(uint32_t)q.x, (uint32_t)q.y, (uint32_t)q.z, (uint32_t)q.w};
#pragma unroll
    for (int l = 0; l < 4; l++) {
      if (j % 2 == 0) v[l].v[j / 2] = w[l];
      else v[l].v[j / 2] |= w[l] << 16;
    }
  }
#pragma unroll 1
  for (int s = 0; s < k; s++) {
#pragma unroll
    for (int l = 0; l < 4; l++) v[l] = fe_mul<ZK_FQ>(v[l], v[l]);
  }
#pragma unroll
  for (int j = 0; j < 16; j++) {
    int w[4];
#pragma unroll
    for (int l = 0; l < 4; l++)
      w[l] = (int)(j % 2 == 0 ? (v[l].v[j / 2] & 0xffffu) : (v[l].v[j / 2] >> 16));
    *reinterpret_cast<int4*>(out + j * out_ls + i0) = make_int4(w[0], w[1], w[2], w[3]);
  }
}

template <bool STCS>
__global__ void __launch_bounds__(VAR_THREADS) l2pf_kernel(VAR_ARGS) {
  const int64_t i = (int64_t)blockIdx.x * VAR_THREADS + threadIdx.x;
  if (i >= n) return;
  const Fe v = fe_load(in, in_ls, 1, i);
  if (i + wave < n) {
    uint64_t a = (uint64_t)(in + i + wave);
    after(a, v);                                   // behind this lane's own loads
#pragma unroll
    for (int j = 0; j < 16; j++)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"((const int32_t*)a + j * in_ls));
  }
  store_lane<STCS>(out, out_ls, i, chain(v, k));
}

template <bool STCS>
__global__ void __launch_bounds__(VAR_THREADS) l2bulk_kernel(VAR_ARGS) {
  const int64_t i = (int64_t)blockIdx.x * VAR_THREADS + threadIdx.x;
  if (i >= n) return;
  const Fe v = fe_load(in, in_ls, 1, i);
  if ((threadIdx.x & 31) == 0 && i + wave < n) {
    uint64_t a = (uint64_t)(in + i + wave);
    after(a, v);
    const unsigned bytes = (unsigned)(min((int64_t)32, n - i - wave) * 4);   // a multiple of 16
#pragma unroll
    for (int j = 0; j < 16; j++)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"((const int32_t*)a + j * in_ls),
                   "r"(bytes) : "memory");
  }
  store_lane<STCS>(out, out_ls, i, chain(v, k));
}

typedef void (*VariantFn)(const int32_t*, int64_t, int32_t*, int64_t, int64_t, int, int64_t);

struct Variant {
  VariantFn fn;
  int lanes_a_thread;   // lanes a thread; 0: a persistent grid (SMs x CTAs an SM holds)
  int aligned;          // needs lane count, strides and pointers in multiples of 4 lanes
};

const Variant VARIANTS[] = {
    {flat_kernel<false>, 1, 0}, {flat_kernel<true>, 1, 0},  {ring2_kernel, 0, 0},
    {ring1_kernel, 0, 0},       {ring2_16_kernel, 0, 1},    {regpf_kernel, 0, 0},
    {lanes2_kernel, 2, 0},      {lanes4_kernel, 4, 1},      {l2pf_kernel<false>, 1, 0},
    {l2pf_kernel<true>, 1, 0},  {l2bulk_kernel<false>, 1, 1}, {l2bulk_kernel<true>, 1, 1},
};
const int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

}  // namespace

// info[0..5]: registers, CTAs an SM holds, static shared bytes, threads, lanes
// a thread (0: persistent grid), aligned-only.
extern "C" int zk_mont_wide_info(int variant, int* info) {
  if (variant < 0 || variant >= N_VARIANTS) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, VARIANTS[variant].fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, VARIANTS[variant].fn, VAR_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = per_sm;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = VAR_THREADS;
  info[4] = VARIANTS[variant].lanes_a_thread;
  info[5] = VARIANTS[variant].aligned;
  return 0;
}

// grid: CTAs of VAR_THREADS; wave: l2pf's prefetch distance in lanes.
extern "C" int zk_mont_wide_launch(int variant, const void* in, long long in_ls, void* out,
                                   long long out_ls, long long n, int k, int grid,
                                   long long wave, void* stream) {
  if (variant < 0 || variant >= N_VARIANTS || k < 0 || grid <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  if (VARIANTS[variant].aligned &&
      (n % 4 || in_ls % 4 || out_ls % 4 || (uintptr_t)in % 16 || (uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  VARIANTS[variant].fn<<<grid, VAR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, in_ls, (int32_t*)out, out_ls, n, k, wave);
  return (int)cudaGetLastError();
}
