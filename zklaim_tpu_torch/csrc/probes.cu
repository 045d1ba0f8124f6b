// K6-K9: the four probe kernels of the measuring path.  Each times a piece
// of the arithmetic the production kernels run (field.cuh's fe_mul, rcb.cuh's
// rcb_add) with the data held on chip, so that a difference of two chain
// lengths K cancels launch, load and store and leaves the cost of one step.
// "Held on chip" is the register file here: one thread per lane (K6, K7, K9)
// keeps its element in registers across a runtime loop of K steps, with one
// load before and one store after.
//
// K6 mont_chain
// Replaces: the kernel of tools/mont_micro.py:build(K) (launched at :22):
// K chained Montgomery squarings v <- mont_mul(v, v) over Fq on (16, lanes)
// planes, each step the full fe_mul of field.cuh (no special squaring: K6
// measures the product every other kernel runs).  136 32-bit multiply-adds a
// step, 128 bytes a lane moved once.  One lane a thread; the wrapper
// (tools/mont_micro.py:chain_threads, K9's rule at MONT_CHAIN_MAX_THREADS)
// cuts the lanes into CTAs of as few warps as spread them over every SM:
//  - at the original's 1,024 lanes: 32 CTAs of one warp on 32 SMs, where 4
//    CTAs of 256 threads ran on 4 SMs with two warps a scheduler.  What
//    bounds it is one warp's in-order issue of its dependent chain (a
//    product is some 190 instructions, each waiting on a carry or an
//    operand of the one before): a second warp on the scheduler only
//    queued behind the first.
//  - at the card's width: CTAs of MONT_CHAIN_MAX_THREADS, 8 an SM at the
//    kernel's 32 registers, 64 warps an SM.  Bound by bytes at short chains
//    (K = 2: 128 bytes a lane against two products, and the loads and
//    stores of one lane a thread run near the card's copy rate) and by the
//    product's issue at long ones, which wants every warp an SM holds.
//    Overlapping the next lanes' loads with this lane's products (their
//    rows staged in shared memory by cp.async, held in registers, or
//    prefetched into L2) costs warps or memory time, and ran slower on the
//    card than this launch at K = 2 and at K = 64 / 512; two or four lanes
//    a thread gain a few per cent at K = 64 / 512 and lose more at K = 2
//    (mont_wide_variants.cu holds every launch tried, and
//    tools/mont_wide_ab.py times them against this kernel).
//
// K7 op_chain
// Replaces: the kernel of tools/pallas_op_micro.py:build(op, K, dtype)
// (launched at :27): K chained elementwise steps of one of four ops,
//   u32mul  v * (v | 1)           u32add  v + (v ^ 12345)
//   u16mul  (v & 0xFFFF) * 3      f32fma  fma(v, 1.0000001f, 0.5f)
// on a flat array of 32-bit elements.  The op is a template parameter (four
// instantiations), not a branch in the loop; the step depends on the data,
// so the compiler cannot fold the loop.  The loop is unrolled 16 times, so
// that the counter and the branch do not dilute the rate of a one- or
// two-instruction step, and an empty asm statement after each step keeps the
// compiler from merging the unrolled steps algebraically (without it 16
// u16mul steps collapse into one multiply by 3^16 and one mask).  Bound by
// the rate at which an SM starts that one instruction (plus the logic op
// beside it).  f32fma is one fused multiply-add with one rounding
// (__fmaf_rn), where the plain version rounds twice.  Its headline runs the
// tool's shorter chain, K = 20,000, on the original's 131,072 elements (at
// K = 16 a launch times little but itself): 512 CTAs of 256 threads, under
// half of the 1,056 the card holds at once, so the busiest SMs set the
// time: about 71 % of the issue bound, against 91 % at the width that fills
// the card.
//
// K8 point_add_tiled
// Replaces: the kernel of tools/grid_micro.py:build(tile) (launched at
// :25): one G1 add over n lanes, the launch cut as the Pallas grid is, into
// ceil(n / tile) CTAs, one a tile.  A tile's CTA has min(tile,
// TILED_MAX_THREADS) threads (the wrapper, tools/grid_micro.py:
// tiled_threads, picks the count and passes it), each walking the lanes j,
// j + threads, ... of its tile.  TILED_MAX_THREADS is what one SM holds at
// the kernel's register count: unbounded, ptxas (CUDA 12.8) gives it 140
// registers, so an SM holds 12 warps of it (registers go to warps in
// groups of four); at the 128 registers that 16 warps would need it
// spills.  So a tile of 384 lanes or more keeps 12 warps, three a
// scheduler, on its SM, where a CTA of 128 threads kept one a scheduler and
// walked a tile three times as long.  What the grid-step overhead is on the TPU is here
// the cost of CTA granularity: with few CTAs most of the 132 SMs idle, and
// one CTA that owns every lane runs on one SM.
//
// K9 point_add_chain
// Replaces: the kernel of tools/padd_micro.py:build(K) (launched at :24):
// K chained G1 adds pt <- pt + pt on (3, 16, lanes) planes, each the complete
// rcb_add<1> (12 Fq products a step).  Bound by integer multiply-adds and,
// at 1,024 lanes (32 warps), by the latency of one warp's dependent chain:
// the wrapper (tools/padd_micro.py:chain_threads at CHAIN_MAX_THREADS, the
// rule K6 shares) cuts the lanes into CTAs
// of as few warps as spread them over the card's SMs, one warp a scheduler
// (1,024 lanes: 32 CTAs of one warp on 32 SMs, where 8 CTAs of 128 threads
// ran on 8), up to CHAIN_MAX_THREADS a CTA where lanes are many.
#include <cuda_runtime.h>

#include "field.cuh"
#include "rcb.cuh"

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

#define MONT_CHAIN_MAX_THREADS 256

__global__ void __launch_bounds__(MONT_CHAIN_MAX_THREADS)
mont_chain_kernel(const int32_t* __restrict__ in, int64_t in_ls,
                  int32_t* __restrict__ out, int64_t out_ls, int64_t n, int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe v = fe_load(in, in_ls, 1, i);
#pragma unroll 1
  for (int s = 0; s < k; s++) v = fe_mul<ZK_FQ>(v, v);
  fe_store(out, out_ls, 1, i, v);
}

extern "C" int zk_mont_chain(const void* in, long long in_ls, void* out, long long out_ls,
                             long long n, int k, int threads, void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || threads <= 0 || threads > MONT_CHAIN_MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  mont_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, in_ls, (int32_t*)out, out_ls, n, k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

#define ZK_OP_U32MUL 0
#define ZK_OP_U32ADD 1
#define ZK_OP_U16MUL 2
#define ZK_OP_F32FMA 3

template <int OP>
__global__ void op_chain_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                int64_t n, int k) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (OP == ZK_OP_F32FMA) {
    float v = __uint_as_float(in[i]);
#pragma unroll 16
    for (int s = 0; s < k; s++) {
      v = __fmaf_rn(v, 1.0000001f, 0.5f);
      asm volatile("" : "+f"(v));
    }
    out[i] = __float_as_uint(v);
  } else {
    uint32_t v = in[i];
#pragma unroll 16
    for (int s = 0; s < k; s++) {
      if (OP == ZK_OP_U32MUL) v = v * (v | 1u);
      if (OP == ZK_OP_U32ADD) v = v + (v ^ 12345u);
      if (OP == ZK_OP_U16MUL) v = (v & 0xFFFFu) * 3u;
      asm volatile("" : "+r"(v));
    }
    out[i] = v;
  }
}

extern "C" int zk_op_chain(int op, const void* in, void* out, long long n, int k,
                           void* stream) {
  if (n <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pi = (const uint32_t*)in;
  uint32_t* po = (uint32_t*)out;
  switch (op) {
    case ZK_OP_U32MUL: op_chain_kernel<ZK_OP_U32MUL><<<blocks, threads, 0, s>>>(pi, po, n, k); break;
    case ZK_OP_U32ADD: op_chain_kernel<ZK_OP_U32ADD><<<blocks, threads, 0, s>>>(pi, po, n, k); break;
    case ZK_OP_U16MUL: op_chain_kernel<ZK_OP_U16MUL><<<blocks, threads, 0, s>>>(pi, po, n, k); break;
    case ZK_OP_F32FMA: op_chain_kernel<ZK_OP_F32FMA><<<blocks, threads, 0, s>>>(pi, po, n, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

#define TILED_MAX_THREADS 384

__global__ void __launch_bounds__(TILED_MAX_THREADS)
point_add_tiled_kernel(const int32_t* __restrict__ p, int64_t p_ps, int64_t p_ls,
                       const int32_t* __restrict__ q, int64_t q_ps, int64_t q_ls,
                       int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls,
                       int64_t n, int64_t tile) {
  typedef CurveField<1> Fd;
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int64_t j = threadIdx.x; j < tile; j += blockDim.x) {
    const int64_t i = base + j;
    if (i >= n) return;
    const Fe x1 = Fd::load(p, p_ps, p_ls, 0, i);
    const Fe y1 = Fd::load(p, p_ps, p_ls, 1, i);
    const Fe z1 = Fd::load(p, p_ps, p_ls, 2, i);
    const Fe x2 = Fd::load(q, q_ps, q_ls, 0, i);
    const Fe y2 = Fd::load(q, q_ps, q_ls, 1, i);
    const Fe z2 = Fd::load(q, q_ps, q_ls, 2, i);
    Fe x3, y3, z3;
    rcb_add<1>(x1, y1, z1, x2, y2, z2, x3, y3, z3);
    Fd::store(out, o_ps, o_ls, 0, i, x3);
    Fd::store(out, o_ps, o_ls, 1, i, y3);
    Fd::store(out, o_ps, o_ls, 2, i, z3);
  }
}

extern "C" int zk_point_add_tiled(const void* p, long long p_ps, long long p_ls,
                                  const void* q, long long q_ps, long long q_ls,
                                  void* out, long long o_ps, long long o_ls,
                                  long long n, long long tile, int threads, void* stream) {
  if (n <= 0) return 0;
  if (tile <= 0 || threads <= 0 || threads > TILED_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + tile - 1) / tile);
  point_add_tiled_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p, p_ps, p_ls, (const int32_t*)q, q_ps, q_ls,
      (int32_t*)out, o_ps, o_ls, n, tile);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

#define CHAIN_MAX_THREADS 256

__global__ void __launch_bounds__(CHAIN_MAX_THREADS)
point_add_chain_kernel(const int32_t* __restrict__ p, int64_t p_ps, int64_t p_ls,
                       int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls, int64_t n, int k) {
  typedef CurveField<1> Fd;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = Fd::load(p, p_ps, p_ls, 0, i);
  Fe y = Fd::load(p, p_ps, p_ls, 1, i);
  Fe z = Fd::load(p, p_ps, p_ls, 2, i);
#pragma unroll 1
  for (int s = 0; s < k; s++) {
    Fe x3, y3, z3;
    rcb_add<1>(x, y, z, x, y, z, x3, y3, z3);
    x = x3;
    y = y3;
    z = z3;
  }
  Fd::store(out, o_ps, o_ls, 0, i, x);
  Fd::store(out, o_ps, o_ls, 1, i, y);
  Fd::store(out, o_ps, o_ls, 2, i, z);
}

extern "C" int zk_point_add_chain(const void* p, long long p_ps, long long p_ls,
                                  void* out, long long o_ps, long long o_ls,
                                  long long n, int k, int threads, void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || threads <= 0 || threads > CHAIN_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  point_add_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p, p_ps, p_ls, (int32_t*)out, o_ps, o_ls, n, k);
  return (int)cudaGetLastError();
}
