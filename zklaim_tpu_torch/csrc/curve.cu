// K4 and K5: the complete projective point add and point doubling
// (Renes-Costello-Batina 2016, alg. 7 and alg. 9, a = 0) on limb planes, and
// the MSM finish built from them, all templated on the field degree (1: G1
// over Fq, 2: G2 over Fq2).
//
// Layout (all kernels): a point batch is 3 * deg planes of (16, n) int32
// limbs, G2 in the order (x0, x1, y0, y1, z0, z1).  Each operand is a base
// pointer with its own plane and limb (row) strides; elements are
// contiguous.
//
// K4 point_add
// Replaces: zklaim_tpu/ec/pallas_curve.py:_add_kernel, launched through
// _padd_soa (point_add_planes) and _padd_halves_soa (point_add_halves).
// The formula is rcb.cuh's rcb_add_f, the dataflow of _rcb_add
// (pallas_curve.py:143-164), so the projective outputs are bit-identical to
// jaxcurve.point_add; the probes of probes.cu call the same function.  With
// per-operand strides the halves mode -- lo half + hi half of one plane set
// (point_add_halves: msm_ladder's fold) -- is one launch on two strided
// views, with no copy.  A pass's upsweep and Abel tree, many levels of
// halves each, are msm_upsweep and msm_abel below.
// G1: one thread per lane, everything in registers.
// G2: one thread a lane kept the six Fq2 inputs (96 registers) and the
// temporaries live and spilled at 255 registers; so a lane runs on a PAIR of
// adjacent threads (field.cuh:Fq2Pair), each holding one Fq component of
// every value: sums stay in the thread, a product swaps the partner's
// components by __shfl_xor_sync and takes two of the schoolbook's four Fq
// products, 28 a thread and 56 a lane where Karatsuba needs 42.
// What bounds it on the card: one launch moves 9 deg field elements a lane
// (6 in, 3 out, 64 B each) for 12 Fq products (G1; 42 over Fq2), so a G1
// launch is bound by its bytes and a G2 one by its products.  Its callers
// add one level at a time (the chunk sums of a batched MSM, the comb,
// scalar_mul, msm_ladder's fold), where nothing stays on chip between
// launches; the levels of a pass, which can, are msm_upsweep's.
//
// msm_tails (K4's second entry)
// Replaces: the bucket-tail loop of zklaim_tpu/msm/pippenger.py:337-343,
// which for each of the nb + 1 upsweep levels gathers one node a tail lane,
// adds it (K4) and keeps the sum where bit t of the lane's prefix length m
// is set; as eager calls that is 22 rounds of a bit reversal, a gather, a K4
// launch and a select a pass, about a thousand small launches.  Here a
// pass's whole stage is ONE launch.  Skipping a level whose bit is clear is
// what the select chose, and the adds run in the same order with the same
// dataflow, so the output matches the loop limb for limb.  Each tail lane
// is a chain of popcount(m) dependent adds, on 16,512 (G1, four sums) or
// 4,128 (G2) lanes: one thread a lane would leave most of the card idle
// behind fe_mul's latency, and a G2 lane spills.  So the add runs as
// msm_finish runs it: a schedule (ec/rcb_schedule.py:tails_schedule, the
// add alone) over a group of 6 (G1) or 24 (G2) threads, a product each a
// round, about 99k threads either way.  Each group walks the set bits of its
// own m, lowest first: every group of a warp runs the same steps on its own
// file, whatever level it is on, so a warp pays the largest popcount of its
// groups, not the 22 levels.  The column read at level t is
// rev_{nb-t}(clamp((m >> t) - 1, 0, 2^(nb-t) - 1)), the reversal by
// __brevll and a shift.  The levels reach the kernel as a by-value table of
// (base, plane stride, limb stride), one row a level, in the launch's
// parameters: the upsweep's levels stay separate tensors, views included,
// and no table is copied to the card before the launch.
// What bounds it: the dependent chain of a lane (two or three product steps
// and eight or so linear steps an add, popcount(m) adds) against the card's
// multiply throughput once all 132 SMs hold groups; bytes are small (one
// node a set bit and one point a lane).
//
// msm_upsweep and msm_abel (K4's third and fourth entries)
// Replaces: zklaim_tpu/ec/pallas_curve.py:_add_kernel launched through
// _padd_halves_soa (:369) in the upsweep loop of zklaim_tpu/msm/pippenger.py
// (:317, every level of a pass, column j of level t + 1 = column j + column
// j + w_t / 2 of level t) and in its Abel loop (:354, the B k W heads halved
// to k W window columns).  As K4 launches that is one launch a level, 28 a
// G1 pass of 2^21 lanes (21 + 7) and 27 a G2 pass: 22 of the 28 narrower
// than one wave of the card, each paying the launch floor and its host
// call, and each level written by one launch and read back by the next.
// Here a launch computes r consecutive levels t + 1 ... t + r: column j of
// level t + r is a tree over the 2^r columns j + i w_{t+r} of level t, all in
// j's residue class mod w_{t+r}, so a CTA that owns T neighbouring columns of
// level t + r reads its 2^r T inputs as 2^r runs of T columns, keeps level
// t + 1 (2^(r-1) T points, 96 B a G1 and 192 B a G2 point, in 48 KB) in
// shared memory and each level after it in the first slots of the same
// memory, and stores every level's columns to device memory, where
// msm_tails reads them (the levels are views into one buffer, the table of
// (base, plane stride, limb stride) the tails take).  The plan, r and T a
// launch, is msm/upsweep_plan.py:upsweep_plan, as many levels a launch as
// the shared memory holds: the first launch, 7/8 of the adds, one column a
// lane (T = 128 G1, 64 G2; 3 levels); the later ones runs of a warp's
// columns (T = 32 G1, 16 G2: a warp's 128-byte line of a limb of each plane
// it reads; 5 levels); and, once the levels left fit one CTA, one launch of
// one CTA down to width 1: a G1 pass of 2^21 lanes in 4 launches (3 + 5 + 5
// + 8 levels), a G2 pass of 2^20 in 4 (3 + 5 + 5 + 7), where K4 took 21 and
// 20.  msm_abel is the same kernel from the heads to the k W columns with
// only a launch's last level stored, one CTA a column (G1 k = 4, c = 8: 7
// levels, 128 CTAs): one launch where a column's tree fits a CTA (up to
// c = 11 G1, 10 G2), past that a chain of launches, each one's columns the
// next one's heads (msm/upsweep_plan.py:abel_plan; c = 16: 8 + 7 levels).
// A lane runs the add one thread a lane (G1) or on a pair of threads (G2,
// Fq2Pair), as K4, at K4's occupancy (three CTAs of 128 threads an SM); a
// thread loops over its outputs, a barrier between levels; the pairing and
// the formula are K4's, so every level equals the K4 loop's limb for limb.
// What bounds it: the adds, 2^nb - 1 a pass (12 Fq products a G1 add, 42
// over Fq2).  A G1 pass of 2^21 lanes is 0.240 ms by bytes (level 0 read
// once, every level written once: 9 field elements an add, where the K4
// loop moved 9 a lane a level) and 0.204 ms by the assumed product rate;
// the add itself runs at K4's rate (tools/msm_stages.py times the plan
// launch by launch beside the K4 loop), a launch of many levels loses to
// the loop what its last wave leaves idle, and below the card's width
// every level is at least one dependent add a lane, which no launch shape
// removes: the last launches are latency-bound.
//
// K5 point_double
// Replaces: zklaim_tpu/ec/pallas_curve.py:_double_kernel, launched through
// _pdouble_soa (point_double).  One thread per lane; the formula is
// rcb.cuh's rcb_double, the dataflow of _rcb_double
// (pallas_curve.py:167-182), bit-identical to jaxcurve.point_double for
// every input including infinity (0, 1, 0).
// What bounds it on the card: integer multiply-adds -- 8 Fq multiplies for
// G1; 8 Fq2 = 24 Fq multiplies plus one Fq2 constant multiply (3 more) for
// G2 -- against 3 deg x 64 B in and as much out per lane.  Its callers are
// wide: the 256 steps of scalar_mul / msm_ladder.  The MSM finish, c
// doublings a Horner step on 1-4 lanes, is msm_finish below.
//
// msm_finish (K5's second entry)
// Replaces: zklaim_tpu/msm/pippenger.py:_finish, which under jit is two
// lax.fori_loops over point_double and point_add; as a loop of eager calls it
// would be 263 K5 and 33 K4 launches a finish on 1-128 lanes, each a few
// threads of one SM and 20-50 us of the host.  Here a finish is ONE launch of one
// CTA, and the window points never reach device memory:
//   phase A: for each of the k W window lanes, c - 1 doublings of tot and
//     one add of the negated head; the window point stays in shared memory
//     (G1 k W = 128: 12 KB; G2 32: 6 KB);
//   phase B: for each of the k sums, acc = infinity; for w = W-1..0:
//     acc = 2^c acc + window[i W + w].
// Phase B is a chain: a thread a sum would run the 8 (27) products of a
// doubling and the 12 (42) of an add one after the other, 2,432 (8,256)
// dependent products.  Instead the independent products of ONE point
// operation are spread over a group of threads of a warp: a doubling is two
// rounds of 4 products, an add two rounds of 6 (over Fq2 each product is
// four Fq products, and 3b' and 9b' one more round), so a group of 6 (24)
// threads takes one product each a round.  Threads that run different
// straight-line code diverge, so the formula is not code but a schedule
// (ec/rcb_schedule.py builds it, the CPU tests interpret it against the
// plain formulas): a list of steps, each either products or additions and
// subtractions in Fq, and in it, for every thread of the group, an opcode,
// two source slots and a destination slot in the group's file of field
// elements in shared memory.  Every thread of a product step runs the same
// fe_mul on its own operands; __syncwarp() separates a step's reads from
// its writes.  That cuts the chain to 576 (864) product steps plus the
// cheaper linear ones.  Phase A runs the same schedule, one group a window
// lane, five (one) groups a warp and up to 16 warps, so the kernel holds
// no straight-line point formula at all and compiles in seconds.  Sums go
// to different warps first, lanes fill every group.
// Every field operation returns the canonical residue, so the schedule's
// order of operations gives the limbs of the reference's.
// What bounds it: the latency of one warp's dependent chain (about 1 us a
// product step, as K6 measures fe_mul at low occupancy, and a fraction of
// that a linear step); bytes and throughput are nothing (one CTA).
// ptxas (CUDA 12.8, sm_90a; chip_smoke.py prints them), registers: K4 132
// (G1) and 136 (G2 on a pair of threads; one thread a lane took 255 and
// spilled 128 bytes), msm_upsweep and msm_abel 136 (G1) and 168 (G2; at
// most 170 under the bounds of a 384-thread CTA), msm_tails 48, msm_finish
// 99, K5 78 / 190; no kernel spills or keeps a stack frame.
#include <cuda_runtime.h>

#include "field.cuh"
#include "rcb.cuh"

template <int DEG>
__global__ void point_add_kernel(const int32_t* __restrict__ p, int64_t p_ps, int64_t p_ls,
                                 const int32_t* __restrict__ q, int64_t q_ps, int64_t q_ls,
                                 int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls,
                                 int64_t n) {
  if constexpr (DEG == 2) {
    // a lane over a pair of threads; thread h loads and stores plane 2 c + h
    // of coordinate c.  A pair past the end recomputes lane n - 1 and stores
    // nothing: every thread of the warp reaches the shuffles.
    const int64_t lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
    const int h = threadIdx.x & 1;
    const bool live = lane < n;
    const int64_t i = live ? lane : n - 1;
    const Fe x1 = fe_load(p + h * p_ps, p_ls, 1, i);
    const Fe y1 = fe_load(p + (2 + h) * p_ps, p_ls, 1, i);
    const Fe z1 = fe_load(p + (4 + h) * p_ps, p_ls, 1, i);
    const Fe x2 = fe_load(q + h * q_ps, q_ls, 1, i);
    const Fe y2 = fe_load(q + (2 + h) * q_ps, q_ls, 1, i);
    const Fe z2 = fe_load(q + (4 + h) * q_ps, q_ls, 1, i);

    Fe x3, y3, z3;
    rcb_add_f<Fq2Pair>(x1, y1, z1, x2, y2, z2, x3, y3, z3);

    if (live) {
      fe_store(out + h * o_ps, o_ls, 1, i, x3);
      fe_store(out + (2 + h) * o_ps, o_ls, 1, i, y3);
      fe_store(out + (4 + h) * o_ps, o_ls, 1, i, z3);
    }
  } else {
    typedef CurveField<DEG> Fd;
    typedef typename Fd::T T;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const T x1 = Fd::load(p, p_ps, p_ls, 0, i);
    const T y1 = Fd::load(p, p_ps, p_ls, 1, i);
    const T z1 = Fd::load(p, p_ps, p_ls, 2, i);
    const T x2 = Fd::load(q, q_ps, q_ls, 0, i);
    const T y2 = Fd::load(q, q_ps, q_ls, 1, i);
    const T z2 = Fd::load(q, q_ps, q_ls, 2, i);

    T x3, y3, z3;
    rcb_add<DEG>(x1, y1, z1, x2, y2, z2, x3, y3, z3);

    Fd::store(out, o_ps, o_ls, 0, i, x3);
    Fd::store(out, o_ps, o_ls, 1, i, y3);
    Fd::store(out, o_ps, o_ls, 2, i, z3);
  }
}

template <int DEG>
__global__ void point_double_kernel(const int32_t* __restrict__ p, int64_t p_ps, int64_t p_ls,
                                    int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls,
                                    int64_t n) {
  typedef CurveField<DEG> Fd;
  typedef typename Fd::T T;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T x = Fd::load(p, p_ps, p_ls, 0, i);
  const T y = Fd::load(p, p_ps, p_ls, 1, i);
  const T z = Fd::load(p, p_ps, p_ls, 2, i);

  T x3, y3, z3;
  rcb_double<DEG>(x, y, z, x3, y3, z3);

  Fd::store(out, o_ps, o_ls, 0, i, x3);
  Fd::store(out, o_ps, o_ls, 1, i, y3);
  Fd::store(out, o_ps, o_ls, 2, i, z3);
}

extern "C" int zk_point_add(int deg,
                            const void* p, long long p_ps, long long p_ls,
                            const void* q, long long q_ps, long long q_ls,
                            void* out, long long o_ps, long long o_ls,
                            long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long per_lane = deg == 2 ? 2 : 1;          // G2: a pair of threads a lane
  const unsigned blocks = (unsigned)((per_lane * n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pp = (const int32_t*)p;
  const int32_t* pq = (const int32_t*)q;
  int32_t* po = (int32_t*)out;
  if (deg == 1) {
    point_add_kernel<1><<<blocks, threads, 0, s>>>(pp, p_ps, p_ls, pq, q_ps, q_ls, po, o_ps, o_ls, n);
  } else if (deg == 2) {
    point_add_kernel<2><<<blocks, threads, 0, s>>>(pp, p_ps, p_ls, pq, q_ps, q_ls, po, o_ps, o_ls, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int zk_point_double(int deg,
                               const void* p, long long p_ps, long long p_ls,
                               void* out, long long o_ps, long long o_ls,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pp = (const int32_t*)p;
  int32_t* po = (int32_t*)out;
  if (deg == 1) {
    point_double_kernel<1><<<blocks, threads, 0, s>>>(pp, p_ps, p_ls, po, o_ps, o_ls, n);
  } else if (deg == 2) {
    point_double_kernel<2><<<blocks, threads, 0, s>>>(pp, p_ps, p_ls, po, o_ps, o_ls, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// msm_finish
// ---------------------------------------------------------------------------

#define FIN_THREADS 512      // 16 warps: 128 registers a thread, so the interpreter does not spill
#define FIN_SHARED_MAX (227 * 1024)
#define FIN_MUL 0
#define FIN_ADD 1
#define FIN_SUB 2
#define FIN_IDLE 0xffu
// the schedule (ec/rcb_schedule.py:pack): header words, then the constants,
// the doubling's steps and the add's steps
#define FIN_G 0              // threads of a group
#define FIN_NS 1             // slots of a group's file
#define FIN_NCONST 2
#define FIN_SDBL 3
#define FIN_SADD 4
#define FIN_ACC 5            // 6 words: the slot of each component of acc
#define FIN_Q 11             // 6 words: the slot of each component of the addend
#define FIN_HDR 17

// slot s of a file of ns slots: word w at file[w * ns + s], so threads that
// read different slots read different banks
__device__ __forceinline__ Fe slot_load(const uint32_t* file, int ns, uint32_t s) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = file[w * ns + s];
  return r;
}

__device__ __forceinline__ void slot_store(uint32_t* file, int ns, uint32_t s, const Fe& a) {
#pragma unroll
  for (int w = 0; w < 8; w++) file[w * ns + s] = a.v[w];
}

// The groups of one warp run `nsteps` steps of a schedule, each on its own
// file; every thread of the warp calls this, `on` false for a thread whose
// group has nothing to do.  A step is one word a member, a | b << 8 |
// d << 16 | op << 24: slot d = slot a (op) slot b.  A step holds products
// only or linear operations only (rcb_schedule.pack checks it), so a product
// step does not diverge.
__device__ __forceinline__ void run_steps(const uint32_t* steps, int nsteps, int g,
                                          uint32_t* file, int ns, int member, bool on) {
  uint32_t next = on && nsteps > 0 ? steps[member] : (FIN_IDLE << 16);
#pragma unroll 1
  for (int s = 0; s < nsteps; s++) {
    const uint32_t e = next;
    next = on && s + 1 < nsteps ? steps[(s + 1) * g + member] : (FIN_IDLE << 16);
    const uint32_t d = (e >> 16) & 0xffu, op = e >> 24;
    Fe r;
    if (d != FIN_IDLE) {
      const Fe a = slot_load(file, ns, e & 0xffu);
      const Fe b = slot_load(file, ns, (e >> 8) & 0xffu);
      if (op == FIN_MUL) {
        r = fe_mul<ZK_FQ>(a, b);
      } else if (op == FIN_ADD) {
        r = fe_add<ZK_FQ>(a, b);
      } else {
        r = fe_sub<ZK_FQ>(a, b);
      }
    }
    __syncwarp();                       // every read of the step before any write
    if (d != FIN_IDLE) slot_store(file, ns, d, r);
    __syncwarp();
  }
}

// nc = 3 deg Fq components a point: plane j of tot, head and out is
// component j, and window lane l's component j, word w is win[(j * 8 + w) * kw + l].
__global__ void __launch_bounds__(FIN_THREADS)
msm_finish_kernel(const int32_t* __restrict__ tot, int64_t t_ps, int64_t t_ls,
                  const int32_t* __restrict__ head, int64_t h_ps, int64_t h_ls,
                  int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls,
                  int nc, int k, int W, int c,
                  const uint32_t* __restrict__ sched, int sched_words) {
  extern __shared__ uint32_t smem[];
  const int kw = k * W;
  const int tid = threadIdx.x;
  uint32_t* prog = smem;
  uint32_t* win = prog + sched_words;
  uint32_t* files = win + nc * 8 * kw;
  for (int j = tid; j < sched_words; j += blockDim.x) prog[j] = sched[j];
  __syncthreads();

  const int g = prog[FIN_G], ns = prog[FIN_NS], nconst = prog[FIN_NCONST];
  const int sdbl = prog[FIN_SDBL], sadd = prog[FIN_SADD];
  const uint32_t* consts = prog + FIN_HDR;
  const uint32_t* dbl_steps = consts + 9 * nconst;
  const uint32_t* add_steps = dbl_steps + sdbl * g;
  // a warp holds 32 / g groups; unit u = group * warps + warp, so the first
  // units lie in different warps
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int group = (tid & 31) / g, member = (tid & 31) % g;
  const bool seated = group < 32 / g;
  const int unit = group * nwarps + warp, units = (32 / g) * nwarps;
  uint32_t* file = files + unit * ns * 8;
  const bool point = seated && member < nc;         // this thread moves component `member`
  const uint32_t acc_slot = point ? prog[FIN_ACC + member] : 0;
  const uint32_t q_slot = point ? prog[FIN_Q + member] : 0;
  const bool is_y = member / (nc / 3) == 1;

  // ---- phase A: window lane l = 2^(c-1) tot[l] - head[l] -------------------
  for (int base = 0; base < kw; base += units) {
    const int lane = base + unit;
    const bool on = seated && lane < kw;
    if (on) {
      for (int j = member; j < nconst; j += g) {
        const uint32_t* cj = consts + 9 * j;
#pragma unroll
        for (int w = 0; w < 8; w++) file[w * ns + cj[0]] = cj[1 + w];
      }
    }
    __syncwarp();                       // acc = infinity was among the constants:
    if (on && point) slot_store(file, ns, acc_slot, fe_load(tot + member * t_ps, t_ls, 1, lane));
    __syncwarp();
#pragma unroll 1
    for (int j = 0; j < c; j++) {
      if (j == c - 1) {                 // the addend: -head
        if (on && point) {
          Fe h = fe_load(head + member * h_ps, h_ls, 1, lane);
          if (is_y) h = fe_sub<ZK_FQ>(Fe(), h);
          slot_store(file, ns, q_slot, h);
        }
        __syncwarp();
      }
      run_steps(j == c - 1 ? add_steps : dbl_steps, j == c - 1 ? sadd : sdbl, g, file, ns,
                member, on);
    }
    if (on && point) {
      const Fe v = slot_load(file, ns, acc_slot);
#pragma unroll
      for (int w = 0; w < 8; w++) win[(member * 8 + w) * kw + lane] = v.v[w];
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- phase B: sum i = Horner over its W window points --------------------
  for (int base = 0; base < k; base += units) {
    const int i = base + unit;
    const bool on = seated && i < k;
    if (on) {                           // the constants again: acc = infinity
      for (int j = member; j < nconst; j += g) {
        const uint32_t* cj = consts + 9 * j;
#pragma unroll
        for (int w = 0; w < 8; w++) file[w * ns + cj[0]] = cj[1 + w];
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int w = W - 1; w >= 0; w--) {
#pragma unroll 1
      for (int j = 0; j <= c; j++) {
        if (j == c) {                   // the addend: window w of sum i
          if (on && point) {
#pragma unroll
            for (int wd = 0; wd < 8; wd++) {
              file[wd * ns + q_slot] = win[(member * 8 + wd) * kw + i * W + w];
            }
          }
          __syncwarp();
        }
        run_steps(j == c ? add_steps : dbl_steps, j == c ? sadd : sdbl, g, file, ns, member, on);
      }
    }
    if (on && point) fe_store(out + member * o_ps, o_ls, 1, i, slot_load(file, ns, acc_slot));
    __syncwarp();
  }
}

// g, slots: the schedule's group size and file size (its header words FIN_G
// and FIN_NS).  Shared memory of a launch: the schedule, the window points,
// one file a group; above 48 KB the kernel opts in to as much as it needs.
extern "C" int zk_msm_finish(int deg,
                             const void* tot, long long t_ps, long long t_ls,
                             const void* head, long long h_ps, long long h_ls,
                             void* out, long long o_ps, long long o_ls,
                             int k, int W, int c,
                             const void* sched, int sched_words, int g, int slots,
                             void* stream) {
  if (k <= 0) return 0;
  if ((deg != 1 && deg != 2) || W <= 0 || c < 2 || sched_words < FIN_HDR || slots <= 0 ||
      g < 3 * deg || g > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int kw = k * W, per_warp = 32 / g;
  int warps = (kw + per_warp - 1) / per_warp;        // a group a window lane, if they fit
  if (warps < k) warps = k;                          // and a warp a sum
  if (warps > FIN_THREADS / 32) warps = FIN_THREADS / 32;
  const size_t bytes = 4 * ((size_t)sched_words + (size_t)3 * deg * 8 * kw +
                            (size_t)warps * per_warp * slots * 8);
  if (bytes > FIN_SHARED_MAX) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    // the limit is the kernel's, shared by every host thread that launches it: set the
    // largest a launch may ask for, so that no thread's smaller one comes between
    // another thread's set and its launch
    cudaError_t err = cudaFuncSetAttribute(msm_finish_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           FIN_SHARED_MAX);
    if (err != cudaSuccess) return (int)err;
  }
  msm_finish_kernel<<<1, warps * 32, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)tot, t_ps, t_ls, (const int32_t*)head, h_ps, h_ls,
      (int32_t*)out, o_ps, o_ls, 3 * deg, k, W, c, (const uint32_t*)sched, sched_words);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// msm_tails
// ---------------------------------------------------------------------------

#define TAIL_THREADS 256
#define TAIL_MAX_LEVELS 32

// the upsweep levels, by value in the launch: base pointer, plane stride and
// limb (row) stride of level t (3 x 32 x 8 = 768 bytes of parameters)
struct TailLevels {
  const int32_t* base[TAIL_MAX_LEVELS];
  int64_t ps[TAIL_MAX_LEVELS];
  int64_t ls[TAIL_MAX_LEVELS];
};

// One group of g threads a tail lane, units = (TAIL_THREADS / 32) (32 / g)
// lanes a CTA, adjacent lanes in one warp.  The group's file starts as the
// schedule's constants (acc = infinity); for each set bit t of the lane's m,
// lowest first, the members fetch component `member` of the node at column
// rev_{nb-t}(clamp((m >> t) - 1, 0, 2^(nb-t) - 1)) of level t into the
// addend slots and the group runs the add's steps.
__global__ void __launch_bounds__(TAIL_THREADS)
msm_tails_kernel(const TailLevels lv, int nb, const int64_t* __restrict__ m, int64_t lanes,
                 int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls, int nc,
                 const uint32_t* __restrict__ sched, int sched_words) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  uint32_t* prog = smem;
  uint32_t* files = prog + sched_words;
  for (int j = tid; j < sched_words; j += blockDim.x) prog[j] = sched[j];
  __syncthreads();

  const int g = prog[FIN_G], ns = prog[FIN_NS], nconst = prog[FIN_NCONST];
  const int sadd = prog[FIN_SADD];
  const uint32_t* consts = prog + FIN_HDR;
  const uint32_t* add_steps = consts + 9 * nconst + prog[FIN_SDBL] * g;
  const int per_warp = 32 / g;
  const int group = (tid & 31) / g, member = (tid & 31) % g;
  const bool seated = group < per_warp;
  const int unit = (tid >> 5) * per_warp + group;
  const int64_t lane = (int64_t)blockIdx.x * ((blockDim.x >> 5) * per_warp) + unit;
  const bool on = seated && lane < lanes;
  const bool point = on && member < nc;             // this thread moves component `member`
  uint32_t* file = files + (seated ? unit : 0) * ns * 8;
  const int64_t mi = on ? m[lane] : 0;
  uint64_t bits = (uint64_t)mi & ((2ull << nb) - 1);  // bits above nb name no level
  const uint32_t q_slot = point ? prog[FIN_Q + member] : 0;
  if (on) {
    for (int j = member; j < nconst; j += g) {
      const uint32_t* cj = consts + 9 * j;
#pragma unroll
      for (int w = 0; w < 8; w++) file[w * ns + cj[0]] = cj[1 + w];
    }
  }
  __syncwarp();
  // Each group walks its own set bits; the warp runs until its last group is
  // done.  Groups on different levels run the same steps on their own
  // files, so they do not diverge.
  while (__any_sync(0xffffffffu, bits != 0)) {
    const bool act = bits != 0;
    if (act && point) {
      const int t = __ffsll((long long)bits) - 1;
      const int w = nb - t;
      const int64_t top = ((int64_t)1 << w) - 1;
      int64_t nat = (mi >> t) - 1;
      nat = nat < 0 ? 0 : (nat > top ? top : nat);
      const int64_t col = w > 0 ? (int64_t)(__brevll((unsigned long long)nat) >> (64 - w)) : nat;
      slot_store(file, ns, q_slot, fe_load(lv.base[t] + member * lv.ps[t], lv.ls[t], 1, col));
    }
    __syncwarp();
    run_steps(add_steps, sadd, g, file, ns, member, act);
    bits &= bits - 1;
  }
  if (point) {
    fe_store(out + member * o_ps, o_ls, 1, lane, slot_load(file, ns, prog[FIN_ACC + member]));
  }
}

// levels: nlevels (base, plane stride, limb stride) triples in host memory;
// m: lanes int64 prefix lengths; g, slots: the schedule's group and file size.
extern "C" int zk_msm_tails(int deg, const long long* levels, int nlevels,
                            const void* m, long long lanes,
                            void* out, long long o_ps, long long o_ls,
                            const void* sched, int sched_words, int g, int slots,
                            void* stream) {
  if (lanes <= 0) return 0;
  if ((deg != 1 && deg != 2) || nlevels < 1 || nlevels > TAIL_MAX_LEVELS ||
      sched_words < FIN_HDR || slots <= 0 || g < 3 * deg || g > 32) {
    return (int)cudaErrorInvalidValue;
  }
  TailLevels lv;
  for (int t = 0; t < TAIL_MAX_LEVELS; t++) {
    const bool given = t < nlevels;
    lv.base[t] = given ? (const int32_t*)levels[3 * t] : nullptr;
    lv.ps[t] = given ? levels[3 * t + 1] : 0;
    lv.ls[t] = given ? levels[3 * t + 2] : 0;
  }
  const int units = (TAIL_THREADS / 32) * (32 / g);
  const size_t bytes = 4 * ((size_t)sched_words + (size_t)units * slots * 8);
  if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (lanes + units - 1) / units;
  msm_tails_kernel<<<(unsigned)blocks, TAIL_THREADS, bytes, (cudaStream_t)stream>>>(
      lv, nlevels - 1, (const int64_t*)m, lanes, (int32_t*)out, o_ps, o_ls, 3 * deg,
      (const uint32_t*)sched, sched_words);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// msm_upsweep and msm_abel
// ---------------------------------------------------------------------------

#define UPS_THREADS 128           // a CTA of a launch that fills the card: three an SM
#define UPS_NARROW_THREADS 384    // a CTA of a launch of fewer CTAs than SMs: one an SM
#define UPS_SHARED_MAX (48 * 1024)

// The add a lane runs: G1 one thread, G2 a pair of threads (Fq2Pair), each
// thread holding one Fq component of every value.
template <int DEG>
struct LaneField;
template <>
struct LaneField<1> {
  typedef CurveField<1> F;
};
template <>
struct LaneField<2> {
  typedef Fq2Pair F;
};

// Shared-memory slot x of a CTA that keeps ns slots: word w of component c,
// thread half h (G2: the pair's Fq component), at ((c * 8 + w) * ns + x) *
// DEG + h, so the threads of a warp touch neighbouring words.
template <int DEG>
__device__ __forceinline__ Fe ups_slot_load(const uint32_t* sm, int ns, int x, int h, int c) {
  Fe r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = sm[((c * 8 + w) * ns + x) * DEG + h];
  return r;
}

template <int DEG>
__device__ __forceinline__ void ups_slot_store(uint32_t* sm, int ns, int x, int h, int c,
                                               const Fe& a) {
#pragma unroll
  for (int w = 0; w < 8; w++) sm[((c * 8 + w) * ns + x) * DEG + h] = a.v[w];
}

// The column of level t + s that slot x of the CTA whose first column is b0
// stands for, in a launch whose last level is w_out wide and gives a CTA T
// (a power of two) columns: msm/upsweep_plan.py:column.
__device__ __forceinline__ int64_t ups_col(int64_t b0, int x, int T, int64_t w_out) {
  return b0 + (x & (T - 1)) + (int64_t)(x / T) * w_out;
}

// Levels t + 1 ... t + r from level t (lv.base[t]); CTA b owns columns
// b T ... b T + T - 1 of level t + r.  Local level s has nout = 2^(r-s) T
// outputs: slot x = slot x + slot x + nout of level s - 1 (s = 1: the
// columns of level t those slots stand for, read from device memory), kept
// in slot x while s < r and stored to level t + s where `inner` is set or
// s = r.  A slot x < nout is read only by output x, so each level is
// computed in place; a barrier separates the levels.  A lane loops over
// the outputs nout / (lanes a CTA) apart; a warp leaves the loop as a
// whole (the G2 add shuffles over the full warp), a lane past the end adds
// zeros and stores nothing.  A launch of fewer CTAs than the card has SMs
// leaves SMs idle whatever its CTAs do, so its CTAs take 384 threads (the
// most whose registers, at most 170 each under these bounds, fit one SM):
// its lanes take fewer turns at the first levels, where each turn is the
// latency of a whole add.
template <int DEG>
__global__ void __launch_bounds__(UPS_NARROW_THREADS)
msm_upsweep_kernel(const TailLevels lv, int t, int r, int T, int64_t w_out, int inner) {
  typedef typename LaneField<DEG>::F Fd;
  extern __shared__ uint32_t ups_smem[];
  const int h = DEG == 2 ? (threadIdx.x & 1) : 0;
  const int lane = threadIdx.x / DEG;
  const int lanes = blockDim.x / DEG;
  const int warp_lane0 = (threadIdx.x & ~31) / DEG;
  const int ns = (1 << (r - 1)) * T;
  const int64_t b0 = (int64_t)blockIdx.x * T;
  const int32_t* src = lv.base[t];
  const int64_t s_ps = lv.ps[t], s_ls = lv.ls[t];
#pragma unroll 1
  for (int s = 1; s <= r; s++) {
    const int nout = (1 << (r - s)) * T;
    const bool keep = s < r;
    const bool store = inner || s == r;
    int32_t* dst = (int32_t*)lv.base[t + s];
    const int64_t d_ps = lv.ps[t + s], d_ls = lv.ls[t + s];
#pragma unroll 1
    for (int base = 0; base + warp_lane0 < nout; base += lanes) {
      const int x = base + lane;
      const bool live = x < nout;
      Fe a[3], q[3];
#pragma unroll
      for (int c = 0; c < 3; c++) a[c] = q[c] = Fe();
      if (live && s == 1) {
        const int64_t ca = ups_col(b0, x, T, w_out), cq = ups_col(b0, x + nout, T, w_out);
#pragma unroll
        for (int c = 0; c < 3; c++) {
          a[c] = fe_load(src + (DEG * c + h) * s_ps, s_ls, 1, ca);
          q[c] = fe_load(src + (DEG * c + h) * s_ps, s_ls, 1, cq);
        }
      } else if (live) {
#pragma unroll
        for (int c = 0; c < 3; c++) {
          a[c] = ups_slot_load<DEG>(ups_smem, ns, x, h, c);
          q[c] = ups_slot_load<DEG>(ups_smem, ns, x + nout, h, c);
        }
      }
      Fe o[3];
      rcb_add_f<Fd>(a[0], a[1], a[2], q[0], q[1], q[2], o[0], o[1], o[2]);
      if (live && keep) {
#pragma unroll
        for (int c = 0; c < 3; c++) ups_slot_store<DEG>(ups_smem, ns, x, h, c, o[c]);
      }
      if (live && store) {
        const int64_t co = ups_col(b0, x, T, w_out);
#pragma unroll
        for (int c = 0; c < 3; c++) fe_store(dst + (DEG * c + h) * d_ps, d_ls, 1, co, o[c]);
      }
    }
    __syncthreads();
  }
}

static int ups_launch(int deg, const TailLevels& lv, int t, int r, int T, long long w_out,
                      int inner, cudaStream_t s) {
  if ((deg != 1 && deg != 2) || r < 1 || r > 30 || T < 1 || (T & (T - 1)) || w_out < T ||
      w_out % T) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = ((size_t)1 << (r - 1)) * T * 3 * 8 * 4 * deg;
  if (bytes > UPS_SHARED_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(w_out / T);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int threads = blocks < (unsigned)sms ? UPS_NARROW_THREADS : UPS_THREADS;
  if (deg == 1) {
    msm_upsweep_kernel<1><<<blocks, threads, bytes, s>>>(lv, t, r, T, w_out, inner);
  } else {
    msm_upsweep_kernel<2><<<blocks, threads, bytes, s>>>(lv, t, r, T, w_out, inner);
  }
  return (int)cudaGetLastError();
}

// levels: nlevels (base, plane stride, limb stride) triples in host memory,
// level l 2^(nlevels - 1 - l) columns wide; one launch of the plan
// (msm/upsweep_plan.py:upsweep_plan): levels t + 1 ... t + r, T columns of
// level t + r a CTA.
extern "C" int zk_msm_upsweep(int deg, const long long* levels, int nlevels, int t, int r, int T,
                              void* stream) {
  if (nlevels < 2 || nlevels > TAIL_MAX_LEVELS || t < 0 || r < 1 || t + r > nlevels - 1) {
    return (int)cudaErrorInvalidValue;
  }
  TailLevels lv;
  for (int l = 0; l < TAIL_MAX_LEVELS; l++) {
    const bool given = l < nlevels;
    lv.base[l] = given ? (const int32_t*)levels[3 * l] : nullptr;
    lv.ps[l] = given ? levels[3 * l + 1] : 0;
    lv.ls[l] = given ? levels[3 * l + 2] : 0;
    if (given && !lv.base[l]) return (int)cudaErrorInvalidValue;
  }
  return ups_launch(deg, lv, t, r, T, 1ll << (nlevels - 1 - t - r), 1, (cudaStream_t)stream);
}

// One launch of the Abel tree: heads (kw 2^r columns) -> out (kw columns) in
// r levels, one CTA a column of out (msm/upsweep_plan.py:abel_plan, whose
// launches chain, out the next launch's heads); the inner levels stay in
// shared memory.
extern "C" int zk_msm_abel(int deg, const void* heads, long long h_ps, long long h_ls,
                           void* out, long long o_ps, long long o_ls, int r, long long kw,
                           void* stream) {
  if (r < 1 || r >= TAIL_MAX_LEVELS || !heads || !out) return (int)cudaErrorInvalidValue;
  TailLevels lv;
  for (int l = 0; l < TAIL_MAX_LEVELS; l++) {
    lv.base[l] = nullptr;
    lv.ps[l] = lv.ls[l] = 0;
  }
  lv.base[0] = (const int32_t*)heads;
  lv.ps[0] = h_ps;
  lv.ls[0] = h_ls;
  lv.base[r] = (const int32_t*)out;
  lv.ps[r] = o_ps;
  lv.ls[r] = o_ls;
  return ups_launch(deg, lv, 0, r, 1, kw, 0, (cudaStream_t)stream);
}
