// K4 and K5: the complete projective point add and point doubling
// (Renes-Costello-Batina 2016, alg. 7 and alg. 9, a = 0) on limb planes,
// templated on the field degree (1: G1 over Fq, 2: G2 over Fq2).
//
// Layout (both kernels): a point batch is 3 * deg planes of (16, n) int32
// limbs, G2 in the order (x0, x1, y0, y1, z0, z1).  Each operand is a base
// pointer with its own plane and limb (row) strides; elements are
// contiguous.  One thread per lane, everything in registers, the whole
// formula one inlined program.
//
// K4 point_add
// Replaces: zklaim_tpu/ec/pallas_curve.py:_add_kernel, launched through
// _padd_soa (point_add_planes) and _padd_halves_soa (point_add_halves).
// The formula is rcb.cuh's rcb_add, the dataflow of _rcb_add
// (pallas_curve.py:143-164), so the projective outputs are bit-identical to
// jaxcurve.point_add; the probes of probes.cu call the same function.  With
// per-operand strides the halves mode of the MSM upsweep -- lo half + hi
// half of one plane set -- is one launch on two strided views, with no
// copy and no second kernel.
// What bounds it on the card: integer multiply throughput (12 Fq
// multiplies for G1; 12 Fq2 = 36 Fq multiplies for G2 plus a Fq2 constant
// multiply per 3b) and registers: a G2 add keeps the six input
// coordinates (96 registers) plus temporaries live.  The bytes moved
// (6 x 64 B in, 3 x 64 B out per coordinate component) are small beside
// the arithmetic.
//
// K5 point_double
// Replaces: zklaim_tpu/ec/pallas_curve.py:_double_kernel, launched through
// _pdouble_soa (point_double).  The formula dataflow is _rcb_double
// (pallas_curve.py:167-182), so the projective outputs are bit-identical
// to jaxcurve.point_double, for every input including infinity (0, 1, 0).
// What bounds it on the card: integer multiply-adds -- 8 Fq multiplies for
// G1; 8 Fq2 = 24 Fq multiplies plus one Fq2 constant multiply (3 more) for
// G2 -- against 3 deg x 64 B in and as much out per lane.  Only three
// input coordinates are live, not six, so the G2 doubling needs far fewer
// registers than the G2 add.  Its callers are the MSM finish's doublings
// at 1-128 lanes: there a launch is a few threads of one SM, each running
// its lane's products one after the other, so the time is launch latency
// plus one thread's serial chain of multiply-adds, not throughput.
#include <cuda_runtime.h>

#include "field.cuh"
#include "rcb.cuh"

template <int DEG>
__global__ void point_add_kernel(const int32_t* __restrict__ p, int64_t p_ps, int64_t p_ls,
                                 const int32_t* __restrict__ q, int64_t q_ps, int64_t q_ls,
                                 int32_t* __restrict__ out, int64_t o_ps, int64_t o_ls,
                                 int64_t n) {
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

  const T t0 = Fd::mul(y, y);
  const T t1 = Fd::mul(y, z);
  const T t2 = Fd::mul(z, z);
  const T t3 = Fd::mul(x, y);
  const T z8 = Fd::dbl(Fd::dbl(Fd::dbl(t0)));      // 8 Y^2
  const T nb = Fd::mul_b3(t2);                     // 3b Z^2
  const T n3 = Fd::add(Fd::dbl(nb), nb);
  const T t0m = Fd::sub(t0, n3);
  const T t0p = Fd::add(t0, nb);
  const T z3 = Fd::mul(t1, z8);
  const T y3 = Fd::add(Fd::mul(t0m, t0p), Fd::mul(nb, z8));
  const T x3 = Fd::dbl(Fd::mul(t0m, t3));

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
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
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
