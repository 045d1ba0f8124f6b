// The complete projective point add and doubling (Renes-Costello-Batina
// 2016, alg. 7 and alg. 9, a = 0) as device functions, templated on the
// field degree (1: G1 over Fq, 2: G2 over Fq2).
//
// Replaces: zklaim_tpu/ec/pallas_curve.py:_rcb_add (lines 143-164) and
// _rcb_double (lines 167-182), the formulas every Pallas curve kernel
// inlines.  The dataflows are theirs, so the projective outputs are
// bit-identical to jaxcurve.point_add and jaxcurve.point_double, for every
// input including infinity (0, 1, 0).
//
// K4 and K5 (curve.cu) and the probes K8 and K9 (probes.cu) call these
// functions, so a probe times exactly the arithmetic the production kernels
// run; K4's G2 add runs rcb_add_f on Fq2Pair, the same dataflow over a pair
// of threads.  (msm_finish and msm_tails run the same formulas as a schedule
// of Fq steps, ec/rcb_schedule.py.)  The outputs may alias the inputs: every input is
// read before the first output is written.
#pragma once

#include "field.cuh"

// The add over any curve-field type Fd (T, add, sub, dbl, mul, mul_b3):
// CurveField<1> and CurveField<2> (one thread a lane), Fq2Pair (a G2 lane
// over two threads, each holding one Fq component of every value).
template <class Fd>
__device__ __forceinline__ void rcb_add_f(
    const typename Fd::T& x1, const typename Fd::T& y1, const typename Fd::T& z1,
    const typename Fd::T& x2, const typename Fd::T& y2, const typename Fd::T& z2,
    typename Fd::T& x3, typename Fd::T& y3, typename Fd::T& z3) {
  typedef typename Fd::T T;
  const T t0 = Fd::mul(x1, x2);
  const T t1 = Fd::mul(y1, y2);
  const T t2 = Fd::mul(z1, z2);
  const T m0 = Fd::mul(Fd::add(x1, y1), Fd::add(x2, y2));
  const T m1 = Fd::mul(Fd::add(y1, z1), Fd::add(y2, z2));
  const T m2 = Fd::mul(Fd::add(x1, z1), Fd::add(x2, z2));
  const T t3 = Fd::sub(m0, Fd::add(t0, t1));
  const T t4 = Fd::sub(m1, Fd::add(t1, t2));
  const T t5 = Fd::sub(m2, Fd::add(t0, t2));
  const T m = Fd::add(Fd::dbl(t0), t0);
  const T nb = Fd::mul_b3(t2);
  const T bv = Fd::mul_b3(t5);
  const T wmn = Fd::sub(t1, nb);
  const T wpn = Fd::add(t1, nb);
  x3 = Fd::sub(Fd::mul(t3, wmn), Fd::mul(t4, bv));
  y3 = Fd::add(Fd::mul(wpn, wmn), Fd::mul(m, bv));
  z3 = Fd::add(Fd::mul(t4, wpn), Fd::mul(t3, m));
}

template <int DEG>
__device__ __forceinline__ void rcb_add(
    const typename CurveField<DEG>::T& x1, const typename CurveField<DEG>::T& y1,
    const typename CurveField<DEG>::T& z1, const typename CurveField<DEG>::T& x2,
    const typename CurveField<DEG>::T& y2, const typename CurveField<DEG>::T& z2,
    typename CurveField<DEG>::T& x3, typename CurveField<DEG>::T& y3,
    typename CurveField<DEG>::T& z3) {
  rcb_add_f<CurveField<DEG>>(x1, y1, z1, x2, y2, z2, x3, y3, z3);
}

template <int DEG>
__device__ __forceinline__ void rcb_double(
    const typename CurveField<DEG>::T& x, const typename CurveField<DEG>::T& y,
    const typename CurveField<DEG>::T& z, typename CurveField<DEG>::T& x3,
    typename CurveField<DEG>::T& y3, typename CurveField<DEG>::T& z3) {
  typedef CurveField<DEG> Fd;
  typedef typename Fd::T T;
  const T t0 = Fd::mul(y, y);
  const T t1 = Fd::mul(y, z);
  const T t2 = Fd::mul(z, z);
  const T t3 = Fd::mul(x, y);
  const T z8 = Fd::dbl(Fd::dbl(Fd::dbl(t0)));      // 8 Y^2
  const T nb = Fd::mul_b3(t2);                     // 3b Z^2
  const T n3 = Fd::add(Fd::dbl(nb), nb);
  const T t0m = Fd::sub(t0, n3);
  const T t0p = Fd::add(t0, nb);
  z3 = Fd::mul(t1, z8);
  y3 = Fd::add(Fd::mul(t0m, t0p), Fd::mul(nb, z8));
  x3 = Fd::dbl(Fd::mul(t0m, t3));
}
