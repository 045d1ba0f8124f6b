// BN254 Fq / Fr Montgomery arithmetic as CUDA device functions.
//
// Replaces: zklaim_tpu/ff/pallas_field.py (mont_mul, add_mod, sub_mod,
// dbl_mod, mul_small), the in-kernel field library every Pallas kernel
// inlines.  Every kernel of this directory includes this header.
//
// Representation: in device memory an element is 16 little-endian 16-bit
// limbs held in int32 (the JAX package's layout, so arrays compare
// directly); on load it is repacked to 8 x 32-bit limbs in registers and
// unpacked on store.  Multiplication is CIOS Montgomery with
// n' = -p^{-1} mod 2^32 and R = 2^256, followed by one conditional
// subtraction.  With R = 2^256 the canonical result abR^{-1} mod p in
// [0, p) is unique, so it matches the 16-bit SOS/REDC of
// zklaim_tpu/ff/montgomery.py limb for limb.
//
// What bounds it on the card: integer multiply-add throughput (64 32x32
// products per CIOS multiply) and registers (an Fe is 8 registers; a G2
// point add keeps ~20 Fe live).  Design: fe_mul as PTX mad.lo.cc /
// madc.hi.cc chains over a running sum split in two halves (below), add and
// subtract as add.cc / sub.cc chains in PTX, constants in __constant__
// memory (every thread reads the same address: a broadcast), everything
// force-inlined so each kernel is one straight-line register program.
#pragma once

#include <stdint.h>

#define ZK_FQ 0
#define ZK_FR 1

struct Fe {
  uint32_t v[8];
};

struct Fe2 {
  Fe c0, c1;
};

// p for Fq (0) and Fr (1), 32-bit little-endian limbs
static __constant__ uint32_t ZK_P[2][8] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
};
// n' = -p^{-1} mod 2^32
static __constant__ uint32_t ZK_NP[2] = {0xe4866389u, 0xefffffffu};
// R mod p, the Montgomery form of 1
static __constant__ uint32_t ZK_ONE[2][8] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, 0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
};
// 3 * b' for G2 (b' = 3 / xi), Montgomery form over Fq: (c0, c1)
static __constant__ uint32_t ZK_B3_G2[2][8] = {
    {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u, 0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u},
    {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u, 0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au},
};

// ---------------------------------------------------------------------------
// load / store: limb k of element i at base[k * limb_stride + i * elem_stride]
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe fe_load(const int32_t* base, int64_t limb_stride,
                                      int64_t elem_stride, int64_t i) {
  Fe r;
  const int32_t* p = base + i * elem_stride;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint32_t lo = (uint32_t)p[(2 * j) * limb_stride];
    uint32_t hi = (uint32_t)p[(2 * j + 1) * limb_stride];
    r.v[j] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* base, int64_t limb_stride,
                                         int64_t elem_stride, int64_t i,
                                         const Fe& a) {
  int32_t* p = base + i * elem_stride;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    p[(2 * j) * limb_stride] = (int32_t)(a.v[j] & 0xffffu);
    p[(2 * j + 1) * limb_stride] = (int32_t)(a.v[j] >> 16);
  }
}

// One contiguous element (16 int32 limbs = 64 bytes, 16-byte aligned) as four
// 16-byte vectors: a warp's four loads cover 32 neighbouring elements, 2 KB,
// every byte of which is used, where each load of the scalar path above
// touches 32 separate 32-byte sectors for 4 bytes of each.
__device__ __forceinline__ Fe fe_load_vec(const int32_t* elem) {
  const int4* p = reinterpret_cast<const int4*>(elem);
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const int4 q = __ldg(p + j);
    r.v[2 * j] = (uint32_t)q.x | ((uint32_t)q.y << 16);
    r.v[2 * j + 1] = (uint32_t)q.z | ((uint32_t)q.w << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store_vec(int32_t* elem, const Fe& a) {
  int4* p = reinterpret_cast<int4*>(elem);
#pragma unroll
  for (int j = 0; j < 4; j++) {
    p[j] = make_int4((int)(a.v[2 * j] & 0xffffu), (int)(a.v[2 * j] >> 16),
                     (int)(a.v[2 * j + 1] & 0xffffu), (int)(a.v[2 * j + 1] >> 16));
  }
}

__device__ __forceinline__ Fe fe_const(const uint32_t (&c)[8]) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = c[j];
  return r;
}

// ---------------------------------------------------------------------------
// modular add / sub (canonical in, canonical out)
// ---------------------------------------------------------------------------

// 8-word add and subtract as ONE hardware carry chain each (add.cc / addc.cc,
// sub.cc / subc.cc: 8 dependent instructions), where 64-bit C arithmetic
// compiles to two or three instructions a word and holds more registers (the
// G1 add needs 108 with the chains and 158 without).  Every kernel's linear
// operations are these.  Both update r in place, so a register is read only
// by the instruction that overwrites it, whatever registers the compiler
// shares among the operands.
// r += b mod 2^256; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add8(Fe& r, const Fe& b) {
  uint32_t carry;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "=r"(carry)
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]),
        "r"(b.v[6]), "r"(b.v[7]));
  return carry;
}

// r -= b mod 2^256; returns the borrow out (0, or 0xffffffff where r < b)
__device__ __forceinline__ uint32_t sub8(Fe& r, const Fe& b) {
  uint32_t borrow;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "=r"(borrow)
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]),
        "r"(b.v[6]), "r"(b.v[7]));
  return borrow;
}

// r = a - p if a >= p (a < 2^256 given with an extra carry bit `hi`)
template <int F>
__device__ __forceinline__ Fe fe_reduce_once(const Fe& a, uint32_t hi) {
  Fe d = a;
  const uint32_t borrow = sub8(d, fe_const(ZK_P[F]));
  // a + hi*2^256 >= p  <=>  hi set or no borrow
  return (hi || !borrow) ? d : a;
}

template <int F>
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s = a;
  const uint32_t carry = add8(s, b);
  return fe_reduce_once<F>(s, carry);
}

template <int F>
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d = a;
  if (sub8(d, b)) add8(d, fe_const(ZK_P[F]));      // a < b: a - b + p
  return d;
}

template <int F>
__device__ __forceinline__ Fe fe_dbl(const Fe& a) {
  return fe_add<F>(a, a);
}

// ---------------------------------------------------------------------------
// Montgomery multiply: CIOS, 8 x 32-bit words, R = 2^256, in PTX carry chains
// ---------------------------------------------------------------------------
//
// Replaces: zklaim_tpu/ff/pallas_field.py:mont_mul (no pallas_call of its
// own: every Pallas kernel inlines it).  The form is sppark's mont_t
// product for moduli with spare bits.
//
// The running sum t of CIOS is held in two halves of eight words: e takes
// the products a[j] b[i] of the even words of a (lo at word j, hi at word
// j + 1), o those of the odd words, one word up.  So the lo and hi of every
// product land in neighbouring words of one half, and the products of a
// round are two carry chains of mad.lo.cc / madc.hi.cc pairs that share no
// register: 4 + 4 multiply-add pairs, each chain as deep as four products,
// where one chain over the whole sum is as deep as eight.  After a round's
// reduction word 0 of t is 0 and t moves down a word.  That move is a change
// of roles: the half that was one word up is aligned now and the other one
// word down (its word k at word k - 1, word 0 spent), so the rounds call the
// same two functions with e and o swapped, and the next round's first chain
// moves the down half back up while it adds.
//
// No-carry form.  Both moduli have top word 0x30644e72 < 2^31 - 1, so p <
// 2^255.  At the start of a round t < 2p, and t + a b[i] + m p < 2p + 2 p
// (2^32 - 1) = 2^33 p < 2^288: a round's sum fits in nine words (e, and o one
// word up), the chains that end at word 8 carry out 0, and no tenth word is
// kept.  At the end t < 2p < 2^256; one conditional subtraction gives the
// canonical abR^-1 mod p, limb for limb the JAX package's SOS/REDC.
// tests/test_torch_field_cios.py runs these asm blocks, parsed from this
// file, on Python integers against that product and checks that every
// carry this code drops is 0.

// One round's products a b_i, added into the split sum: e is aligned and o
// one word down (o[k] at word k - 1; o[0] is spent).  Chain 1: e[0] += o[1],
// then o[k] = o[k + 2] + (a[k + 1] b_i)[lo or hi] for k = 0 .. 7 (o[8], o[9]
// read as 0): o is one word up again, holding the odd products; its carry
// out of word 8 is 0.  Chain 2: e[j], e[j + 1] += a[j] b_i for the even j,
// its carry into o[7].
__device__ __forceinline__ void cios_mul_round(uint32_t (&e)[8], uint32_t (&o)[8], const Fe& a,
                                               uint32_t bi) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "madc.lo.cc.u32 %8, %17, %24, %10;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %11;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %12;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %13;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %14;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %15;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, 0;\n\t"
      "madc.hi.u32 %15, %23, %24, 0;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]),
        "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(bi));
}

// The first round: t = a b_0, nothing to add it to
__device__ __forceinline__ void cios_first_round(uint32_t (&e)[8], uint32_t (&o)[8], const Fe& a,
                                                 uint32_t b0) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    e[j] = a.v[j] * b0;
    e[j + 1] = __umulhi(a.v[j], b0);
    o[j] = a.v[j + 1] * b0;
    o[j + 1] = __umulhi(a.v[j + 1], b0);
  }
}

// A round's reduction, t += m p with m = e[0] n' mod 2^32, e aligned and o
// one word up: chain 3 adds the odd words of p into o (its carry out of word
// 8 is 0), chain 4 the even words into e, carrying into o[7].  Afterwards
// e[0] = 0: the caller's next round takes o as the aligned half.
template <int F>
__device__ __forceinline__ void cios_redc_round(uint32_t (&e)[8], uint32_t (&o)[8]) {
  const uint32_t m = e[0] * ZK_NP[F];
  asm("mad.lo.cc.u32 %8, %17, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %12;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, %14;\n\t"
      "madc.hi.u32 %15, %23, %24, %15;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7]),
        "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(ZK_P[F][0]), "r"(ZK_P[F][1]), "r"(ZK_P[F][2]), "r"(ZK_P[F][3]), "r"(ZK_P[F][4]), "r"(ZK_P[F][5]), "r"(ZK_P[F][6]), "r"(ZK_P[F][7]), "r"(m));
}

template <int F>
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t e[8], o[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    if (i == 0) {
      cios_first_round(e, o, a, b.v[0]);
    } else {
      cios_mul_round(e, o, a, b.v[i]);
    }
    cios_redc_round<F>(e, o);
    cios_mul_round(o, e, a, b.v[i + 1]);
    cios_redc_round<F>(o, e);
  }
  // e is aligned and o one word down: t = e + (o >> 32), below 2p
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]), "+r"(e[7])
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = e[j];
  return fe_reduce_once<F>(r, 0);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe2 fe2_add(const Fe2& a, const Fe2& b) {
  return {fe_add<ZK_FQ>(a.c0, b.c0), fe_add<ZK_FQ>(a.c1, b.c1)};
}

__device__ __forceinline__ Fe2 fe2_sub(const Fe2& a, const Fe2& b) {
  return {fe_sub<ZK_FQ>(a.c0, b.c0), fe_sub<ZK_FQ>(a.c1, b.c1)};
}

__device__ __forceinline__ Fe2 fe2_dbl(const Fe2& a) { return fe2_add(a, a); }

// Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// c0 = t0 - t1, c1 = t2 - t0 - t1
__device__ __forceinline__ Fe2 fe2_mul(const Fe2& a, const Fe2& b) {
  Fe t0 = fe_mul<ZK_FQ>(a.c0, b.c0);
  Fe t1 = fe_mul<ZK_FQ>(a.c1, b.c1);
  Fe t2 = fe_mul<ZK_FQ>(fe_add<ZK_FQ>(a.c0, a.c1), fe_add<ZK_FQ>(b.c0, b.c1));
  return {fe_sub<ZK_FQ>(t0, t1), fe_sub<ZK_FQ>(fe_sub<ZK_FQ>(t2, t0), t1)};
}

// ---------------------------------------------------------------------------
// The two curve fields behind one interface (deg 1: G1 over Fq, deg 2: G2
// over Fq2); mul_b3 multiplies by 3b of the curve (G1: b = 3, so 9x by
// the addition chain 2(2(2x)) + x; G2: the Fq2 constant ZK_B3_G2).
// ---------------------------------------------------------------------------

template <int DEG>
struct CurveField;

template <>
struct CurveField<1> {
  typedef Fe T;
  static __device__ __forceinline__ T add(const T& a, const T& b) { return fe_add<ZK_FQ>(a, b); }
  static __device__ __forceinline__ T sub(const T& a, const T& b) { return fe_sub<ZK_FQ>(a, b); }
  static __device__ __forceinline__ T dbl(const T& a) { return fe_dbl<ZK_FQ>(a); }
  static __device__ __forceinline__ T mul(const T& a, const T& b) { return fe_mul<ZK_FQ>(a, b); }
  static __device__ __forceinline__ T mul_b3(const T& x) {
    T d = dbl(dbl(dbl(x)));
    return add(d, x);
  }
  static __device__ __forceinline__ T load(const int32_t* base, int64_t plane_stride,
                                           int64_t limb_stride, int coord, int64_t i) {
    return fe_load(base + coord * plane_stride, limb_stride, 1, i);
  }
  static __device__ __forceinline__ void store(int32_t* base, int64_t plane_stride,
                                               int64_t limb_stride, int coord, int64_t i,
                                               const T& a) {
    fe_store(base + coord * plane_stride, limb_stride, 1, i, a);
  }
};

template <>
struct CurveField<2> {
  typedef Fe2 T;
  static __device__ __forceinline__ T add(const T& a, const T& b) { return fe2_add(a, b); }
  static __device__ __forceinline__ T sub(const T& a, const T& b) { return fe2_sub(a, b); }
  static __device__ __forceinline__ T dbl(const T& a) { return fe2_dbl(a); }
  static __device__ __forceinline__ T mul(const T& a, const T& b) { return fe2_mul(a, b); }
  static __device__ __forceinline__ T mul_b3(const T& x) {
    Fe2 b3 = {fe_const(ZK_B3_G2[0]), fe_const(ZK_B3_G2[1])};
    return fe2_mul(x, b3);
  }
  // planes (x0, x1, y0, y1, z0, z1): coordinate `coord` is planes 2c, 2c+1
  static __device__ __forceinline__ T load(const int32_t* base, int64_t plane_stride,
                                           int64_t limb_stride, int coord, int64_t i) {
    return {fe_load(base + (2 * coord) * plane_stride, limb_stride, 1, i),
            fe_load(base + (2 * coord + 1) * plane_stride, limb_stride, 1, i)};
  }
  static __device__ __forceinline__ void store(int32_t* base, int64_t plane_stride,
                                               int64_t limb_stride, int coord, int64_t i,
                                               const T& a) {
    fe_store(base + (2 * coord) * plane_stride, limb_stride, 1, i, a.c0);
    fe_store(base + (2 * coord + 1) * plane_stride, limb_stride, 1, i, a.c1);
  }
};

// ---------------------------------------------------------------------------
// Fq2 over a PAIR of threads (lanes 2i and 2i + 1 of a warp): the thread
// with h = threadIdx.x & 1 holds component h of every value, so a G2 add
// keeps eight registers a value where CurveField<2> keeps sixteen.  Sums are
// component-wise and stay in the thread; a product fetches the partner's
// components with __shfl_xor_sync and each thread takes two of the
// schoolbook's four Fq products: c0 = a0 b0 - a1 b1 (h = 0), c1 = a0 b1 +
// a1 b0 (h = 1).  Every Fq operation returns the canonical residue, so the
// components are those of fe2_mul's Karatsuba limb for limb.  Both threads
// of every pair must be present (no early exit): the shuffles name the
// whole warp.
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe fe_partner(const Fe& a) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = __shfl_xor_sync(0xffffffffu, a.v[j], 1);
  return r;
}

// c ? a : b word by word: a value, so neither operand needs an address (a
// conditional on the two Fe lvalues puts both in local memory)
__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.v[j] = c ? a.v[j] : b.v[j];
  return r;
}

struct Fq2Pair {
  typedef Fe T;
  static __device__ __forceinline__ T add(const T& a, const T& b) { return fe_add<ZK_FQ>(a, b); }
  static __device__ __forceinline__ T sub(const T& a, const T& b) { return fe_sub<ZK_FQ>(a, b); }
  static __device__ __forceinline__ T dbl(const T& a) { return fe_dbl<ZK_FQ>(a); }
  // a_h b_h' products of the component pair, given the partner's a_o, b_o
  static __device__ __forceinline__ T mul_parts(const T& a, const T& ao, const T& b,
                                                const T& bo) {
    const bool h = threadIdx.x & 1;
    const Fe p = fe_mul<ZK_FQ>(fe_select(h, ao, a), b);      // a0 b0 | a0 b1
    const Fe q = fe_mul<ZK_FQ>(fe_select(h, a, ao), bo);     // a1 b1 | a1 b0
    return h ? fe_add<ZK_FQ>(p, q) : fe_sub<ZK_FQ>(p, q);
  }
  static __device__ __forceinline__ T mul(const T& a, const T& b) {
    return mul_parts(a, fe_partner(a), b, fe_partner(b));
  }
  static __device__ __forceinline__ T mul_b3(const T& x) {
    const int h = threadIdx.x & 1;
    return mul_parts(x, fe_partner(x), fe_const(ZK_B3_G2[h]), fe_const(ZK_B3_G2[h ^ 1]));
  }
};
