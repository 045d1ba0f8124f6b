// The front end of a Pippenger pass: the signed digits with the sort's keys
// and gather index (msm_digits), and the signed, bit-reversed gather of the
// sorted lanes into the planes of level 0 (msm_gather).  Between them the
// pass sorts the keys stably (torch.sort); after them come msm_upsweep,
// msm_tails and msm_abel (curve.cu).
//
// Replaces: no Pallas kernel.  The JAX package left this work to XLA
// (zklaim_tpu/msm/pippenger.py:signed_digits and _window_partials: the
// digit loop, the [P | -P | inf] table, jnp.take of the bit-reversed sorted
// index).  The port first ran it as eager PyTorch calls, about 1,240 of
// them a G1 pass of 2^21 lanes (7 small ops a window and sum for the digits,
// neg_mod's word loops, the table's torch.cat, the key and index
// expressions, a pageable upload of the bit-reversal index, index_select of
// 2^21 rows and a strided transpose of the rows into planes), whose host
// time held the card idle for most of a proof.  Here that is two launches
// and no host round trip.
//
// Layout: a pass's flat batch has L = k W n lanes, lane (i W + w) n + j the
// window w of scalar j of sum i (W = 256 / c windows, k sums of n points);
// scalars are (n, 16) plain-domain limbs, points (n, 48 deg) packed
// projective rows (x, y, z, deg Fq elements each, 16 int32 limbs an
// element), one table a sum, reached through a by-value table of base
// pointers in the launch's parameters.
//
// msm_digits: one thread a scalar walks its W windows LSB first with the
// carry in a register, as pippenger.signed_digits does (digits in
// [-2^(c-1), 2^(c-1)], the last carry absorbed by the top window), and
// writes for every lane the sort key w' (B + 1) + |d| (w' = i W + w,
// B = 2^(c-1)) and the pre-resolved gather index: 2 k n for a zero digit,
// i n + j for a positive one, k n + i n + j for a negative one; int32 both
// (the largest key, k W (B + 1), is 16,512 at k = 4, c = 8).  Writes are
// coalesced along j.  c is a template parameter (1, 2, 4, 8, 16), so the
// limb loop unrolls and the limbs stay in registers.
// What bounds it: bytes -- k n 64 bytes read, 8 bytes a lane written (G1
// k = 4, c = 8: 4 MiB and 16 MiB, about 6 us at 3.35 TB/s).
//
// msm_gather: lane q of level 0 is sorted lane s = rev_nb(q) (the upsweep
// pairs contiguous halves: bit-reversed storage), computed in the kernel;
// it reads v = idx[perm[s]] and writes, in planes (3 deg, 16, 2^nb), the
// infinity row for v = 2 k n, row v mod (k n) of its sum otherwise, with y
// negated (p - y mod 2^256 limb by limb, 0 for y = 0: ff.montgomery.neg_mod)
// where v >= k n.  A CTA takes GATHER_LANES consecutive lanes: it reads
// their rows as 16-byte vectors into shared memory (a row padded to an odd
// number of words, so the transposed reads below hit 32 banks), negates the
// y of the negative lanes there, and writes each plane row's GATHER_LANES
// words coalesced along the lane axis.
// What bounds it: bytes.  Each of the k n rows is read once from device
// memory (a pass's table, 12.6 MB G1, stays in the 50 MB L2 for its W
// reads) and every lane's 48 deg words written once, with the sorted index
// (perm 8 bytes and idx 4 a lane): a G1 pass of 2^21 lanes 0.131 ms at
// 3.35 TB/s, 0.240 ms if every lane's row came from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

#define FRONT_MAX_SUMS 64
#define DIGITS_THREADS 256
#define GATHER_LANES 64
#define GATHER_THREADS 256

struct SumTable {
  const int32_t* base[FRONT_MAX_SUMS];
};

template <int C>
__global__ void __launch_bounds__(DIGITS_THREADS)
msm_digits_kernel(SumTable scalars, int64_t n, int64_t kn, int32_t* __restrict__ keys,
                  int32_t* __restrict__ idx) {
  constexpr int PER = 16 / C;
  constexpr int W = 16 * PER;
  constexpr uint32_t MASK = (1u << C) - 1u;
  constexpr int32_t HALF = 1 << (C - 1);
  const int64_t t = (int64_t)blockIdx.x * DIGITS_THREADS + threadIdx.x;
  if (t >= kn) return;
  const int64_t i = t / n;
  const int64_t j = t - i * n;
  const int4* src = reinterpret_cast<const int4*>(scalars.base[i] + j * 16);
  uint32_t limb[16];
#pragma unroll
  for (int v = 0; v < 4; v++) {
    const int4 x = __ldg(src + v);
    limb[4 * v] = (uint32_t)x.x;
    limb[4 * v + 1] = (uint32_t)x.y;
    limb[4 * v + 2] = (uint32_t)x.z;
    limb[4 * v + 3] = (uint32_t)x.w;
  }
  int32_t carry = 0;
#pragma unroll
  for (int l = 0; l < 16; l++) {
#pragma unroll
    for (int s = 0; s < PER; s++) {
      int32_t d = (int32_t)((limb[l] >> (C * s)) & MASK) + carry;
      carry = d > HALF;
      if (carry) d -= 1 << C;
      const int32_t mag = d < 0 ? -d : d;
      const int64_t win = i * W + l * PER + s;
      const int64_t lane = win * n + j;
      keys[lane] = (int32_t)(win * (HALF + 1) + mag);
      idx[lane] = (int32_t)(mag == 0 ? 2 * kn : t + (d < 0 ? kn : 0));
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(GATHER_THREADS)
msm_gather_kernel(SumTable rows, int64_t n, int64_t kn, const int32_t* __restrict__ idx,
                  const int64_t* __restrict__ perm, int nb, const int32_t* __restrict__ inf,
                  int32_t* __restrict__ out) {
  constexpr int WORDS = 48 * DEG;        // int32 words a packed row
  constexpr int VECS = WORDS / 4;        // 16-byte vectors a row
  constexpr int STRIDE = WORDS + 1;      // odd: a lane-major read of one word hits 32 banks
  __shared__ int32_t tile[GATHER_LANES * STRIDE];
  __shared__ const int32_t* src[GATHER_LANES];
  __shared__ int32_t neg[GATHER_LANES];
  const int64_t total = (int64_t)1 << nb;
  const int64_t q0 = (int64_t)blockIdx.x * GATHER_LANES;
  const int lanes = (int)(total - q0 < GATHER_LANES ? total - q0 : GATHER_LANES);
  const int tid = threadIdx.x;

  if (tid < lanes) {
    const uint64_t q = (uint64_t)(q0 + tid);
    const uint64_t s = nb ? __brevll(q) >> (64 - nb) : 0;
    int64_t v = idx[perm[s]];
    const int32_t* row = inf;
    int32_t negative = 0;
    if (v < 2 * kn) {
      if (v >= kn) {
        v -= kn;
        negative = 1;
      }
      const int64_t i = v / n;
      row = rows.base[i] + (v - i * n) * WORDS;
    }
    src[tid] = row;
    neg[tid] = negative;
  }
  __syncthreads();

  for (int e = tid; e < lanes * VECS; e += GATHER_THREADS) {
    const int l = e / VECS;
    const int v = e - l * VECS;
    const int4 x = __ldg(reinterpret_cast<const int4*>(src[l]) + v);
    int32_t* d = tile + l * STRIDE + 4 * v;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
  __syncthreads();

  // y -> p - y (mod 2^256) on the negative lanes, one Fq component a thread
  for (int e = tid; e < lanes * DEG; e += GATHER_THREADS) {
    const int l = e / DEG;
    if (!neg[l]) continue;
    int32_t* y = tile + l * STRIDE + 16 * DEG + 16 * (e - l * DEG);
    int32_t any = 0;
#pragma unroll
    for (int b = 0; b < 16; b++) any |= y[b];
    if (!any) continue;
    int32_t borrow = 0;
#pragma unroll
    for (int b = 0; b < 16; b++) {
      const int32_t p = (int32_t)((ZK_P[ZK_FQ][b >> 1] >> (16 * (b & 1))) & 0xffffu);
      const int32_t t = p - y[b] - borrow;
      y[b] = t & 0xffff;
      borrow = (t >> 31) & 1;
    }
  }
  __syncthreads();

  for (int e = tid; e < WORDS * GATHER_LANES; e += GATHER_THREADS) {
    const int r = e / GATHER_LANES;
    const int l = e - r * GATHER_LANES;
    if (l < lanes) out[(int64_t)r * total + q0 + l] = tile[l * STRIDE + r];
  }
}

static int sum_table(const long long* ptrs, int k, SumTable* t) {
  if (!ptrs || k < 1 || k > FRONT_MAX_SUMS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < FRONT_MAX_SUMS; i++) {
    t->base[i] = i < k ? (const int32_t*)ptrs[i] : nullptr;
    if (i < k && !t->base[i]) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// scalars: k base pointers of (n, 16) int32 tables in host memory; keys and
// idx: k (256 / c) n int32 each.
extern "C" int zk_msm_digits(const long long* scalars, int k, long long n, int c, void* keys,
                             void* idx, void* stream) {
  SumTable t;
  const int err = sum_table(scalars, k, &t);
  if (err) return err;
  if (n < 1 || !keys || !idx) return (int)cudaErrorInvalidValue;
  const long long kn = (long long)k * n;
  const unsigned blocks = (unsigned)((kn + DIGITS_THREADS - 1) / DIGITS_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* kp = (int32_t*)keys;
  int32_t* ip = (int32_t*)idx;
  switch (c) {
    case 1: msm_digits_kernel<1><<<blocks, DIGITS_THREADS, 0, s>>>(t, n, kn, kp, ip); break;
    case 2: msm_digits_kernel<2><<<blocks, DIGITS_THREADS, 0, s>>>(t, n, kn, kp, ip); break;
    case 4: msm_digits_kernel<4><<<blocks, DIGITS_THREADS, 0, s>>>(t, n, kn, kp, ip); break;
    case 8: msm_digits_kernel<8><<<blocks, DIGITS_THREADS, 0, s>>>(t, n, kn, kp, ip); break;
    case 16: msm_digits_kernel<16><<<blocks, DIGITS_THREADS, 0, s>>>(t, n, kn, kp, ip); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rows: k base pointers of (n, 48 deg) int32 tables in host memory; idx
// (int32) and perm (int64): 2^nb each; inf: one packed row; out: (3 deg,
// 16, 2^nb) planes.
extern "C" int zk_msm_gather(int deg, const long long* rows, int k, long long n, const void* idx,
                             const void* perm, int nb, const void* inf, void* out,
                             void* stream) {
  SumTable t;
  const int err = sum_table(rows, k, &t);
  if (err) return err;
  if ((deg != 1 && deg != 2) || n < 1 || nb < 0 || nb > 31 || !idx || !perm || !inf || !out) {
    return (int)cudaErrorInvalidValue;
  }
  const long long kn = (long long)k * n;
  const unsigned blocks = (unsigned)((((long long)1 << nb) + GATHER_LANES - 1) / GATHER_LANES);
  cudaStream_t s = (cudaStream_t)stream;
  if (deg == 1) {
    msm_gather_kernel<1><<<blocks, GATHER_THREADS, 0, s>>>(
        t, n, kn, (const int32_t*)idx, (const int64_t*)perm, nb, (const int32_t*)inf,
        (int32_t*)out);
  } else {
    msm_gather_kernel<2><<<blocks, GATHER_THREADS, 0, s>>>(
        t, n, kn, (const int32_t*)idx, (const int64_t*)perm, nb, (const int32_t*)inf,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
