"""BN254 (ALT_BN128) curve and field parameters.

TPU-native re-design of the algebra layer that the reference delegates to
libff/libsnark (reference: the reference's CMakeLists.txt:11-17 selects
CURVE_ALT_BN128; zklaim/libsnark_wrapper.cpp:20 fixes ppT to the default
r1cs_ppzksnark_pp which is alt_bn128).

All derived constants (Montgomery parameters, roots of unity, Frobenius
coefficients) are *computed* here from the primary definitions rather than
transcribed, to avoid silent transcription errors.

Device-side representation: 16 x 16-bit limbs held in uint32 ("limb" layout),
little-endian limb order, Montgomery domain with R = 2**256.  See
zklaim_tpu/ff/limbs.py.

Copy of zklaim_tpu/ff/params.py kept inside this package, which imports nothing
of the JAX package: the code is identical, and the relative imports
resolve to this package's own copies.
"""

# ---------------------------------------------------------------------------
# Primary definitions (BN254 / alt_bn128)
# ---------------------------------------------------------------------------

# BN parameter x ("t" in BN notation)
BN_X = 4965661367192848881

# Base field modulus q = 36x^4 + 36x^3 + 24x^2 + 6x + 1
Q = 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1
# Scalar field modulus r = 36x^4 + 36x^3 + 18x^2 + 6x + 1
R = 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1

assert Q == 21888242871839275222246405745257275088696311157297823662689037894645226208583
assert R == 21888242871839275222246405745257275088548364400416034343698204186575808495617

# trace of Frobenius: t = 6x^2 + 1;  #E(Fq) = q + 1 - t = r
TRACE = 6 * BN_X**2 + 1
assert Q + 1 - TRACE == R

# ate pairing loop count: |6x + 2|
ATE_LOOP_COUNT = 6 * BN_X + 2

# G1: y^2 = x^3 + 3 over Fq
G1_B = 3
G1_GEN = (1, 2)

# Fq2 = Fq[u] / (u^2 + 1)   (non-residue -1)
FQ2_NON_RESIDUE = Q - 1
# Fq6 = Fq2[v] / (v^3 - xi), Fq12 = Fq6[w] / (w^2 - v), xi = 9 + u
XI = (9, 1)  # xi as (c0, c1) over Fq

# G2: y^2 = x^3 + b/xi over Fq2 (D-type twist), generator from libff alt_bn128
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# ---------------------------------------------------------------------------
# Scalar-field (Fr) FFT domain constants
# ---------------------------------------------------------------------------

# r - 1 = 2^TWO_ADICITY * odd
TWO_ADICITY = 28
assert (R - 1) % (1 << TWO_ADICITY) == 0 and ((R - 1) >> TWO_ADICITY) % 2 == 1

# smallest multiplicative generator of Fr*
FR_GENERATOR = 5
assert pow(FR_GENERATOR, (R - 1) // 2, R) != 1  # not a square -> generator check (5 is standard)

# primitive 2^28-th root of unity in Fr
ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> TWO_ADICITY, R)

# ---------------------------------------------------------------------------
# Limb / Montgomery layout (device representation)
# ---------------------------------------------------------------------------

LIMB_BITS = 16
NUM_LIMBS = 16                     # 16 x 16 = 256 bits
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_BITS = LIMB_BITS * NUM_LIMBS  # 256
MONT_R = 1 << MONT_BITS


def _mont_constants(p: int):
    """Montgomery constants for modulus p with R = 2^256, base 2^16 limbs."""
    r_mod = MONT_R % p
    r2 = (MONT_R * MONT_R) % p
    # p' = -p^{-1} mod 2^16 (per-limb CIOS constant)
    pinv16 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    return r_mod, r2, pinv16


Q_R_MOD, Q_R2, Q_PINV16 = _mont_constants(Q)
R_R_MOD, R_R2, R_PINV16 = _mont_constants(R)

# field capacity in bits (libff FieldT::capacity() = num_bits - 1 = 253 for Fr)
FR_NUM_BITS = R.bit_length()       # 254
FR_CAPACITY = FR_NUM_BITS - 1      # 253; bit-packing chunk size for public inputs
