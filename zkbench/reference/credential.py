"""Plain reference of the zklaim credential configurations: what a Groth16
presentation over ZKlaimCircuit(N) must be, worked out on Python integers
with the frozen BN254 arithmetic of ./bn254 and nothing of the program.

- `public_inputs`: the verifier's input map (zklaim_input_map): per payload
  hash(256 bits) || refs(512) || ops(512), each byte MSB first, packed LSB
  first into field elements of 253 bits.
- `reference_keys`: the keys that follow from the setup's randomness and
  the circuit (zklaim_circuit.py, built here): the setup draws tau, alpha,
  beta, gamma, delta, in that order, as `randrange(1, r)` of the rng it is
  given (the program's stated use of the rng).  The whole verifying key
  (IC_0 ... IC_k among it), the pk's single points, and the pk's A, B and L
  rows of the primary wires and of a sample of the others, and H rows.
- `parse_*`: the byte formats (proof "ZKPF", vk "ZKVK", pk "ZKPK", the
  context's wire format), each point checked on its curve and, in G2, in
  the r-order subgroup.
- `proofs_verify`: e(-A, B) e(alpha, beta) e(IC_0 + sum x_i IC_i, gamma)
  e(C, delta) == 1 for each proof, under the reference's verifying key.
  The proofs are checked together, each equation raised to a random
  weight (one Miller loop a proof, one final exponentiation); where that
  product is not one, each proof is checked alone.
"""

from __future__ import annotations

import hashlib
import struct

from . import ed25519_ecdsa, zklaim_circuit
from .bn254.hostcurve import (
    B_G2, CurvePoint, g1_generator, g1_infinity, g1_point, g2_generator, g2_infinity,
)
from .bn254.hostfield import Fq2
from .bn254.pairing import pairing_product_is_one
from .bn254.params import FR_CAPACITY, Q, R

# zklaim.h's zklaim_op values -> the op's byte in its 8-byte slot
OP_POSITION = {1: 0, 3: 1, 2: 2, 10: 3, 8: 4, 9: 5, 99: 6}

HEADER = 80
PAYLOAD = 160
SIGNATURE = 64


class BadEncoding(ValueError):
    """Bytes that are no valid encoding of what they should hold."""


# -- the verifier's input map ---------------------------------------------


def _bits_msb(data: bytes) -> list:
    return [(byte >> i) & 1 for byte in data for i in range(7, -1, -1)]


def public_inputs(payloads) -> list:
    """payloads: (hash32, 5 refs, 5 zklaim_op values) each -> field elements."""
    bits = []
    for digest, refs, ops in payloads:
        refs_buf, ops_buf = bytearray(64), bytearray(64)
        for k, (ref, op) in enumerate(zip(refs, ops)):
            refs_buf[8 * k : 8 * k + 8] = int(ref).to_bytes(8, "little")
            ops_buf[8 * k + OP_POSITION[int(op)]] = 1
        bits += _bits_msb(digest) + _bits_msb(bytes(refs_buf)) + _bits_msb(bytes(ops_buf))
    return [sum(b << j for j, b in enumerate(bits[c : c + FR_CAPACITY]))
            for c in range(0, len(bits), FR_CAPACITY)]


# -- keys from the setup's randomness and the circuit -----------------------


def reference_keys(num_payloads: int, setup_rng, rows_rng, sample: int = 8) -> dict:
    """{"dims": the pk's dimensions, "vk": the verifying key (points),
    "pk": {name: point} of the pk's single points and of its table rows
    for the primary wires, `sample` other wires and `sample` + 2 H rows
    drawn from rows_rng}."""
    cs = zklaim_circuit.circuit(num_payloads)
    tau, alpha, beta, gamma, delta = (setup_rng.randrange(1, R) for _ in range(5))
    k, n_vars, m = cs.num_primary, cs.num_vars, zklaim_circuit.domain_size(cs)
    aux = sorted(rows_rng.sample(range(k + 1, n_vars), min(sample, n_vars - k - 1)))
    at, bt, ct, z_tau = zklaim_circuit.column_evals(cs, tau, list(range(k + 1)) + aux)
    gamma_inv, delta_inv = pow(gamma, -1, R), pow(delta, -1, R)
    g1, g2 = g1_generator(), g2_generator()

    def mixed(j):
        return (beta * at[j] + alpha * bt[j] + ct[j]) % R

    pk = {"alpha_g1": g1 * alpha, "beta_g1": g1 * beta, "delta_g1": g1 * delta,
          "beta_g2": g2 * beta, "delta_g2": g2 * delta}
    for j in list(range(k + 1)) + aux:
        pk[f"a_g1[{j}]"], pk[f"b_g1[{j}]"], pk[f"b_g2[{j}]"] = g1 * at[j], g1 * bt[j], g2 * bt[j]
    for j in aux:
        pk[f"l_g1[{j - k - 1}]"] = g1 * (mixed(j) * delta_inv)
    if m >= 2:
        for i in {0, m - 2, *rows_rng.sample(range(m - 1), min(sample, m - 1))}:
            pk[f"h_g1[{i}]"] = g1 * (pow(tau, i, R) * z_tau * delta_inv)
    vk = {"alpha_g1": pk["alpha_g1"], "beta_g2": pk["beta_g2"], "gamma_g2": g2 * gamma,
          "delta_g2": pk["delta_g2"], "ic": [g1 * (mixed(i) * gamma_inv) for i in range(k + 1)]}
    dims = {"num_payloads": num_payloads, "num_vars": n_vars, "num_primary": k, "m": m,
            "constraints": len(cs.rows)}
    return {"dims": dims, "vk": vk, "pk": pk}


# -- byte formats -----------------------------------------------------------


def parse_g1(raw: bytes) -> CurvePoint:
    if len(raw) != 64:
        raise BadEncoding("G1 point length")
    if raw == bytes(64):
        return g1_infinity()
    x, y = int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big")
    if x >= Q or y >= Q:
        raise BadEncoding("G1 coordinate out of range")
    p = g1_point(x, y)
    if not p.is_on_curve():
        raise BadEncoding("G1 point not on the curve")
    return p


def parse_g2(raw: bytes) -> CurvePoint:
    if len(raw) != 128:
        raise BadEncoding("G2 point length")
    if raw == bytes(128):
        return g2_infinity()
    c = [int.from_bytes(raw[i : i + 32], "big") for i in range(0, 128, 32)]
    if any(v >= Q for v in c):
        raise BadEncoding("G2 coordinate out of range")
    p = CurvePoint(Fq2(c[0], c[1]), Fq2(c[2], c[3]), B_G2)
    if not p.is_on_curve():
        raise BadEncoding("G2 point not on the curve")
    if not p.mul_raw(R).inf:
        raise BadEncoding("G2 point outside the r-order subgroup")
    return p


def parse_proof(raw: bytes) -> tuple:
    """(A, B, C) of a 260-byte proof."""
    if len(raw) != 260 or raw[:4] != b"ZKPF":
        raise BadEncoding("proof encoding")
    return parse_g1(raw[4:68]), parse_g2(raw[68:196]), parse_g1(raw[196:260])


def parse_vk(raw: bytes) -> dict:
    if len(raw) < 8 or raw[:4] != b"ZKVK":
        raise BadEncoding("vk encoding")
    (n_ic,) = struct.unpack_from("<I", raw, 4)
    if len(raw) != 8 + 64 + 3 * 128 + 64 * n_ic:
        raise BadEncoding("vk length")
    vk = {"alpha_g1": parse_g1(raw[8:72]), "beta_g2": parse_g2(raw[72:200]),
          "gamma_g2": parse_g2(raw[200:328]), "delta_g2": parse_g2(raw[328:456])}
    vk["ic"] = [parse_g1(raw[456 + 64 * i : 520 + 64 * i]) for i in range(n_ic)]
    return vk


def parse_pk_head(raw: bytes, rows: dict) -> dict:
    """The pk's dimensions, its five single points and the table rows named
    in `rows` (table name -> row indices) of a pk's bytes."""
    if len(raw) < 20 or raw[:4] != b"ZKPK":
        raise BadEncoding("pk encoding")
    n_pl, num_vars, num_primary, m = struct.unpack_from("<IIII", raw, 4)
    out = {"num_payloads": n_pl, "num_vars": num_vars, "num_primary": num_primary, "m": m}
    o = 20
    for name, size in (("alpha_g1", 64), ("beta_g1", 64), ("delta_g1", 64),
                       ("beta_g2", 128), ("delta_g2", 128)):
        out[name] = (parse_g1 if size == 64 else parse_g2)(raw[o : o + size])
        o += size
    tables = (("a_g1", num_vars, 64), ("b_g1", num_vars, 64), ("b_g2", num_vars, 128),
              ("h_g1", m - 1, 64), ("l_g1", num_vars - num_primary - 1, 64))
    for name, count, size in tables:
        for i in rows.get(name, ()):
            at = o + size * i
            out[f"{name}[{i}]"] = (parse_g1 if size == 64 else parse_g2)(raw[at : at + size])
        o += size * count
    if o != len(raw):
        raise BadEncoding("pk length")
    return out


def parse_presentation(raw: bytes) -> dict:
    """The context wire format: header {num_payloads, vk_size, sig_size,
    proof_size as big-endian u32; pub_key[32]; SHA256(header[0:48])} ||
    payloads (160 bytes each, the x86-64 C struct) || vk || signature || proof."""
    if len(raw) < HEADER:
        raise BadEncoding("presentation shorter than its header")
    n_pl, vk_size, sig_size, proof_size = struct.unpack_from(">IIII", raw, 0)
    if hashlib.sha256(raw[:48]).digest() != raw[48:80]:
        raise BadEncoding("header digest")
    total = HEADER + n_pl * PAYLOAD + vk_size + sig_size + proof_size
    if sig_size != SIGNATURE or len(raw) != total:
        raise BadEncoding("presentation length")
    payloads, o = [], HEADER
    for _ in range(n_pl):
        pl = raw[o : o + PAYLOAD]
        payloads.append({
            "refs": [int.from_bytes(pl[8 * i : 8 * i + 8], "little") for i in range(5)],
            "ops": [int.from_bytes(pl[40 + 4 * i : 44 + 4 * i], "little") for i in range(5)],
            "salt": int.from_bytes(pl[64:72], "little"),
            "hash": pl[72:104], "priv": pl[104], "pre": pl[105:153],
        })
        o += PAYLOAD
    vk = raw[o : o + vk_size]
    o += vk_size
    return {"pub_key": raw[16:48], "payloads": payloads, "vk": vk,
            "signature": raw[o : o + SIGNATURE], "proof": raw[o + SIGNATURE :]}


# -- verification -----------------------------------------------------------


def _holds(vk: dict, items: list, rng) -> bool:
    """Whether prod_i (e(-A_i, B_i) e(alpha, beta) e(vk_x_i, gamma)
    e(C_i, delta))^(w_i) == 1 for random weights w_i; vk_x_i is IC_0 plus
    the sum of the proof's primary inputs times IC_1..IC_k."""
    weights = [rng.randrange(1, 1 << 128) for _ in items]
    ic_coeffs = [sum(weights) % R] + [
        sum(w * primary[c] for w, (primary, _) in zip(weights, items)) % R
        for c in range(len(vk["ic"]) - 1)]
    vk_x, c_sum = g1_infinity(), g1_infinity()
    for coeff, point in zip(ic_coeffs, vk["ic"]):
        vk_x = vk_x + point * coeff
    pairs = []
    for w, (_, (a, b, c)) in zip(weights, items):
        pairs.append((-(a * w), b))
        c_sum = c_sum + c * w
    pairs += [(vk["alpha_g1"] * ic_coeffs[0], vk["beta_g2"]), (vk_x, vk["gamma_g2"]),
              (c_sum, vk["delta_g2"])]
    return pairing_product_is_one(pairs)


def proofs_verify(vk: dict, items: list, rng) -> list:
    """Per item (primary inputs, (A, B, C)): whether the proof verifies."""
    ok = [len(primary) == len(vk["ic"]) - 1 for primary, _ in items]
    sound = [item for item, fits in zip(items, ok) if fits]
    if sound and _holds(vk, sound, rng):
        return ok
    return [fits and _holds(vk, [item], rng) for item, fits in zip(items, ok)]


def signature_verifies(hashes: list, vk_bytes: bytes, signature: bytes, pub_key: bytes) -> bool:
    """The issuer's signature over the signed view: payload hashes || vk."""
    return ed25519_ecdsa.verify(b"".join(hashes) + vk_bytes, signature, pub_key)


def claim_holds(attrs: list, claim: list) -> bool:
    """Whether every predicate `attr op ref` of a claim is true."""
    test = {1: lambda a, b: a < b, 3: lambda a, b: a <= b, 2: lambda a, b: a == b,
            10: lambda a, b: a >= b, 8: lambda a, b: a > b, 9: lambda a, b: a != b,
            99: lambda a, b: True}
    return all(test[int(op)](a, ref)
               for values, (refs, ops) in zip(attrs, claim)
               for a, ref, op in zip(values, refs, ops))


def presentation_matches(pres: dict, cred: dict, claim: list, issuer: dict) -> bool:
    """Whether a parsed presentation carries the credential's hashes, the
    claim's references and ops, the issuer's vk, key and the credential's
    signature, and no preimage or salt."""
    if len(pres["payloads"]) != len(claim):
        return False
    for pl, digest, (refs, ops) in zip(pres["payloads"], cred["hash"], claim):
        if (pl["hash"] != digest or pl["refs"] != [int(v) for v in refs]
                or pl["ops"] != [int(v) for v in ops]
                or pl["pre"] != bytes(48) or pl["salt"] != 0 or pl["priv"] != 1):
            return False
    return (pres["vk"] == issuer["vk"] and pres["pub_key"] == issuer["pub_key"]
            and pres["signature"] == cred["signature"])


def key_mismatches(pk_bytes: bytes, vk_bytes: bytes, keys: dict) -> list:
    """Names of the pk's dimensions, of its points and of the vk's points
    (reference_keys) that the issuer's keys do not hold."""
    rows = {}
    for name in keys["pk"]:
        if "[" in name:
            table, index = name[:-1].split("[")
            rows.setdefault(table, []).append(int(index))
    try:
        pk, vk = parse_pk_head(pk_bytes, rows), parse_vk(vk_bytes)
    except BadEncoding as e:
        return [f"keys do not parse: {e}"]
    bad = [name for name in ("num_payloads", "num_vars", "num_primary", "m")
           if pk[name] != keys["dims"][name]]
    bad += [name for name, point in keys["pk"].items() if pk[name] != point]
    want = keys["vk"]
    bad += [f"vk.{name}" for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2")
            if vk[name] != want[name]]
    if len(vk["ic"]) != len(want["ic"]):
        bad.append("vk.ic count")
    bad += [f"vk.ic[{i}]" for i, (got, point) in enumerate(zip(vk["ic"], want["ic"]))
            if got != point]
    return bad
