"""The credential main paths, end to end: issuer setup -> holder proofs ->
verifier checks.

run_credential_path(device, num_payloads, requests, seed) is the three-role
flow of `cli demo` through claims.api.Context -- keys, proofs and contexts
cross between the roles as bytes (claims.serde and the context wire
format) -- with a timer around each role, `requests` holders with different
attributes and predicates, and every way the flow must fail, each by its
status code and never by an exception.

run_main_path(device, num_payloads, requests, seed) drives groth16.api
directly, below the credential layer: it builds the predicate
circuit (ZKlaimCircuit(num_payloads), or the small credential-shaped
`tiny_circuit` with tiny=True), runs the trusted setup once, then for each
request builds a payload the way claims.api.Payload does (set_attr per
slot, an 8-byte salt at pre[40:48], SHA256 of the 48-byte preimage, the
ops' byte positions), proves and verifies.  It also checks the two ways a
request must fail: a predicate the attributes do not satisfy makes
`prove` raise ValueError, and a proof checked against a wrong public
input does not verify.  All randomness comes from random.Random(seed).

run_multichip(mesh, device, ...) is the counterpart of the JAX package's
dryrun_multichip (__graft_entry__.py): the sharded MSM over a 1-D mesh and
over the 2-D (host, chip) mesh, a four-step NTT round trip, and a batched
prove over the mesh whose proofs must verify, each checked, at sizes the
caller picks (default: the dryrun's tiny shapes).

All run on the card unless the caller passes a device (the tests pass
"cpu").
"""

from __future__ import annotations

import hashlib
import random
import time

import numpy as np
import torch

from . import kernels as K
from . import resolve_device
from .claims.circuit import (
    OP_EQ, OP_GREATER, OP_GREATER_EQ, OP_LESS, OP_LESS_EQ, OP_NOOP, OP_NOT_EQ,
    ZKlaimCircuit, public_inputs_for,
)
from .ec import curve as C
from .ec.hostcurve import g1_generator
from .ff import montgomery as M
from .ff.params import R
from .gadgets.compare import comparison
from .groth16.api import prove, setup, verify
from .parallel.mesh import make_host_mesh, make_mesh
from .parallel.msm import sharded_msm
from .parallel.ntt import ShardedNTT
from .parallel.prove import batched_prove
from .r1cs.system import ONE, ConstraintSystem
from .utils.profiling import sync as _sync

_U64 = 1 << 64


def _tiny_system():
    """A small credential-shaped circuit (comparisons + packing, no SHA):
    4 public bounds, 4 private attributes, attr_i <= bound_i enforced."""
    cs = ConstraintSystem()
    pub = [cs.alloc_lc() for _ in range(4)]
    cs.mark_primary_end()
    attrs = [cs.alloc_lc() for _ in range(4)]
    for i, (p, a) in enumerate(zip(pub, attrs)):
        less, le = comparison(cs, 64, a, p, f"cmp{i}")
        cs.enforce_equal(le, ONE, f"le{i}")

    def witness(bounds, values):
        def init(w):
            for lc, v in zip(pub + attrs, list(bounds) + list(values)):
                w[next(iter(lc.terms))] = v
        return cs.generate_witness(init)

    return cs, witness


def tiny_circuit():
    """(cs, witness) of the small circuit with bounds 100+i, attributes 10+i
    -- the same system and witness as the JAX package's __graft_entry__."""
    cs, witness = _tiny_system()
    return cs, witness([100 + i for i in range(4)], [10 + i for i in range(4)])


class _TinyWorkload:
    def __init__(self):
        self.cs, self._witness = _tiny_system()

    def request(self, rng, satisfied: bool):
        bounds = [rng.randrange(50, 1 << 40) for _ in range(4)]
        values = [rng.randrange(0, b + 1) for b in bounds]
        if not satisfied:
            values[0] = bounds[0] + 1
        return self._witness(bounds, values), bounds


_OPS = (OP_LESS, OP_LESS_EQ, OP_EQ, OP_GREATER_EQ, OP_GREATER, OP_NOT_EQ, OP_NOOP)


def _reference_for(rng, attr: int, op: int) -> int:
    """A public reference value that makes `attr op ref` true."""
    delta = rng.randrange(1, 1 << 20)
    if op in (OP_LESS, OP_NOT_EQ):
        return attr + delta
    if op == OP_LESS_EQ:
        return attr + delta - 1
    if op == OP_EQ:
        return attr
    if op == OP_GREATER_EQ:
        return attr - delta + 1
    if op == OP_GREATER:
        return attr - delta
    return rng.randrange(_U64)                # NOOP: anything


class _CredentialWorkload:
    def __init__(self, num_payloads: int):
        self.circuit = ZKlaimCircuit(num_payloads)
        self.cs = self.circuit.cs
        self.num_payloads = num_payloads

    def _payload(self, rng, satisfied: bool):
        attrs = [rng.randrange(1 << 20, 1 << 40) for _ in range(5)]
        ops = [rng.choice(_OPS) for _ in range(5)]
        refs = [_reference_for(rng, a, op) for a, op in zip(attrs, ops)]
        if not satisfied:
            ops[0], refs[0] = OP_LESS, attrs[0]          # attr < attr is false
        pre = bytearray(48)
        for pos, a in enumerate(attrs):                   # Payload.set_attr
            pre[pos * 8 : pos * 8 + 8] = a.to_bytes(8, "little")
        pre[40:48] = rng.randrange(_U64).to_bytes(8, "little")   # hash_payload
        pre = bytes(pre)
        return pre, hashlib.sha256(pre).digest(), refs, ops

    def request(self, rng, satisfied: bool):
        payloads = [self._payload(rng, satisfied) for _ in range(self.num_payloads)]
        witness = self.circuit.witness([(pre, refs, ops) for pre, _, refs, ops in payloads])
        primary = public_inputs_for([(h, refs, ops) for _, h, refs, ops in payloads])
        return witness, primary


def run_main_path(device=None, num_payloads: int = 1, requests: int = 3, seed: int = 0,
                  tiny: bool = False) -> dict:
    """Setup once, then `requests` proofs, each verified; plus one
    unsatisfied request and one wrong-public-input verification."""
    device = resolve_device(device)
    rng = random.Random(seed)
    t0 = time.perf_counter()
    work = _TinyWorkload() if tiny else _CredentialWorkload(num_payloads)
    circuit_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pk, vk, qap = setup(work.cs, rng, device)
    _sync(device)
    out = {
        "device": str(device),
        "circuit": "tiny" if tiny else f"ZKlaimCircuit({num_payloads})",
        "num_vars": qap.num_vars,
        "num_constraints": qap.n_cons,
        "m": qap.m,
        "circuit_s": circuit_s,
        "setup_s": time.perf_counter() - t0,
        "prove_s": [],
        "verify_s": [],
        "verified": [],
    }
    proof = primary = None
    for _ in range(requests):
        witness, primary = work.request(rng, satisfied=True)
        t0 = time.perf_counter()
        proof = prove(pk, qap, witness, rng)
        _sync(device)
        out["prove_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["verified"].append(verify(vk, primary, proof))
        out["verify_s"].append(time.perf_counter() - t0)

    witness, _ = work.request(rng, satisfied=False)
    try:
        prove(pk, qap, witness, rng)
        out["unsatisfied_rejected"] = False
    except ValueError:
        out["unsatisfied_rejected"] = True
    if proof is not None:
        wrong = [(primary[0] + 1) % (1 << 253)] + list(primary[1:])
        out["wrong_input_rejected"] = not verify(vk, wrong, proof)
    return out


# ---------------------------------------------------------------------------
# The credential path through claims.api.Context
# ---------------------------------------------------------------------------


def _claim(rng, attrs):
    """(data_ref, data_op) of a predicate set the attributes satisfy."""
    from .claims.api import OP_TO_POSITION

    zk_op = {pos: op for op, pos in OP_TO_POSITION.items()}
    ops = [rng.choice(_OPS) for _ in attrs]
    refs = [_reference_for(rng, a, op) for a, op in zip(attrs, ops)]
    return refs, [zk_op[op] for op in ops]


def _launches_since(before: dict) -> dict:
    """Kernel launches since the snapshot `before` (all 0 on the CPU)."""
    return {k: v - before[k] for k, v in K.LAUNCHES.items()}


def _off_curve_pk(pk_bytes: bytes) -> bytes:
    """pk bytes with the first point of the A table moved off the curve
    (y + 1, still canonical: the range check passes, the curve check fails)."""
    o = 20 + 3 * 64 + 2 * 128 + 32
    y = int.from_bytes(pk_bytes[o : o + 32], "big")
    return pk_bytes[:o] + (y + 1).to_bytes(32, "big") + pk_bytes[o + 32 :]


def run_credential_path(device=None, num_payloads: int = 1, requests: int = 3,
                        seed: int = 0) -> dict:
    """Issuer -> `requests` holders -> verifier through claims.api.Context,
    then the failures.  Returns times, byte sizes, the proving key's
    dimensions (num_vars, num_primary, m) and every status code; the caller
    asserts them (`statuses_ok` says whether all are as expected).  The
    failures that tamper with a payload take payload 0 and, past one
    payload, the last one too (keys ending in `_last`)."""
    import copy

    from .claims import serde, signing
    from .utils import native
    from .claims.api import (
        ZKLAIM_ERROR, ZKLAIM_INVALID_PROOF, ZKLAIM_INVALID_SIGNATURE, ZKLAIM_OK,
        Context, Payload, ZkOp,
    )

    device = resolve_device(device)
    rng = random.Random(seed)
    out = {"device": str(device), "num_payloads": num_payloads,
           "signing": "native" if native.available() else "python"}   # same bytes either way
    status = {}

    # ===== issuer: one trusted setup, one signed credential per holder =====
    t0 = time.perf_counter()
    priv = signing.keygen(rng)
    attrs, wires = [], []
    pk_bytes = vk_bytes = b""
    for i in range(requests):
        ctx = Context(device)
        mine = []
        for _ in range(num_payloads):
            pl = Payload()
            values = [rng.randrange(1 << 20, 1 << 40) for _ in range(5)]
            for pos, a in enumerate(values):
                pl.set_attr(a, pos)
            pl.data_ref, pl.data_op = _claim(rng, values)
            ctx.add_payload(pl)
            mine.append(values)
        ctx.hash_payloads(rng)
        if i == 0:
            t1, before = time.perf_counter(), dict(K.LAUNCHES)
            status["trusted_setup"] = ctx.trusted_setup(rng)
            _sync(device)
            out["trusted_setup_s"] = time.perf_counter() - t1
            out["trusted_setup_launches"] = _launches_since(before)
            pk_bytes, vk_bytes = ctx.pk, ctx.vk
        else:
            ctx.vk = vk_bytes                    # one setup per circuit, not per credential
        status.setdefault("sign", []).append(ctx.sign(priv, rng))
        wires.append(ctx.serialize())
        attrs.append(mine)
    out["issuer_s"] = time.perf_counter() - t0
    out["pk_bytes"], out["vk_bytes"] = len(pk_bytes), len(vk_bytes)
    if pk_bytes:
        _, out["num_vars"], out["num_primary"], out["m"] = serde.pk_dims(pk_bytes)

    # ===== holders: a fresh context each, the pk handed over out of band =====
    out["holder_s"], out["proof_generate_s"], out["proof_generate_launches"] = [], [], []
    status["holder_deserialize"], status["pre_proof_verify"] = [], []
    status["proof_generate"] = []
    proven, holder = [], None
    for i in range(requests):
        t0 = time.perf_counter()
        holder, st = Context.deserialize(wires[i], device)
        status["holder_deserialize"].append(st)
        holder.pk = pk_bytes
        status["pre_proof_verify"].append(holder.verify())
        for pl, values in zip(holder.payloads, attrs[i]):      # tailor the claim
            pl.data_ref, pl.data_op = _claim(rng, values)
        t1, before = time.perf_counter(), dict(K.LAUNCHES)
        status["proof_generate"].append(holder.proof_generate(rng))
        _sync(device)
        out["proof_generate_s"].append(time.perf_counter() - t1)
        out["proof_generate_launches"].append(_launches_since(before))
        if i == requests - 1:
            # the same holder proves a second claim: its context has the
            # imported pk, so this is the prover alone
            keep = copy.deepcopy(holder)
            for pl, values in zip(keep.payloads, attrs[i]):
                pl.data_ref, pl.data_op = _claim(rng, values)
            t1, before = time.perf_counter(), dict(K.LAUNCHES)
            status["reprove"] = keep.proof_generate(rng)
            _sync(device)
            out["reprove_s"] = time.perf_counter() - t1
            out["reprove_launches"] = _launches_since(before)
        holder.clear_pres()
        proven.append(holder.serialize())
        out["holder_s"].append(time.perf_counter() - t0)
    out["proof_bytes"] = len(holder.proof) if holder is not None else 0

    t0, before = time.perf_counter(), dict(K.LAUNCHES)
    serde.pk_from_bytes(pk_bytes, device)
    _sync(device)
    out["pk_import_s"] = time.perf_counter() - t0
    out["pk_import_launches"] = _launches_since(before)

    # ===== verifier =====
    out["verifier_s"] = []
    status["verifier_deserialize"], status["verify"] = [], []
    for wire in proven:
        t0 = time.perf_counter()
        ctx, st = Context.deserialize(wire, device)
        status["verifier_deserialize"].append(st)
        status["verify"].append(ctx.verify())
        out["verifier_s"].append(time.perf_counter() - t0)

    # ===== the ways it must fail =====
    expect = {
        "trusted_setup": ZKLAIM_OK, "sign": [ZKLAIM_OK] * requests,
        "holder_deserialize": [ZKLAIM_OK] * requests,
        "pre_proof_verify": [ZKLAIM_INVALID_PROOF] * requests,
        "proof_generate": [ZKLAIM_OK] * requests,
        "verifier_deserialize": [ZKLAIM_OK] * requests, "verify": [ZKLAIM_OK] * requests,
    }
    if requests:
        expect["reprove"] = ZKLAIM_OK
        flipped = bytearray(proven[-1])
        flipped[-100] ^= 1                                # inside the proof's C point
        ctx, _ = Context.deserialize(bytes(flipped), device)
        status["flipped_proof_byte"] = ctx.verify()
        expect["flipped_proof_byte"] = ZKLAIM_INVALID_PROOF

        bad = Context.deserialize(wires[0], device)[0]
        bad.pk = _off_curve_pk(pk_bytes)
        status["off_curve_pk"] = bad.proof_generate(rng)
        expect["off_curve_pk"] = ZKLAIM_ERROR

        extra = Context.deserialize(wires[0], device)[0]
        extra.pk = pk_bytes
        extra.add_payload(Payload())
        status["payload_count_mismatch"] = extra.proof_generate(rng)
        expect["payload_count_mismatch"] = ZKLAIM_ERROR
    tampered = {}                          # key suffix -> the payload tampered with
    if requests and num_payloads:
        tampered = {"": 0, "_last": num_payloads - 1} if num_payloads > 1 else {"": 0}
    for tag, at in tampered.items():
        ctx, _ = Context.deserialize(proven[-1], device)
        ctx.payloads[at].data_ref[0] ^= 1                 # the proof binds the references
        status["tampered_reference" + tag] = ctx.verify()
        expect["tampered_reference" + tag] = ZKLAIM_INVALID_PROOF
        ctx.payloads[at].hash_payload(rng)                # rehash: the signed view changes
        status["tampered_reference_rehashed" + tag] = ctx.verify()
        expect["tampered_reference_rehashed" + tag] = ZKLAIM_INVALID_SIGNATURE

        unsat = copy.deepcopy(keep)                       # the last holder, preimages intact
        pl = unsat.payloads[at]
        pl.data_ref[0] = int.from_bytes(pl.pre[:8], "little")
        pl.data_op[0] = ZkOp.LESS                         # attr < attr is false
        status["unsatisfied_predicate" + tag] = unsat.proof_generate(rng)
        expect["unsatisfied_predicate" + tag] = ZKLAIM_ERROR

    out["status"], out["expected"] = status, expect
    out["statuses_ok"] = status == expect
    return out



def multiple_rows(n: int, device):
    """(rows, k): n G1 points (i mod 2^14 + 1) G as packed rows, built on the
    host by repeated addition and tiled past 2^14, and their multipliers k
    (min(n, 2^14) ints) -- the points of bench.make_points, whose sums the
    host checks cheaply: sum_i s_i P_i = (sum_i s_i k_(i mod 2^14)) G."""
    g = g1_generator()
    pts, p = [], g
    for _ in range(min(n, 1 << 14)):
        pts.append(p)
        p = p + g
    f = C.ops_for(1)
    rows = C.planes_to_rows(C.point_to_planes(f, C.host_points_to_proj(f, pts, device)))
    reps = -(-n // len(pts))
    return rows.repeat(reps, 1)[:n].contiguous(), list(range(1, len(pts) + 1))


def multiple_rows_sum(k: list, scalars: torch.Tensor):
    """The host's sum_i s_i P_i over the points of multiple_rows with
    multipliers k: (sum_i s_i k_(i mod len k)) G, a host point."""
    raw = scalars.cpu().numpy().astype("<u2").tobytes()
    coeff = sum(int.from_bytes(raw[32 * i : 32 * i + 32], "little") * k[i % len(k)]
                for i in range(scalars.shape[0]))
    return g1_generator() * (coeff % R)


def random_scalars(n: int, rng: np.random.Generator, device) -> torch.Tensor:
    """(n, 16) plain Fr limbs below r, drawn in bulk from a numpy Generator."""
    v = rng.integers(0, 1 << 16, size=(n, 16))
    v[:, 15] = rng.integers(0, 0x3064, size=n)          # r's top limb is 0x3064
    return torch.from_numpy(v.astype(np.int32)).to(device)


def run_multichip(mesh=None, device=None, n_points: int | None = None, ntt_n: int | None = None,
                  circuit=None, msm_c: int = 4, seed: int = 20260817) -> dict:
    """One multi-device step at the given sizes, each part checked:

      - sharded_msm of n_points G1 points (default max(16, 4 S)) over the
        1-D mesh and over the 2-D (host, chip) mesh: both equal the host's
        sum (the points are multiples of G, multiple_rows), not infinity;
      - ShardedNTT of ntt_n (default max(64, S^2)): intt_t(ntt_t(x)) = x;
      - batched_prove over the mesh of S copies of the circuit's witness --
        circuit: (cs, witness) or (cs, witness, public inputs), default the
        tiny credential-shaped circuit -- each proof verified on the host.

    mesh: the 1-D mesh (default: make_mesh() on `device`).  Returns the
    results and each part's seconds (host clock, after a synchronise).
    Raises AssertionError if a check fails."""
    if mesh is None:
        mesh = make_mesh(device=resolve_device(device))
    device = mesh.device
    shards = mesh.size
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    out = {"shards": shards, "seconds": {}}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        out["seconds"][name] = time.perf_counter() - t0
        return res

    n = n_points or max(16, 4 * shards)
    rows, k = multiple_rows(n, device)
    scalars = random_scalars(n, nrng, device)
    want = multiple_rows_sum(k, scalars)
    hmesh = make_host_mesh(device=device)
    flat = timed("sharded_msm_1d", lambda: sharded_msm(mesh, 1, rows, scalars, msm_c))
    grid = timed("sharded_msm_2d", lambda: sharded_msm(hmesh, 1, rows, scalars, msm_c,
                                                        axis=("host", "chip")))
    out["msm_1d"], out["msm_2d"] = (C.planes_to_host_points(1, p)[0] for p in (flat, grid))
    out["host_mesh"] = hmesh.devices.shape
    if out["msm_1d"] != want or out["msm_2d"] != want or want.inf:
        raise AssertionError("sharded MSM differs from the host's sum")

    m = ntt_n or max(64, shards * shards)
    x = M.to_mont(M.FR, random_scalars(m, nrng, device))
    plan = timed("sharded_ntt_plan", lambda: ShardedNTT(mesh, m))
    z = timed("sharded_ntt_t", lambda: plan.ntt_t(plan.to_matrix(x)))
    back = timed("sharded_intt_t", lambda: plan.intt_t(z))
    if not bool((back.reshape(m, 16) == x).all()):
        raise AssertionError("intt_t(ntt_t(x)) != x")

    cs, witness, *primary = circuit if circuit is not None else tiny_circuit()
    primary = primary[0] if primary else list(witness[1 : cs.num_primary + 1])
    pk, vk, qap = timed("setup", lambda: setup(cs, rng, device))
    proofs = timed("batched_prove", lambda: batched_prove(
        mesh, pk, qap, [witness] * shards, rng, msm_c=msm_c))
    out["verified"] = [verify(vk, primary, p) for p in proofs]
    if not out["verified"] or not all(out["verified"]):
        raise AssertionError(f"a proof of batched_prove did not verify: {out['verified']}")
    out["proofs"] = proofs
    return out
