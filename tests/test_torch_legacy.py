"""The port's legacy package (zklaim_tpu_torch.legacy), the cases of
tests/test_legacy.py: Lamport OTS, the Merkle tree (golden root vs the
reference fixture), secp256k1 ECDSA with DER/PEM/SEC1 handling, the OO
credential model on the port's claims.api.Context (on the CPU: the default
Context means the card), and the PoC circuit on the port's R1CS builder
and gadgets, whose constraint system also matches the JAX package's."""

import hashlib
import os
import random

import pytest

from zklaim_tpu_torch.claims.api import Context
from zklaim_tpu_torch.legacy import ecdsa_secp256k1 as E
from zklaim_tpu_torch.legacy import lamport, merkle
from zklaim_tpu_torch.legacy.cred import TestCredential, ZKLAIM_CRED_TEST

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


# -- Lamport LD-OTS (other/tests/lamport_test.cpp semantics) ------------------


def test_lamport_roundtrip(rng):
    priv, pub = lamport.create_private_key(rng)
    msg = hashlib.sha256(b"hello zklaim").digest()
    sig = lamport.sign(msg, priv)
    assert lamport.verify(msg, pub, sig)


def test_lamport_rejects_wrong_message(rng):
    priv, pub = lamport.create_private_key(rng)
    msg = hashlib.sha256(b"msg A").digest()
    sig = lamport.sign(msg, priv)
    other = hashlib.sha256(b"msg B").digest()
    assert not lamport.verify(other, pub, sig)


def test_lamport_rejects_tampered_sig(rng):
    priv, pub = lamport.create_private_key(rng)
    msg = hashlib.sha256(b"msg").digest()
    sig = bytearray(lamport.sign(msg, priv))
    sig[0] ^= 1
    assert not lamport.verify(msg, pub, bytes(sig))


def test_lamport_key_sizes(rng):
    priv, pub = lamport.create_private_key(rng)
    assert len(priv) == lamport.KEY_SIZE == 16384
    assert len(pub) == lamport.KEY_SIZE
    msg = bytes(32)
    assert len(lamport.sign(msg, priv)) == lamport.SIG_SIZE == 8192


# -- Merkle tree (golden root, other/tests/merkle_test.cpp:30-41) -------------


def test_merkle_hello_world_size_8_golden():
    leaves = merkle.leaf_hashes([b"Hello World"] * 8)
    root = merkle.build_tree(leaves)
    golden = open(f"{FIX}/hello_world_size_8", "rb").read()
    assert root.root_hash == golden
    assert root.size == 3


def test_merkle_rejects_odd_leaf_count():
    assert merkle.build_tree([bytes(32)] * 3) is None
    assert merkle.build_tree([]) is None


def test_merkle_two_leaves():
    a, b = hashlib.sha256(b"a").digest(), hashlib.sha256(b"b").digest()
    root = merkle.build_tree([a, b])
    assert root.root_hash == hashlib.sha256(a + b).digest()
    assert root.size == 1


def test_merkle_reference_pairing_order():
    # leaf i pairs with leaf i + n/2 at every level (other/merkle.c:71-145)
    leaves = [hashlib.sha256(bytes([i])).digest() for i in range(4)]
    root = merkle.build_tree(leaves)
    h = lambda x, y: hashlib.sha256(x + y).digest()
    expected = h(h(leaves[0], leaves[2]), h(leaves[1], leaves[3]))
    assert root.root_hash == expected


def test_merkle_format_tree():
    root = merkle.build_tree(merkle.leaf_hashes([b"x"] * 4))
    text = merkle.format_tree(root)
    assert "Tree Size: 2" in text and root.root_hash.hex() in text


# -- secp256k1 ECDSA + DER/PEM (other/zklaim_ecc.c semantics) ------------------


def test_ecdsa_sign_verify_roundtrip(rng):
    d = E.keygen(rng)
    pub = E._mul(d, E.G)
    sig = E.ecdsa_sign(b"some payload", d, rng)
    assert E.ecdsa_verify(b"some payload", sig, pub)
    assert not E.ecdsa_verify(b"other payload", sig, pub)


def test_ecdsa_der_roundtrip(rng):
    d = E.keygen(rng)
    sig = E.ecdsa_sign(b"data", d, rng)
    der = E.sig_to_der(*sig)
    assert E.der_to_sig(der) == sig
    assert E.der_to_sig(b"\x00\x01") is None


def test_ecdsa_pem_key_files(rng, tmp_path):
    d = E.keygen(rng)
    pub = E._mul(d, E.G)
    priv_pem = tmp_path / "ec_priv.pem"
    pub_pem = tmp_path / "ec_pub.pem"
    priv_pem.write_text(E.pem_encode(E.priv_key_to_der(d), "EC PRIVATE KEY"))
    pub_pem.write_text(E.pem_encode(E.pub_key_to_der(pub), "PUBLIC KEY"))
    assert E.load_ec_priv_key(str(priv_pem)) == d
    assert E.load_ec_pub_key(str(pub_pem)) == pub


def test_ecdsa_sec1_compressed_roundtrip(rng):
    d = E.keygen(rng)
    pub = E._mul(d, E.G)
    assert E.sec1_to_point(E.point_to_sec1(pub)) == pub
    assert E.sec1_to_point(E.point_to_sec1(pub, compressed=True)) == pub


# -- OO credential model (other/zklaim_cred.hpp) -------------------------------


def test_test_credential_model():
    cred = TestCredential(
        issuer=7, subject=42, cred_type=0, not_before=100, not_after=200,
        issued_at=100, employee_id=1234, employee_level=3, context=Context(device="cpu"),
    )
    assert cred.cred_type == ZKLAIM_CRED_TEST
    assert cred.is_valid_at(150) and not cred.is_valid_at(50)
    assert "EmployeeID: 1234" in cred.describe()
    pl = cred.context.payloads[0]
    assert pl.pre[:8] == (1234).to_bytes(8, "little")
    assert pl.pre[8:16] == (3).to_bytes(8, "little")


# -- PoC circuit (other/gadget.hpp) --------------------------------------------


@pytest.fixture(scope="module")
def poc():
    from zklaim_tpu_torch.legacy.poc_circuit import PocCircuit

    return PocCircuit()


def test_poc_circuit_satisfied(poc):
    pre = poc.make_preimage(age=23, salary=60000)
    w = poc.witness(pre)
    assert poc.cs.is_satisfied(w)
    # packed primary input matches the verifier-side input map
    primary = w[1 : poc.cs.num_primary + 1]
    assert primary == poc.public_inputs(poc.hash_preimage(pre))


@pytest.mark.parametrize(
    "age,salary", [(17, 60000), (23, 50000), (23, 49999), (0, 0)]
)
def test_poc_circuit_rejects_bad_attributes(poc, age, salary):
    w = poc.witness(poc.make_preimage(age=age, salary=salary))
    assert not poc.cs.is_satisfied(w)


def test_poc_circuit_age_boundary(poc):
    # age == 18 passes (>=), salary == 50001 passes (>)
    w = poc.witness(poc.make_preimage(age=18, salary=50001))
    assert poc.cs.is_satisfied(w)


def test_poc_circuit_matches_the_jax_package(poc):
    """The same constraint counts and the same witness as the JAX package's
    PocCircuit on one preimage."""
    from zklaim_tpu.legacy.poc_circuit import PocCircuit as JaxPocCircuit

    jpoc = JaxPocCircuit()
    assert (poc.cs.num_vars, poc.cs.num_constraints, poc.cs.num_primary) == (
        jpoc.cs.num_vars, jpoc.cs.num_constraints, jpoc.cs.num_primary)
    pre = poc.make_preimage(age=30, salary=70000)
    assert list(poc.witness(pre)) == list(jpoc.witness(pre))


def test_credential_context_defaults_to_the_card():
    """Credential's default_factory is the port's Context: device None, the
    card, resolved when the context first needs a device."""
    from zklaim_tpu_torch.legacy.cred import Credential

    cred = Credential(issuer=1, subject=2, cred_type=0)
    assert isinstance(cred.context, Context) and cred.context.device is None
