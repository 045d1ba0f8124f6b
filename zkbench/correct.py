"""The comparison that decides `correct`: what the timed path returned,
judged by the configuration's plain reference (reference/<name>.py).

Each number compared is a count with its own limit.  The guarantees that
the configuration files state, one number each:

- size_mismatches: pk, vk and proof bytes other than the configuration's
  sizes (`SWEEP.csv`'s);
- key_mismatches: the circuit's counts against the configuration's, and
  the pk's dimensions, the vk's points and the pk's points that differ from
  those the reference works out from the setup's randomness and its own
  build of the circuit (every IC point; a sample of the A, B, L and H rows
  drawn from the seed);
- credential_mismatches: pool credentials whose preimage does not hold the
  attributes, whose hash is not SHA256 of the preimage, or whose issuer
  signature does not verify;
- status_mismatches: requests with a status other than ZKLAIM_OK from a
  step before the verifier (`proof_generate`) although every predicate
  holds, and checked presentations whose verifier status disagrees with
  the reference's verdict;
- proofs_rejected: checked proofs that the reference's pairing check refuses
  under its own verifying key (or that do not parse);
- wire_mismatches: checked presentations that do not carry the request's
  payload hashes, references and ops, the issuer's vk, key and signature, or
  that still hold a preimage or salt;
- repeated_proofs: proofs equal to an earlier one of the window (a
  presentation re-randomises its proof, so two cannot be linked);
- proofs_checked: how many proofs the reference checked, at least one.
"""

from __future__ import annotations

import hashlib
import random
import time

LIMITS = {"size_mismatches": ("max", 0), "key_mismatches": ("max", 0),
          "credential_mismatches": ("max", 0), "status_mismatches": ("max", 0),
          "proofs_rejected": ("max", 0), "wire_mismatches": ("max", 0),
          "repeated_proofs": ("max", 0), "proofs_checked": ("min", 1)}
OK = 0


def sample(n: int, size: int, seed: int) -> list:
    """The requests the reference checks: all of them up to `size`, else
    `size` drawn from the seed, the window's last request among them."""
    if n <= size:
        return list(range(n))
    rng = random.Random(f"zkbench/{seed}/sample")
    return sorted(rng.sample(range(n - 1), size - 1) + [n - 1])


def compare(ref, config: dict, setup_seed: str, issuer: dict, pool: list, requests: list,
            checked: list, log=print) -> dict:
    """The numbers compared: name -> value.

    ref: the configuration's reference module.  issuer: pk, vk and pub_key
    bytes.  pool: per credential its attrs, pre, hash (per payload) and
    signature.  requests: per request its credential index, claim
    ((refs, ops) per payload), statuses, proof bytes and, where presented,
    the wire bytes and the verifier's status.  checked: indices of the
    requests the reference checks.  log(line) gets what differs, by name."""
    sizes = config["sizes"]
    n_pl = config["num_payloads"]
    got = {"pk_bytes": len(issuer["pk"]), "vk_bytes": len(issuer["vk"])}
    size_bad = sum(got[k] != sizes[k] for k in got)
    size_bad += sum(len(r["proof"]) != sizes["proof_bytes"] for r in requests)

    t0 = time.perf_counter()
    keys = ref.reference_keys(n_pl, random.Random(setup_seed),
                              random.Random(f"{setup_seed}/rows"))
    key_bad = ref.key_mismatches(issuer["pk"], issuer["vk"], keys)
    key_bad += [f"circuit {name}" for name, size in (
        ("constraints", "constraints"), ("num_vars", "variables"),
        ("num_primary", "primary"), ("m", "m")) if keys["dims"][name] != sizes[size]]
    if key_bad:
        log(f"key mismatches: {', '.join(key_bad)}")
    t1 = time.perf_counter()
    cred_ok = []
    for cred in pool:
        ok = ref.signature_verifies(cred["hash"], issuer["vk"], cred["signature"],
                                    issuer["pub_key"])
        for values, pre, digest in zip(cred["attrs"], cred["pre"], cred["hash"]):
            want = b"".join(int(a).to_bytes(8, "little") for a in values)
            ok = ok and pre[:40] == want and hashlib.sha256(pre).digest() == digest
        cred_ok.append(ok)

    status_bad = sum(any(status != OK for step, status in r["statuses"].items()
                         if step != "verify")
                     and ref.claim_holds(pool[r["credential"]]["attrs"], r["claim"])
                     for r in requests)
    seen, repeated = set(), 0
    for r in requests:
        repeated += r["proof"] in seen
        seen.add(r["proof"])

    wire_ok, items = {}, {}
    for i in checked:
        r = requests[i]
        cred = pool[r["credential"]]
        proof = r["proof"]
        if "wire" in r:
            try:
                pres = ref.parse_presentation(r["wire"])
            except ref.BadEncoding:
                pres = None
            wire_ok[i] = pres is not None and ref.presentation_matches(
                pres, cred, r["claim"], issuer)
            proof = pres["proof"] if pres is not None else b""
        try:
            items[i] = (ref.public_inputs([(h, refs, ops) for h, (refs, ops)
                                           in zip(cred["hash"], r["claim"])]),
                        ref.parse_proof(proof))
        except ref.BadEncoding:
            pass
    verdicts = dict(zip(items, ref.proofs_verify(keys["vk"], list(items.values()),
                                                 random.Random(f"{setup_seed}/weights"))))
    proof_ok = {i: verdicts.get(i, False) for i in checked}
    rejected = list(proof_ok.values()).count(False)
    wire_bad = list(wire_ok.values()).count(False)
    for i in checked:
        r = requests[i]
        if "verify" in r["statuses"]:
            verdict = wire_ok.get(i, True) and proof_ok[i] and cred_ok[r["credential"]]
            status_bad += (r["statuses"]["verify"] == OK) != verdict
    log(f"reference s: keys {t1 - t0:.1f}, credentials and {len(checked)} proofs "
        f"{time.perf_counter() - t1:.1f}")

    return {"size_mismatches": size_bad, "key_mismatches": len(key_bad),
            "credential_mismatches": cred_ok.count(False), "status_mismatches": status_bad,
            "proofs_rejected": rejected, "wire_mismatches": wire_bad,
            "repeated_proofs": repeated, "proofs_checked": len(checked)}


def verdict(numbers: dict) -> bool:
    """Whether every number keeps to its limit."""
    return all(numbers[name] <= limit if kind == "max" else numbers[name] >= limit
               for name, (kind, limit) in LIMITS.items())


def report(numbers: dict) -> dict:
    """{name: {"value": v, "max" or "min": limit}} for the result line."""
    return {name: {"value": numbers[name], kind: limit}
            for name, (kind, limit) in LIMITS.items()}
