"""Command-line demo + benchmark for the PyTorch/CUDA port.

`python -m zklaim_tpu_torch.cli demo [--seed N] [--device cpu]` -- the
three-role issuer/prover/verifier walkthrough, the equivalent of the
reference's src/main example (reference zklaim/main.c:40-256).

`python -m zklaim_tpu_torch.cli bench` -- payload-count sweep emitting the
reference benchmark's CSV schema
`timestamp,num_payloads,issuer_ms,prover_ms,verifier_ms,pk_B,vk_B,proof_B`
(reference zklaim/main_benchmark.c:150-164).

Counterpart of zklaim_tpu/cli.py.  Both commands run on the card unless
`--device cpu` is given; without a CUDA device and without that flag they
raise.
"""

from __future__ import annotations

import argparse
import random
import sys
import time


def _ctx_describe(ctx) -> str:
    """zklaim_print equivalent (reference zklaim.c:155-190)."""
    lines = [f"context: {ctx.num_payloads} payload(s), vk={len(ctx.vk)}B, "
             f"proof={len(ctx.proof)}B, pk={len(ctx.pk)}B"]
    for i, pl in enumerate(ctx.payloads):
        lines.append(f"  payload {i}: priv={pl.priv} salt="
                     f"{'<hidden>' if pl.priv else hex(pl.salt)} "
                     f"hash={pl.hash.hex()[:16]}…")
        for k in range(5):
            pre_val = ("<blinded>" if pl.priv else
                       int.from_bytes(pl.pre[8 * k : 8 * k + 8], "little"))
            lines.append(f"    attr{k}: value={pre_val} op={pl.data_op[k]!r} "
                         f"ref={pl.data_ref[k]}")
    return "\n".join(lines)


def demo(seed=None, verbose=True, device=None):
    """Issuer -> prover -> verifier round trip; returns final status (0 = OK)."""
    from .claims import signing
    from .claims.api import (
        Context,
        Payload,
        ZKLAIM_INVALID_PROOF,
        ZKLAIM_OK,
        ZkOp,
    )

    rng = random.Random(seed) if seed is not None else random.SystemRandom()
    log = print if verbose else (lambda *a, **k: None)

    # ===== ISSUER (main.c:40-150) =====
    log("========== ISSUER ==========")
    t0 = time.perf_counter()
    priv = signing.keygen(rng)
    ctx = Context(device)
    pl = Payload()
    # credential: age=23, flags 1/2/3, score=599
    for pos, attr in enumerate([23, 1, 2, 3, 599]):
        pl.set_attr(attr, pos)
    pl.data_ref = [18, 1, 2, 3, 600]
    pl.data_op = [ZkOp.GREATER_OR_EQ, ZkOp.EQ, ZkOp.EQ, ZkOp.EQ, ZkOp.LESS]
    ctx.add_payload(pl)
    ctx.hash_payloads(rng)
    log("[ISSUER] trusted setup…")
    assert ctx.trusted_setup(rng) == ZKLAIM_OK
    assert ctx.sign(priv, rng) == ZKLAIM_OK
    wire_issuer = ctx.serialize()
    log(f"[ISSUER] done in {time.perf_counter()-t0:.1f}s; "
        f"ctx={len(wire_issuer)}B pk={len(ctx.pk)}B vk={len(ctx.vk)}B")

    # ===== PROVER (main.c:170-225) =====
    log("========== PROVER ==========")
    t0 = time.perf_counter()
    ctx_prover, status = Context.deserialize(wire_issuer, device)
    assert status == ZKLAIM_OK
    # pk ships out-of-band (main.c:189-191)
    ctx_prover.pk = ctx.pk
    # before proving, verify: signature passes, proof absent -> INVALID_PROOF
    res = ctx_prover.verify()
    log(f"[PROVER] pre-proof verify: {res} (3 == ZKLAIM_INVALID_PROOF expected)")
    assert res == ZKLAIM_INVALID_PROOF
    # tailor the claim: prove only age >= 20 (main.c:194-208)
    p = ctx_prover.payloads[0]
    p.data_ref = [20, 0, 0, 0, 0]
    p.data_op = [ZkOp.GREATER_OR_EQ] + [ZkOp.NOOP] * 4
    log("[PROVER] generating proof…")
    assert ctx_prover.proof_generate(rng) == ZKLAIM_OK
    ctx_prover.clear_pres()          # blind before sending on
    wire_prover = ctx_prover.serialize()
    log(f"[PROVER] done in {time.perf_counter()-t0:.1f}s; "
        f"proof={len(ctx_prover.proof)}B")
    log(_ctx_describe(ctx_prover))

    # ===== VERIFIER (main.c:228-245) =====
    log("========== VERIFIER ==========")
    t0 = time.perf_counter()
    ctx_verifier, status = Context.deserialize(wire_prover, device)
    assert status == ZKLAIM_OK
    res = ctx_verifier.verify()
    log(f"[VERIFIER] result: {res} ({'OK' if res == ZKLAIM_OK else 'FAILED'}) "
        f"in {time.perf_counter()-t0:.1f}s")
    return res


def bench(max_payloads=3, runs=1, out=sys.stdout, seed=1, device=None):
    """Reference main_benchmark.c sweep; CSV to `out`."""
    from .claims import signing
    from .claims.api import Context, Payload, ZKLAIM_OK, ZkOp

    rng = random.Random(seed)
    priv = signing.keygen(rng)
    print("timestamp,num_payloads,issuer_ms,prover_ms,verifier_ms,pk_B,vk_B,proof_B",
          file=out)
    for n in range(1, max_payloads + 1):
        for _ in range(runs):
            ctx = Context(device)
            for _i in range(n):
                pl = Payload()
                pl.set_attr(23, 0)
                pl.data_ref = [18, 0, 0, 0, 0]
                pl.data_op = [ZkOp.GREATER_OR_EQ] + [ZkOp.NOOP] * 4
                ctx.add_payload(pl)
            ctx.hash_payloads(rng)
            t0 = time.perf_counter()
            assert ctx.trusted_setup(rng) == ZKLAIM_OK
            issuer_ms = (time.perf_counter() - t0) * 1e3
            ctx.sign(priv, rng)
            t0 = time.perf_counter()
            assert ctx.proof_generate(rng) == ZKLAIM_OK
            prover_ms = (time.perf_counter() - t0) * 1e3
            ctx.clear_pres()
            t0 = time.perf_counter()
            assert ctx.verify() == ZKLAIM_OK
            verifier_ms = (time.perf_counter() - t0) * 1e3
            print(f"{int(time.time())},{n},{issuer_ms:.1f},{prover_ms:.1f},"
                  f"{verifier_ms:.1f},{len(ctx.pk)},{len(ctx.vk)},{len(ctx.proof)}",
                  file=out)
            out.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zklaim_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("demo", help="issuer/prover/verifier walkthrough")
    d.add_argument("--seed", type=int, default=None)
    d.add_argument("--device", default=None, help="torch device (default: the card)")
    b = sub.add_parser("bench", help="payload sweep, reference CSV schema")
    b.add_argument("--max-payloads", type=int, default=3)
    b.add_argument("--runs", type=int, default=1)
    b.add_argument("--out", default=None,
                   help="CSV file (default stdout); rows stream as they finish")
    b.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.cmd == "demo":
        return demo(seed=args.seed, device=args.device)
    if args.out:
        with open(args.out, "w") as fh:
            bench(max_payloads=args.max_payloads, runs=args.runs, out=fh, device=args.device)
    else:
        bench(max_payloads=args.max_payloads, runs=args.runs, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
