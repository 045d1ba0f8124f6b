"""fresh_holder: the cold holder of the reference's demo (zklaim/main.c),
a new holder context for every request.  It is deserialised from the
issuer's wire bytes of the request's credential (main.c:176), handed the
issuer's pk bytes out of band (main.c:189-191) and the request's claim
(main.c:194-208), and proves once: `proof_generate` imports the pk, builds
the circuit, its QAP and its witness program, then proves, as
libsnark_wrapper.cpp:218-232 does on every proof.  The step span
`proof_generate` ends in a synchronise.  The context becomes
roles.holder, which steps/present.py and steps/verify.py read; the
previous request's context is dropped before the new one imports.

The issuer's wire bytes of every credential of the pool (payloads with
their preimages and salts, the vk, the issuer's key and signature) are
made at the step's first call, a warm-up request, so in set-up.

A fault of the control runs (harness.inject) replaces the proof_generate
of the holder of the moment; each request puts the same fault into its
new context.

Traced (roles.spans is not None), the request runs under the program's
recorder (utils.profiling.recording), and the step span with the
program's spans inside it goes into roles.spans as disjoint segments, each
named by the innermost span open over it (program_spans.flatten), so that
tracing.record charges each idle gap of the card to the cold holder's
stage (claims.circuit, claims.pk_import, serde.pk_decode, ...).  Untraced,
the step is the user's path alone.
"""

import time
import types

from zkbench import harness, program_spans

OK = 0


def issuer_wires(roles) -> list:
    """The issuer's wire bytes of each credential of the pool, made once."""
    wires = vars(roles).get("issuer_wires")
    if wires is None:
        wires = roles.issuer_wires = []
        for cred in roles.pool:
            issuer = roles.Context(roles.device)
            for pre, salt, digest in zip(cred["pre"], cred["salt"], cred["hash"]):
                issuer.add_payload(roles.Payload(salt=salt, hash=digest, pre=pre))
            issuer.vk, issuer.pub_key = roles.issuer["vk"], roles.issuer["pub_key"]
            issuer.signature = cred["signature"]
            wires.append(issuer.serialize())
    return wires


def _prove(roles, rec: dict, wire: bytes, fault) -> int:
    holder, status = roles.Context.deserialize(wire, roles.device)
    if status != OK:
        raise RuntimeError(f"the issuer's wire bytes do not deserialise: status {status}")
    roles.holder = holder
    holder.pk = roles.issuer["pk"]
    for pl, (refs, ops) in zip(holder.payloads, rec["claim"]):
        pl.data_ref, pl.data_op = list(refs), list(ops)
    if fault is not None:
        harness.inject(fault, types.SimpleNamespace(holder=holder))
    status = holder.proof_generate(roles.gen.rng(f"{rec['stream']}.prove", rec["index"]))
    roles.sync()
    return status


def run(roles, rec: dict) -> None:
    wire = issuer_wires(roles)[rec["credential"]]
    fault = getattr(vars(roles.holder).get("proof_generate"), "__name__", None)
    roles.holder = None                     # the last context's tables go before this import
    if roles.spans is None:
        rec["statuses"]["prove"] = _prove(roles, rec, wire, fault)
    else:
        from zklaim_tpu_torch.utils.profiling import recording

        t0 = time.time_ns()
        with recording() as program:
            rec["statuses"]["prove"] = _prove(roles, rec, wire, fault)
        step = (t0, time.time_ns(), "proof_generate")
        roles.spans.extend(program_spans.flatten([step] + program.spans))
    rec["proof"] = roles.holder.proof
