"""verify: a fresh verifier context deserialises the wire bytes and
verifies them (the issuer's signature, then the proof)."""

OK = 0


def run(roles, rec: dict) -> None:
    with roles.span("deserialize"):
        verifier, status = roles.Context.deserialize(rec["wire"], roles.device)
    if status == OK:
        with roles.span("verify"):
            status = verifier.verify()
    rec["statuses"]["verify"] = status
