"""claim: the holder's payloads take the request's claim (references and ops
drawn for the credential's attributes) over the credential's hashes,
salts, preimages and signature."""


def run(roles, rec: dict) -> None:
    cred = roles.pool[rec["credential"]]
    with roles.span("claim"):
        rec["claim"] = roles.gen.claim(rec["stream"], rec["index"], cred["attrs"])
        roles.holder.payloads = [
            roles.Payload(data_ref=list(refs), data_op=list(ops), salt=salt, hash=digest,
                          pre=pre)
            for (refs, ops), salt, digest, pre
            in zip(rec["claim"], cred["salt"], cred["hash"], cred["pre"])]
        roles.holder.signature = cred["signature"]
