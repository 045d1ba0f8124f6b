"""prove: the holder's `proof_generate`, ending in a synchronise; its status
and its proof bytes."""


def run(roles, rec: dict) -> None:
    with roles.span("proof_generate"):
        rng = roles.gen.rng(f"{rec['stream']}.prove", rec["index"])
        rec["statuses"]["prove"] = roles.holder.proof_generate(rng)
        roles.sync()
    rec["proof"] = roles.holder.proof
