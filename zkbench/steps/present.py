"""present: the holder clears the preimages and salts (`clear_pres`) and
serialises its context: the wire bytes a verifier receives."""


def run(roles, rec: dict) -> None:
    with roles.span("present"):
        roles.holder.clear_pres()
        rec["wire"] = roles.holder.serialize()
