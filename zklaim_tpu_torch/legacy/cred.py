"""Object-oriented credential model (abandoned in the reference).

Equivalent of zklaim/other/zklaim_cred.hpp (SURVEY.md §2.2): a typed
credential wrapper carrying issuer/subject/type/validity metadata around
attribute payloads, with a "test" credential subtype holding employeeID
and employeeLevel preimages (zklaim_cred.hpp:40-110).  Here the model is
a thin dataclass layer over the active claims API so the metadata rides
along with real payloads/proofs instead of dead-ending.

A copy of zklaim_tpu/legacy/cred.py on the port's claims.api: Context
(and so the default_factory of Credential.context) means the card unless
it is given a device, as Context(device="cpu");
tests/test_torch_hostcopies.py holds the two to each other.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..claims.api import Context, Payload

ZKLAIM_CRED_TEST = 1


@dataclass
class Credential:
    """ZKLAIM_credential equivalent (zklaim_cred.hpp:40-56)."""

    issuer: int
    subject: int
    cred_type: int
    size: int = 0
    not_after: int = 0
    not_before: int = 0
    issued_at: int = 0
    context: Context = field(default_factory=Context)

    def describe(self) -> str:
        """ZKLAIM_credential::print equivalent."""
        return (
            f"Issuer: {self.issuer}\nSubject: {self.subject}\n"
            f"Type: {self.cred_type}\nSize: {self.size}\n"
            f"Not_After: {self.not_after}\nNot_Before: {self.not_before}\n"
            f"Issued_At: {self.issued_at}"
        )

    def is_valid_at(self, ts: int) -> bool:
        return self.not_before <= ts and (self.not_after == 0 or ts <= self.not_after)


@dataclass
class TestCredential(Credential):
    """ZKLAIM_test_credential: employeeID + employeeLevel attributes
    (zklaim_cred.hpp:82-110) stored as payload preimage slots 0 and 1."""

    __test__ = False  # not a pytest class despite the Test* name

    employee_id: int = 0
    employee_level: int = 0

    def __post_init__(self):
        self.cred_type = ZKLAIM_CRED_TEST
        pl = Payload()
        pl.set_attr(self.employee_id, 0)
        pl.set_attr(self.employee_level, 1)
        self.context.add_payload(pl)

    def describe(self) -> str:
        return (
            super().describe()
            + f"\nEmployeeID: {self.employee_id}\nEmployeeLevel: {self.employee_level}"
        )
