"""SHA256 Merkle tree with the reference's exact (unusual) pairing order.

Equivalent of zklaim/other/merkle.{h,c} (SURVEY.md §2.2).  The reference
splits the pre-hashed leaves into a `left` half and a `right` half and at
EVERY level pairs left[i] with right[i] -- i.e. leaf i is hashed with
leaf i + n/2, not with its neighbor (other/merkle.c:71-145).  The root
hash of the "Hello World" x8 tree is pinned by the reference fixture
zklaim/tests/hashes/hello_world_size_8 (vendored at
tests/fixtures/hello_world_size_8); test parity per
other/tests/merkle_test.cpp:30-41.

Copied verbatim from zklaim_tpu/legacy/merkle.py (host code, no device
work); tests/test_torch_hostcopies.py holds the two to each other.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field

DIGEST_SIZE = 32


@dataclass
class MerkleNode:
    val: bytes
    level: int
    left: "MerkleNode | None" = None
    right: "MerkleNode | None" = None


@dataclass
class MerkleRoot:
    root_hash: bytes
    size: int                    # depth in levels (log2 of leaf count)
    left: MerkleNode | None = None
    right: MerkleNode | None = None


def _h2(a: bytes, b: bytes) -> bytes:
    return hashlib.sha256(a + b).digest()


def build_tree(digests: list[bytes]) -> MerkleRoot | None:
    """Build the tree over pre-hashed 32-byte leaves.

    Returns None when the leaf count is odd (reference rejects it,
    other/merkle.c:72-76); leaf counts that are even but not powers of
    two follow the reference's halving loop semantics.
    """
    num = len(digests)
    if num % 2 != 0 or num == 0:
        return None
    size = int(math.log2(num))
    left = [MerkleNode(bytes(d), size) for d in digests[: num // 2]]
    right = [MerkleNode(bytes(d), size) for d in digests[num // 2 :]]
    num //= 2
    lvl = size - 1
    while num != 1:
        new_left = [
            MerkleNode(_h2(left[i].val, right[i].val), lvl, left[i], right[i])
            for i in range(num // 2)
        ]
        new_right = [
            MerkleNode(
                _h2(left[num // 2 + i].val, right[num // 2 + i].val),
                lvl,
                left[num // 2 + i],
                right[num // 2 + i],
            )
            for i in range(num // 2)
        ]
        left, right = new_left, new_right
        num //= 2
        lvl -= 1
    return MerkleRoot(_h2(left[0].val, right[0].val), size, left[0], right[0])


def leaf_hashes(preimages: list[bytes]) -> list[bytes]:
    """Callers hash application data before building (merkle_test.cpp:23-26)."""
    return [hashlib.sha256(p).digest() for p in preimages]


def format_tree(mr: MerkleRoot) -> str:
    """Human-readable dump (print_tree equivalent, in-order traversal)."""
    lines = [
        "==== Merkle Tree Root ====",
        f"Tree Size: {mr.size}",
        f"Root Hash: {mr.root_hash.hex()}",
        "==========================",
    ]

    def walk(n):
        if n is None:
            return
        walk(n.left)
        lines.append(f"level {n.level}: {n.val.hex()}")
        walk(n.right)

    walk(mr.left)
    walk(mr.right)
    return "\n".join(lines)
