"""zklaim credential framework in PyTorch with hand-written CUDA kernels.

The package imports torch, never jax, and nothing of the JAX package
(zklaim_tpu): it keeps its own copies of the host modules it needs.

Entry points (groth16.api.setup, entry.run_main_path,
entry.run_credential_path, claims.api.Context, cli) take `device=None`,
which means the card: `default_device()`.  Helpers that receive tensors
follow their tensors' device; helpers that build tensors from host data
take a required `device`.
"""

from __future__ import annotations


def default_device():
    """The first CUDA device; raises where there is none (never the CPU)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "zklaim_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return torch.device("cuda:0")


def resolve_device(device=None):
    """`device` as a torch.device; None means default_device()."""
    import torch

    return default_device() if device is None else torch.device(device)
