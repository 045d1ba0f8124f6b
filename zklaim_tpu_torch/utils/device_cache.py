"""Constants made on the card once, then read from any CUDA stream.

A few tables are made at first use and kept for the process: the NTT
domain's twiddles (ntt.radix2.get_domain), the packed finish and tails
schedules and the infinity row of the MSM kernels (ec.gpu_curve), 1 in
Montgomery form (ec.curve) and the fixed-base tables (msm.fixedbase).
Each is made on the current stream of whichever thread asks first, then
handed to every later caller, which may read it on another stream: several
holders can prove at once, each on its own thread and stream.
`device_constant` caches such a function and synchronises the making
stream before the value enters the cache, a wait paid once, so that a
reader on any stream finds the value whole and needs no event.
"""

from __future__ import annotations

import functools

import torch

_CACHES: list = []


def device_constant(fn):
    """functools.lru_cache for a function whose value is made on the device
    its last argument names (a string): made whole before it is cached."""

    @functools.wraps(fn)
    def make(*args):
        value = fn(*args)
        device = torch.device(args[-1])
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return value

    cached = functools.lru_cache(maxsize=None)(make)
    _CACHES.append(cached)
    return cached


def clear() -> None:
    """Forget every constant: the next caller makes each anew."""
    for cached in _CACHES:
        cached.cache_clear()
