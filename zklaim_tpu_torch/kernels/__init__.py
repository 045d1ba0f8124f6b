"""Build, load and launch the hand-written CUDA kernels (K1-K9, the
whole-loop entries mont_pow of K1, msm_tails, msm_upsweep and msm_abel of
K4 and msm_finish of K5, and a Pippenger pass's front end, msm_digits and
msm_gather).

The sources in ../csrc are compiled at first use, one nvcc process a
source and all of them at once, then linked into one shared library with a
plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c -o <tmp>/<name>.o csrc/<name>.cu      (for each source)
    nvcc -shared -o build/kernels/libzklaim_kernels-<key>.so <tmp>/*.o

<key> hashes the sources and flags, so an edited source rebuilds and a
fresh checkout builds everything on its first launch.  Nothing here
touches CUDA at import time: the CPU tests import every module.

Every launch goes through `launch`, which runs the C launcher on the card
its operands lie on (`launch_device` finds it and raises where they lie on
the CPU or on two cards), under that device's guard and on that device's
current PyTorch stream, raises if the launcher returns a CUDA error, and
counts the launch in LAUNCHES -- the count a run reads to show that its
main path went through the kernels.  The C functions are looked up and given their
argument types once, when the library is loaded.  Holders may prove at once
on several threads: the launchers release the interpreter lock, the
current stream is each thread's own, and the library's loading and the
counts take a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("mont_mul.cu", "ntt.cu", "curve.cu", "msm.cu", "probes.cu")
HEADERS = ("field.cuh", "rcb.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
# kernel name -> (C symbol, argtypes without the trailing stream)
KERNELS = {
    "mont_mul": ("zk_mont_mul", [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _I64, _I]),
    "mont_pow": ("zk_mont_pow", [_P, _P, _I64, _P, _I, _I]),
    "ntt_local": ("zk_ntt_local", [_P, _P, _I64, _I, _P, _I64, _I, _I, _I]),
    "ntt_stage": ("zk_ntt_stage", [_P, _I64, _I, _P, _I64, _I, _I, _I, _I]),
    "point_add": ("zk_point_add", [_I, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _I64]),
    "point_double": ("zk_point_double", [_I, _P, _I64, _I64, _P, _I64, _I64, _I64]),
    "msm_tails": ("zk_msm_tails", [_I, _P, _I, _P, _I64, _P, _I64, _I64, _P, _I, _I, _I]),
    "msm_upsweep": ("zk_msm_upsweep", [_I, _P, _I, _I, _I, _I]),
    "msm_abel": ("zk_msm_abel", [_I, _P, _I64, _I64, _P, _I64, _I64, _I, _I64]),
    "msm_finish": ("zk_msm_finish", [_I, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64,
                                     _I, _I, _I, _P, _I, _I, _I]),
    # a pass's front end (csrc/msm.cu)
    "msm_digits": ("zk_msm_digits", [_P, _I, _I64, _I, _P, _P]),
    "msm_gather": ("zk_msm_gather", [_I, _P, _I, _I64, _P, _P, _I, _P, _P]),
    # the probes of the measuring path (csrc/probes.cu)
    "mont_chain": ("zk_mont_chain", [_P, _I64, _P, _I64, _I64, _I, _I]),
    "op_chain": ("zk_op_chain", [_I, _P, _P, _I64, _I]),
    "point_add_tiled": ("zk_point_add_tiled", [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _I64, _I64,
                                               _I]),
    "point_add_chain": ("zk_point_add_chain", [_P, _I64, _I64, _P, _I64, _I64, _I64, _I, _I]),
}
# the kernels a proof must launch (mont_pow only where a key is serialized:
# the issuer's trusted_setup; point_double only in scalar_mul / msm_ladder),
# and the probes only the measuring path runs
PATH_KERNELS = ("mont_mul", "mont_pow", "ntt_local", "ntt_stage", "point_add", "msm_digits",
                "msm_gather", "msm_upsweep", "msm_tails", "msm_abel", "msm_finish")
PROOF_KERNELS = tuple(k for k in PATH_KERNELS if k != "mont_pow")
PROBE_KERNELS = ("mont_chain", "op_chain", "point_add_tiled", "point_add_chain")

LAUNCHES = dict.fromkeys(KERNELS, 0)
BUILD_INFO: dict = {}
_LIB = None
_FUNCTIONS: dict = {}          # kernel name -> its C function, filled by library()
_LOAD_LOCK = threading.Lock()  # one build and load, whichever thread launches first
_COUNT_LOCK = threading.Lock() # LAUNCHES' read-modify-write, from every thread


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into build/kernels (once per source hash), the
    sources side by side."""
    key = _key()
    lib = BUILD_DIR / f"libzklaim_kernels-{key}.so"
    log = BUILD_DIR / f"libzklaim_kernels-{key}.ptxas.txt"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True,
                          ptxas=log.read_text() if log.exists() else "")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                    for src, obj in zip(SOURCES, objects)]
        results = [(proc.args, *proc.communicate(), proc.returncode) for proc in compiles]
        if all(rc == 0 for *_, rc in results):
            out = str(Path(tmp) / "lib.so")
            link = subprocess.run([nvcc, "-shared", "-o", out, *objects],
                                  capture_output=True, text=True)
            results.append((link.args, link.stdout, link.stderr, link.returncode))
            if link.returncode == 0:
                os.replace(out, lib)
    seconds = time.perf_counter() - t0
    failed = [(cmd, so, se, rc) for cmd, so, se, rc in results if rc != 0]
    if failed:
        raise RuntimeError("\n".join(f"nvcc failed ({rc}): {' '.join(cmd)}\n{so}\n{se}"
                                     for cmd, so, se, rc in failed))
    ptxas = "".join(se for _, _, se, _ in results)          # each source's lines together
    log.write_text(ptxas)
    BUILD_INFO.update(path=str(lib), seconds=seconds, cached=False, ptxas=ptxas)
    return lib


def library() -> ctypes.CDLL:
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (sym, argtypes) in KERNELS.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes + [_P]
                fn.restype = ctypes.c_int
                _FUNCTIONS[name] = fn
            _LIB = lib
    return _LIB


def launch(name: str, *args, device: torch.device) -> None:
    """Launch kernel `name` on `device` -- the card its operands lie on
    (launch_device) -- and that device's current stream; raise on a CUDA
    error.  The launcher runs under the device's guard, so what it sets
    per device (a kernel's shared-memory limit) applies to that card."""
    if _LIB is None:
        library()
    if device.type != "cuda":
        raise ValueError(f"kernel {name}: launched on {device}, not a CUDA device")
    with torch.cuda.device(device):
        rc = _FUNCTIONS[name](*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name} launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_planes(t: torch.Tensor, what: str) -> None:
    """A kernel operand: an int32 tensor on a CUDA device."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32 limbs, got {t.dtype}")


def launch_device(what: str, *planes: torch.Tensor, others=()) -> torch.device:
    """The one card a launch's operands lie on: each of `planes` passes
    check_planes, each of `others` (operands of another type) is a CUDA
    tensor, and all lie on one device, which is returned for `launch`.
    Raises ValueError otherwise: nothing runs on another device."""
    for i, t in enumerate(planes):
        check_planes(t, f"{what} operand {i}")
    for t in others:
        if not t.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    devices = {t.device for t in (*planes, *others)}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devices))}, not on one device")
    return devices.pop()
