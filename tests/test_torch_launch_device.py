"""kernels.launch runs on the card its operands lie on (no card needed).

The C function, the device guard and the stream lookup are faked with
monkeypatch: the test holds what `launch` passes -- the operands' device to
the guard, that device's stream to the kernel -- and what `launch_device`
accepts: int32 CUDA operands on one device, nothing on the CPU or on two
cards.  A static walk of the port's sources checks that every launch site
names its device.
"""

import ast
import contextlib
from pathlib import Path
from types import SimpleNamespace

import pytest

import torch

from zklaim_tpu_torch import kernels as K

torch.set_num_threads(1)

PORT = Path(K.__file__).resolve().parents[1]


def _fake_operand(device: str, dtype=torch.int32):
    """What check_planes and launch_device read of a CUDA tensor."""
    return SimpleNamespace(is_cuda=device.startswith("cuda"), dtype=dtype,
                           device=torch.device(device))


@pytest.fixture
def faked(monkeypatch):
    """A fake library: records each kernel call's arguments, the device the
    guard was entered with, and the device whose stream was looked up."""
    seen = {"calls": [], "guard": [], "stream_of": []}

    def fn(*args):
        seen["calls"].append((seen["guard"][-1] if seen["guard"] else None, args))
        return 0

    @contextlib.contextmanager
    def guard(dev):
        seen["guard"].append(torch.device(dev))
        yield

    def current_stream(dev=None):
        seen["stream_of"].append(dev)
        return SimpleNamespace(cuda_stream=1000 + torch.device(dev).index)

    monkeypatch.setattr(K, "_LIB", object())
    monkeypatch.setitem(K._FUNCTIONS, "mont_mul", fn)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setitem(K.LAUNCHES, "mont_mul", 0)
    return seen


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_passes_the_operands_device_and_its_stream(faked, index):
    dev = torch.device(f"cuda:{index}")
    K.launch("mont_mul", 11, 22, device=dev)
    assert faked["guard"] == [dev]
    assert faked["stream_of"] == [dev]
    (guard_during_call, args), = faked["calls"]
    assert guard_during_call == dev                    # the launcher ran under the guard
    assert args == (11, 22, 1000 + index)              # that device's stream, last
    assert K.LAUNCHES["mont_mul"] == 1


def test_launch_needs_a_cuda_device(faked):
    with pytest.raises(TypeError):
        K.launch("mont_mul", 1)                        # the device is a required keyword
    with pytest.raises(ValueError):
        K.launch("mont_mul", 1, device=torch.device("cpu"))
    assert faked["calls"] == [] and K.LAUNCHES["mont_mul"] == 0


def test_launches_from_many_threads_are_all_counted(faked):
    """Holders on several threads launch at once: LAUNCHES counts every
    launch (eight threads of 2,000, a shortened switch interval)."""
    import sys
    import threading

    dev = torch.device("cuda:0")

    def launches():
        for _ in range(2000):
            K.launch("mont_mul", 1, device=dev)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launches) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert K.LAUNCHES["mont_mul"] == len(faked["calls"]) == 8 * 2000


def test_a_failed_launch_raises_and_is_not_counted(monkeypatch, faked):
    monkeypatch.setitem(K._FUNCTIONS, "mont_mul", lambda *args: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        K.launch("mont_mul", 1, device=torch.device("cuda:0"))
    assert K.LAUNCHES["mont_mul"] == 0


def test_launch_device_is_the_one_card_of_the_operands():
    a, b = _fake_operand("cuda:1"), _fake_operand("cuda:1")
    assert K.launch_device("x", a, b) == torch.device("cuda:1")
    assert K.launch_device("x", a, others=(_fake_operand("cuda:1", torch.int64),)) == a.device
    assert K.launch_device("x", others=(_fake_operand("cuda:2", torch.float32),)).index == 2


@pytest.mark.parametrize("operands, others", [
    (("cuda:0", "cuda:1"), ()),                         # two cards
    (("cuda:0", "cpu"), ()),                            # a CPU operand
    (("cpu",), ()),
    (("cuda:0",), ("cuda:1",)),                         # another operand on another card
    (("cuda:0",), ("cpu",)),
    ((), ()),                                           # nothing to launch on
])
def test_launch_device_rejects_cpu_and_mixed_operands(operands, others):
    with pytest.raises(ValueError):
        K.launch_device("x", *map(_fake_operand, operands),
                        others=tuple(_fake_operand(d, torch.int64) for d in others))


def test_launch_device_rejects_other_types_and_real_cpu_tensors():
    with pytest.raises(ValueError, match="int32"):
        K.launch_device("x", _fake_operand("cuda:0", torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        K.launch_device("x", torch.zeros((2, 16), dtype=torch.int32))


def _launch_calls(path: Path) -> list:
    """(line, keywords) of every K.launch(...) call in a source file."""
    tree = ast.parse(path.read_text())
    return [(node.lineno, {kw.arg for kw in node.keywords}) for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "launch" and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "K"]


def test_every_launch_site_names_its_device():
    """The port's eighteen launch sites (K2's two entries launch apart):
    each passes device=."""
    sites = {str(p.relative_to(PORT)): _launch_calls(p) for p in sorted(PORT.rglob("*.py"))}
    sites = {f: calls for f, calls in sites.items() if calls}
    assert {f: len(c) for f, c in sites.items()} == {
        "ec/gpu_curve.py": 8, "ff/montgomery.py": 2, "ntt/gpu_ntt.py": 3,
        "tools/grid_micro.py": 1, "tools/mont_micro.py": 1, "tools/padd_micro.py": 1,
        "tools/msm_stages.py": 1, "tools/pallas_op_micro.py": 1,
    }
    missing = [(f, line) for f, calls in sites.items() for line, kws in calls if "device" not in kws]
    assert not missing
