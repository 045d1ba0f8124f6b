"""Kernels K1-K9, mont_pow, msm_upsweep, msm_tails, msm_abel, msm_finish,
msm_digits and msm_gather against their plain versions on the card (needs
CUDA), a pass and msm_many on the card against the CPU path, K2 through
both its entries, K2 and K3 on batches of transforms (one launch a batch),
and every kernel on its operands' card (needs two).

Run on a machine with an NVIDIA GPU (no jax needed there, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Each test skips inside the `cuda` fixture when no card is present, so
every worker collects the same tests.  Comparisons are exact, tolerance 0:
integer arithmetic, and for the probe K7's f32fma a plain version that takes
each step exactly in float64 and rounds once, as the fused kernel does.
"""

import random

import pytest

import torch

from zklaim_tpu_torch import kernels as K
from zklaim_tpu_torch.entry import run_main_path, tiny_circuit
from zklaim_tpu_torch.groth16.api import prove, setup
from zklaim_tpu_torch.kernels.cases import kernel_cases, max_abs_err
from zklaim_tpu_torch.ntt import gpu_ntt

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    K.library()
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def cases(cuda):
    return kernel_cases(cuda, seed=1)


@pytest.mark.parametrize("kernel", list(K.KERNELS))
def test_kernel_matches_plain_at_main_path_shapes(cases, kernel):
    mine = [c for c in cases if c.kernel == kernel]
    assert mine
    for case in mine:
        before = K.LAUNCHES[kernel]
        got = case.run()
        torch.cuda.synchronize()
        assert K.LAUNCHES[kernel] > before, case.label
        want = case.plain()
        assert max_abs_err(got, want) == 0, case.label


def test_wrappers_reject_bad_operands(cuda):
    from zklaim_tpu_torch.ec.gpu_curve import point_add_planes, point_double_planes
    from zklaim_tpu_torch.ff.montgomery import FR, mont_mul, mont_pow_bits, mont_pow_k1
    from zklaim_tpu_torch.msm.gpu_msm import msm_finish_planes, msm_tails_planes

    a = torch.zeros((4, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mont_mul(FR, a.long(), a)
    with pytest.raises(ValueError):
        mont_mul(FR, a, a.cpu())
    p = torch.zeros((3, 16, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        point_add_planes(2, p, p)
    with pytest.raises(ValueError):
        point_double_planes(2, p)
    with pytest.raises(ValueError):
        point_double_planes(1, p.transpose(1, 2))
    bits = [1, 0, 1]
    for bad in (lambda: mont_pow_k1(FR, a.cpu(), bits), lambda: mont_pow_bits(FR, a.long(), bits),
                lambda: mont_pow_bits(FR, a[:, :8], bits), lambda: mont_pow_bits(FR, a, [1] * 257),
                lambda: mont_pow_bits(FR, a, [0, 3])):
        with pytest.raises(ValueError):
            bad()
    t = torch.zeros((3, 16, 32), dtype=torch.int32, device=cuda)
    for bad in (lambda: msm_finish_planes(1, t.cpu(), t.cpu(), 8, 1),      # CPU tensors
                lambda: msm_finish_planes(1, t.long(), t.long(), 8, 1),    # wrong dtype
                lambda: msm_finish_planes(2, t, t, 8, 1),                  # 3 planes are no G2 point
                lambda: msm_finish_planes(1, t, t, 8, 2),                  # k W != lanes
                lambda: msm_finish_planes(1, t, t[..., :16], 8, 1),        # partials differ
                lambda: msm_finish_planes(1, t, t, 1, 1),                  # c = 1
                lambda: msm_finish_planes(1, t, t, 5, 1),                  # c does not divide 16
                lambda: msm_finish_planes(1, t.transpose(1, 2), t.transpose(1, 2), 8, 1),
                lambda: msm_finish_planes(1, t.repeat(1, 1, 512), t.repeat(1, 1, 512), 8, 512)):
        with pytest.raises(ValueError):                                    # last: shared memory
            bad()
    lv = [torch.zeros((3, 16, 1 << (2 - t)), dtype=torch.int32, device=cuda) for t in range(3)]
    m = torch.zeros(5, dtype=torch.int64, device=cuda)
    for bad in (lambda: msm_tails_planes(1, lv, m.cpu(), 2),                 # CPU prefix lengths
                lambda: msm_tails_planes(1, lv, m.int(), 2),                 # not int64
                lambda: msm_tails_planes(1, lv, m.view(5, 1), 2),            # not a vector
                lambda: msm_tails_planes(1, lv[:2], m, 2),                   # a level missing
                lambda: msm_tails_planes(1, lv[::-1], m, 2),                 # widths wrong
                lambda: msm_tails_planes(2, lv, m, 2),                       # 3 planes: no G2 point
                lambda: msm_tails_planes(1, [x.long() for x in lv], m, 2)):
        with pytest.raises(ValueError):
            bad()


def test_mont_mul_and_mont_pow_on_unaligned_and_strided_operands(cuda):
    """K1 reads contiguous 16-byte-aligned operands as 16-byte vectors and
    everything else through the strided scalar path, and never faults: a
    slice that starts 4 bytes into a buffer, a broadcast constant and a
    (16, n) plane view all equal the plain version."""
    import numpy as np

    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.kernels.cases import random_field

    n = 1000
    for spec in (M.FQ, M.FR):
        a, b = (random_field(spec, n, np.random.default_rng(s), cuda) for s in (1, 2))
        want = M.mont_mul_plain(spec, a, b)
        buf = torch.zeros(n * 16 + 4, dtype=torch.int32, device=cuda)
        off = buf[1 : 1 + n * 16].view(n, 16)
        off.copy_(a)
        assert off.data_ptr() % 16 == 4 and off.is_contiguous()
        assert max_abs_err(M.mont_mul(spec, off, b), want) == 0
        assert max_abs_err(M.mont_mul(spec, b, off), want) == 0
        planes = a.t().contiguous()                                  # (16, n): limb stride n
        assert max_abs_err(M.mont_mul(spec, planes.t(), b), want) == 0
        const = b[5]
        assert max_abs_err(M.mont_mul(spec, a, const), M.mont_mul_plain(spec, a, const)) == 0
        assert max_abs_err(M.mont_mul(spec, off, const), M.mont_mul_plain(spec, a, const)) == 0
        bits = spec.exp_p_minus_2_bits
        inv = M.mont_pow_bits_plain(spec, a[:40], bits)
        before = K.LAUNCHES["mont_pow"]
        assert max_abs_err(M.mont_pow_bits(spec, a[:40], bits), inv) == 0
        assert max_abs_err(M.mont_pow_bits(spec, off[:40], bits), inv) == 0          # unaligned
        assert max_abs_err(M.mont_pow_bits(spec, planes.t()[:40], bits), inv) == 0   # copied
        assert max_abs_err(M.mont_pow_bits(spec, a[:40].view(5, 8, 16), bits).view(40, 16), inv) == 0
        assert K.LAUNCHES["mont_pow"] == before + 4                  # one launch a power
        one = M.mont_pow_bits(spec, a[:40], [0, 0])
        assert torch.equal(one, spec.const("one_mont", cuda).to(torch.int32).expand(40, 16))
        assert M.mont_pow_bits(spec, a[:0], bits).shape == (0, 16)


def test_msm_finish_on_strided_partials_and_many_sums(cuda):
    """msm_finish takes plane and row strides (a slice of wider partials) and
    more sums than the CTA has warps (k = 20 at c = 16); both equal the plain
    finish, and each call is one launch."""
    import numpy as np

    from zklaim_tpu_torch.kernels.cases import curve_inputs
    from zklaim_tpu_torch.msm.gpu_msm import finish, finish_plain, msm_finish_planes

    rng = np.random.default_rng(8)
    for deg in (1, 2):
        wide_t, wide_h = curve_inputs(deg, 48, rng, cuda)
        tot, head = wide_t[..., 9:25], wide_h[..., 9:25]
        assert not tot.is_contiguous()
        before = K.LAUNCHES["msm_finish"]
        got = msm_finish_planes(deg, tot, head, 16, 1)
        assert K.LAUNCHES["msm_finish"] == before + 1
        assert max_abs_err(got, finish_plain(deg, tot.contiguous(), head.contiguous(), 16, 1)) == 0
    tot, head = curve_inputs(1, 20 * 16, rng, cuda)
    assert max_abs_err(finish(1, tot, head, 16, 20), finish_plain(1, tot, head, 16, 20)) == 0


def test_msm_tails_on_strided_levels(cuda):
    """msm_tails takes each level's own plane and row strides (slices of
    wider plane sets), prefix lengths 0, 2^nb and values with bits above nb,
    and more lanes than a CTA holds; it equals tails_plain on contiguous
    copies, G1 and G2, one launch a call."""
    import numpy as np

    from zklaim_tpu_torch.kernels.cases import tail_inputs
    from zklaim_tpu_torch.msm.gpu_msm import msm_tails_planes, tails_plain

    rng = np.random.default_rng(12)
    for deg in (1, 2):
        levels, m, nb = tail_inputs(deg, 2, 4, 1 << 10, rng, cuda)
        views = [torch.cat([lv[..., :1], lv, lv[..., :2]], dim=2)[..., 1 : 1 + lv.shape[2]]
                 for lv in levels]                             # row stride w + 3, not w
        assert all(torch.equal(v, lv) for v, lv in zip(views, levels))
        assert not views[0].is_contiguous()
        edge = torch.tensor([0, 1 << nb, (1 << nb) - 1, (1 << (nb + 1)) + 3], device=cuda)
        mm = torch.cat([m, edge])
        before = K.LAUNCHES["msm_tails"]
        got = msm_tails_planes(deg, views, mm, nb)
        assert K.LAUNCHES["msm_tails"] == before + 1
        want = tails_plain(deg, [v.contiguous() for v in views], mm, nb)
        assert max_abs_err(got, want) == 0, deg


def test_msm_upsweep_and_abel_at_small_tiles(cuda, monkeypatch):
    """msm_upsweep under plans of small tiles (a CTA's slots cut to `held`:
    many launches of many CTAs) and of the card's (one-CTA launches whose
    last levels leave warps and G2 pairs part empty), on a level 0 sliced
    from wider planes, and msm_abel at window sizes 2, 4 and 8 on sliced
    heads, G1 and G2, equal the plain loops; one launch a (t, r, T) of the
    plan and one a tree."""
    import numpy as np

    from zklaim_tpu_torch.kernels.cases import random_points
    from zklaim_tpu_torch.msm import upsweep_plan as UP
    from zklaim_tpu_torch.msm.gpu_msm import (
        abel_plain, msm_abel_planes, msm_upsweep_planes, upsweep_plain,
    )

    rng = np.random.default_rng(14)
    card_slots = UP.slots
    for deg in (1, 2):
        wide = random_points(deg, (1 << 12) + 5, rng, cuda)
        for nb, held in ((12, None), (12, 64), (9, 8), (5, None), (1, None), (0, None)):
            monkeypatch.setattr(UP, "slots", card_slots if held is None else lambda d: held)
            level0 = wide[..., 3 : 3 + (1 << nb)]                # limb stride 4101, not 2^nb
            plan = UP.upsweep_plan(deg, nb)
            before = K.LAUNCHES["msm_upsweep"]
            got = msm_upsweep_planes(deg, level0, plan)
            assert K.LAUNCHES["msm_upsweep"] == before + len(plan)
            want = upsweep_plain(deg, level0.contiguous())
            assert max_abs_err(got, want) == 0, (deg, nb, held)
        monkeypatch.setattr(UP, "slots", card_slots)
        for c in (2, 4, 8):
            kw = 256 // c
            heads = wide[..., 1 : 1 + (kw << (c - 1))]
            before = K.LAUNCHES["msm_abel"]
            got = msm_abel_planes(deg, heads, kw, UP.abel_plan(deg, heads.shape[2], kw))
            assert K.LAUNCHES["msm_abel"] == before + 1
            assert max_abs_err(got, abel_plain(deg, heads.contiguous(), kw)) == 0, (deg, c)


def test_msm_abel_chains_a_tree_past_one_cta(cuda):
    """At c = 16 a window column's tree has 2^15 heads, more than a CTA
    holds: abel runs it as two msm_abel launches (8 and 7 levels, G1 and
    G2), each launch's columns the next one's heads, and equals the halving
    loop; a whole MSM of 2^10 points at c = 16 (two msm_abel launches) gives
    the point c = 8 gives."""
    import numpy as np

    from zklaim_tpu_torch.bench import make_points
    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.ff.limbs import ints_to_limbs, to_tensor
    from zklaim_tpu_torch.ff.params import R
    from zklaim_tpu_torch.kernels.cases import pass_points
    from zklaim_tpu_torch.msm import gpu_msm as GM
    from zklaim_tpu_torch.msm import pippenger as TP

    rng = np.random.default_rng(16)
    kw = 16
    for deg in (1, 2):
        heads = pass_points(deg, kw << 15, rng, cuda)
        assert GM.abel_plan(deg, heads.shape[2], kw) == [8, 7]
        before = K.LAUNCHES["msm_abel"]
        got = GM.abel(deg, heads, kw)
        assert K.LAUNCHES["msm_abel"] == before + 2
        assert max_abs_err(got, GM.abel_plain(deg, heads, kw)) == 0, deg
    rnd = random.Random(16)
    rows = make_points(1, 1 << 10, cuda)
    scalars = to_tensor(ints_to_limbs([rnd.randrange(R) for _ in range(1 << 10)]), cuda)
    before = K.LAUNCHES["msm_abel"]
    got = TP.msm_pow2(1, rows, scalars, c=16)
    assert K.LAUNCHES["msm_abel"] == before + 2
    want = TP.msm_pow2(1, rows, scalars, c=8)
    assert C.planes_to_host_points(1, got) == C.planes_to_host_points(1, want)


def _front_scalars(n, rnd, device):
    """(n, 16) scalar limbs sliced 4 rows into a wider table: 0, 1, r - 1, a
    top window that takes a carry, random scalars, and a zero tail of n / 4
    as msm_many pads a sum."""
    from zklaim_tpu_torch.ff.limbs import ints_to_limbs, to_tensor
    from zklaim_tpu_torch.ff.params import R

    sc = [0, 1, R - 1, (1 << 253) | ((1 << 248) - 1)] + [rnd.randrange(R) for _ in range(n + 4)]
    sc[4 + n - n // 4 : 4 + n] = [0] * (n // 4)
    return to_tensor(ints_to_limbs(sc), device)[4 : 4 + n]


def test_msm_digits_at_every_window_size_on_sliced_tables(cuda):
    """msm_digits on k = 1 and 4 sums at c = 4, 8 and 16, on scalar tables
    sliced from wider ones (_front_scalars), equals digit_keys_plain, keys
    and index, one launch a call."""
    from zklaim_tpu_torch.msm.gpu_msm import digit_keys_plain, msm_digit_keys

    rnd = random.Random(21)
    for k in (1, 4):
        tables = [_front_scalars(96, rnd, cuda) for _ in range(k)]
        assert tables[0].storage_offset() == 4 * 16
        for c in (4, 8, 16):
            before = K.LAUNCHES["msm_digits"]
            got = msm_digit_keys(tables, c)
            assert K.LAUNCHES["msm_digits"] == before + 1
            assert max_abs_err(got, digit_keys_plain(tables, c)) == 0, (k, c)


def test_msm_gather_matches_the_plain_table_gather(cuda):
    """msm_gather, G1 and G2, on 1, 2 and 4 sums of rows sliced from wider
    tables, with infinity rows and a row whose y is 0 among the points and
    zero and negative digits, on fewer lanes than a CTA takes and on many
    CTAs, equals signed_gather_plain (the [P | -P | infinity] table,
    index_select of the bit-reversed sorted index, rows to planes) limb for
    limb, one launch a call."""
    import numpy as np

    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.kernels.cases import random_points
    from zklaim_tpu_torch.msm.gpu_msm import (
        digit_keys_plain, infinity_rows, msm_gather_planes, signed_gather_plain,
    )

    rng, rnd = np.random.default_rng(22), random.Random(22)
    for deg in (1, 2):
        for k, n, c in ((1, 2, 16), (4, 64, 8), (2, 512, 4)):
            rows = [C.planes_to_rows(random_points(deg, n + 3, rng, cuda))[3:] for _ in range(k)]
            rows[0][1, 16 * deg : 32 * deg] = 0
            rows[-1][n - 1] = infinity_rows(deg, 1, cuda)[0]
            scalars = [_front_scalars(n, rnd, cuda) for _ in range(k)]
            keys, idx = digit_keys_plain(scalars, c)
            perm = torch.sort(keys, stable=True)[1]
            nb = keys.shape[0].bit_length() - 1
            before = K.LAUNCHES["msm_gather"]
            got = msm_gather_planes(deg, rows, idx, perm, nb)
            assert K.LAUNCHES["msm_gather"] == before + 1
            want = signed_gather_plain(deg, rows, idx, perm, nb)
            assert max_abs_err(got, want) == 0, (deg, k, n, c)


def test_window_partials_and_msm_many_on_card_match_cpu(cuda):
    """A pass of four G1 sums on the card (_window_partials: msm_digits, the
    sort, msm_gather, then the upsweep, tails and Abel kernels) equals the
    CPU path limb for limb and adds one launch each of msm_digits and
    msm_gather; msm_many over three G1 sums of unequal lengths in three
    chunks, and a G2 msm_pow2, give the CPU's planes limb for limb."""
    import numpy as np

    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.kernels.cases import random_points
    from zklaim_tpu_torch.msm import pippenger as TP

    rng, rnd = np.random.default_rng(23), random.Random(23)

    def table(deg, n):
        return (C.planes_to_rows(random_points(deg, n, rng, "cpu")), _front_scalars(n, rnd, "cpu"))

    def on(tables, dev):
        return [(r.to(dev), s.to(dev)) for r, s in tables]

    tables = [table(1, 16) for _ in range(4)]
    before = {name: K.LAUNCHES[name] for name in ("msm_digits", "msm_gather")}
    got = TP._window_partials(1, on(tables, cuda), 8)
    assert {name: K.LAUNCHES[name] - n for name, n in before.items()} == {
        "msm_digits": 1, "msm_gather": 1}
    want = TP._window_partials(1, tables, 8)
    assert max_abs_err([g.cpu() for g in got], want) == 0
    pairs = [table(1, n) for n in (40, 17, 33)]
    got = TP.msm_many(1, on(pairs, cuda), 8, chunk=16)
    assert max_abs_err(got.cpu(), TP.msm_many(1, pairs, 8, chunk=16)) == 0
    (rows, scalars), = [table(2, 20)]
    got = TP.msm_pow2(2, rows.to(cuda), scalars.to(cuda), 8)
    assert max_abs_err(got.cpu(), TP.msm_pow2(2, rows, scalars, 8)) == 0


def test_msm_many_enqueues_without_waiting_for_the_card(cuda):
    """After a warm-up call (the kernels, their schedules and the point
    constants on the card), msm_many over three G1 sums in three chunks and
    a G2 msm_pow2 make no call that waits for the card -- no synchronise, no
    read back, no upload from pageable memory: torch's sync debug mode
    raises on any -- so the host enqueues a proof's passes ahead of it."""
    import numpy as np

    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.kernels.cases import random_points
    from zklaim_tpu_torch.msm import pippenger as TP

    rng, rnd = np.random.default_rng(24), random.Random(24)
    pairs = [(C.planes_to_rows(random_points(1, n, rng, cuda)), _front_scalars(n, rnd, cuda))
             for n in (40, 17, 33)]
    g2 = (C.planes_to_rows(random_points(2, 20, rng, cuda)), _front_scalars(20, rnd, cuda))
    want = TP.msm_many(1, pairs, 8, chunk=16), TP.msm_pow2(2, *g2, 8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TP.msm_many(1, pairs, 8, chunk=16), TP.msm_pow2(2, *g2, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert max_abs_err(list(got), list(want)) == 0


def test_witness_upload_enqueues_without_waiting_for_the_card(cuda):
    """After a warm-up, upload_witness of an N = 20-wide WitnessVec (its
    int64 lane, 123 big rows, one over a stale small slot) sends from pinned
    memory and builds the limbs on the card with no call that waits for it
    (torch's sync debug mode raises on a pageable upload or a synchronise),
    on the default stream and on a holder's own; the limbs equal the CPU
    path's limb for limb."""
    import numpy as np

    from zklaim_tpu_torch.ff.params import R
    from zklaim_tpu_torch.groth16.api import upload_witness
    from zklaim_tpu_torch.r1cs.system import WitnessVec

    rng, rnd = np.random.default_rng(21), random.Random(21)
    w = WitnessVec(508_203)
    w.small[:] = rng.integers(0, 1 << 62, size=len(w), dtype=np.int64)
    for i in rng.choice(len(w), size=123, replace=False).tolist():
        w[i] = rnd.randrange(1 << 62, R)
    assert all(w.small[i] for i in w.big)             # every big row over a stale slot
    want = upload_witness(w, "cpu")
    upload_witness(w, cuda)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = upload_witness(w, cuda)
        with torch.cuda.stream(side):
            got_side = upload_witness(w, cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want) and torch.equal(got_side.cpu(), want)


def test_front_wrappers_reject_bad_operands(cuda):
    from zklaim_tpu_torch.msm.gpu_msm import msm_digit_keys, msm_gather_planes

    s = torch.zeros((32, 16), dtype=torch.int32, device=cuda)
    unaligned = torch.zeros(32 * 16 + 1, dtype=torch.int32, device=cuda)[1:].view(32, 16)
    for bad in (lambda: msm_digit_keys([s.cpu()], 8),                          # CPU scalars
                lambda: msm_digit_keys([s.long()], 8),                         # not int32
                lambda: msm_digit_keys([s[:, :8]], 8),                         # 8 limbs
                lambda: msm_digit_keys([torch.zeros_like(s).repeat(1, 2)[:, :16]], 8),
                lambda: msm_digit_keys([unaligned], 8),                        # 4 bytes off
                lambda: msm_digit_keys([s, s[:16]], 8),                        # two lengths
                lambda: msm_digit_keys([], 8),                                 # no sum
                lambda: msm_digit_keys([s] * 65, 8),                           # past the table
                lambda: msm_digit_keys([s], 5),                                # c does not divide 16
                lambda: msm_digit_keys([s], 0)):
        with pytest.raises(ValueError):
            bad()
    rows = torch.zeros((32, 48), dtype=torch.int32, device=cuda)
    idx = torch.zeros(1 << 10, dtype=torch.int32, device=cuda)
    perm = torch.zeros(1 << 10, dtype=torch.int64, device=cuda)
    for bad in (lambda: msm_gather_planes(1, [rows.cpu()], idx, perm, 10),      # CPU rows
                lambda: msm_gather_planes(1, [rows.long()], idx, perm, 10),     # not int32
                lambda: msm_gather_planes(1, [rows.repeat(2, 1)[::2]], idx, perm, 10),
                lambda: msm_gather_planes(2, [rows], idx, perm, 10),            # 48 words: no G2 row
                lambda: msm_gather_planes(1, [rows], idx.cpu(), perm, 10),      # CPU index
                lambda: msm_gather_planes(1, [rows], idx, perm.cpu(), 10),      # CPU permutation
                lambda: msm_gather_planes(1, [rows], idx.long(), perm, 10),     # index not int32
                lambda: msm_gather_planes(1, [rows], idx, perm.int(), 10),      # perm not int64
                lambda: msm_gather_planes(1, [rows], idx[:512], perm, 10),      # 2^9 lanes
                lambda: msm_gather_planes(1, [rows], idx, perm.repeat(2)[::2], 10),
                lambda: msm_gather_planes(1, [rows], idx, perm, 32)):            # 2^32 lanes
        with pytest.raises(ValueError):
            bad()


def test_point_add_g2_on_strided_views(cuda):
    """K4's G2 add runs a lane on a pair of threads: slices of a wider plane
    set, lane counts that leave a pair or a warp half empty (1, 15, 17, 33,
    1000), and an output aliasing nothing all equal the plain add."""
    import numpy as np

    from zklaim_tpu_torch.ec.gpu_curve import point_add_plain, point_add_planes
    from zklaim_tpu_torch.kernels.cases import curve_inputs

    p, q = curve_inputs(2, 1100, np.random.default_rng(6), cuda)
    for n in (1, 15, 17, 33, 1000):
        pv, qv = p[..., 7 : 7 + n], q[..., 50 : 50 + n]
        got = point_add_planes(2, pv, qv)
        assert max_abs_err(got, point_add_plain(2, pv.contiguous(), qv.contiguous())) == 0, n


def test_point_double_on_strided_views(cuda):
    """K5 takes plane and row strides: a slice of a wider plane set doubles
    like its contiguous copy, and 2P equals P + P as points."""
    import numpy as np

    from zklaim_tpu_torch.ec import curve as C
    from zklaim_tpu_torch.ec.gpu_curve import point_add_planes, point_double_plain, point_double_planes
    from zklaim_tpu_torch.kernels.cases import random_points

    for deg in (1, 2):
        wide = random_points(deg, 96, np.random.default_rng(5), cuda)
        view = wide[..., 17:81]
        assert not view.is_contiguous()
        got = point_double_planes(deg, view)
        assert max_abs_err(got, point_double_plain(deg, view.contiguous())) == 0
        assert (C.planes_to_host_points(deg, got)
                == C.planes_to_host_points(deg, point_add_planes(deg, view, view)))


def test_credential_flow_statuses_on_card(cuda):
    """The zero-payload credential flow through claims.api.Context on the
    card: every status code as expected; proof_generate launches msm_finish
    once a finish and no doubling; trusted_setup launches mont_pow once a
    batched inversion (one a non-empty table: at most five) and none of the
    squarings it replaced."""
    from zklaim_tpu_torch.entry import run_credential_path

    K.reset_launches()
    res = run_credential_path(cuda, num_payloads=0, requests=1, seed=11)
    assert res["statuses_ok"], (res["status"], res["expected"])
    assert res["reprove_launches"]["msm_finish"] == 2
    assert res["reprove_launches"]["msm_tails"] >= 2          # one a pass: a G1 chunk or more, G2
    assert res["reprove_launches"]["point_double"] == 0
    assert res["reprove_launches"]["mont_pow"] == 0
    assert 1 <= res["trusted_setup_launches"]["mont_pow"] <= 5
    assert res["trusted_setup_launches"]["mont_mul"] < 100


def test_small_circuit_same_on_card_and_cpu(cuda):
    """One seed gives the same proving key, verifying key and proof on the
    card and on the CPU, as tensors and as serde bytes."""
    from zklaim_tpu_torch.claims import serde

    cs, witness = tiny_circuit()
    out = {}
    for dev in (cuda, "cpu"):
        pk, vk, qap = setup(cs, random.Random(3), dev)
        out[str(dev)] = (pk, vk, prove(pk, qap, witness, random.Random(4)))
    (gpk, gvk, gproof), (cpk, cvk, cproof) = out[str(cuda)], out["cpu"]
    for name in ("a_g1", "b_g1", "b_g2", "h_g1", "l_g1"):
        assert torch.equal(getattr(gpk, name).cpu(), getattr(cpk, name)), name
    assert gvk.ic == cvk.ic
    assert gproof == cproof
    assert serde.pk_to_bytes(gpk, 0) == serde.pk_to_bytes(cpk, 0)
    assert serde.vk_to_bytes(gvk) == serde.vk_to_bytes(cvk)
    assert serde.proof_to_bytes(gproof) == serde.proof_to_bytes(cproof)


def test_main_path_launches_every_kernel(cuda):
    """On the small circuit (m = 512) every NTT stage fits in one K2 tile,
    so K3 must not launch there; the other kernels a proof needs, msm_finish
    included, must; a proof inverts nothing and doubles only inside
    msm_finish, so mont_pow and point_double must not; nor may a probe."""
    K.reset_launches()
    res = run_main_path(cuda, requests=1, seed=9, tiny=True)
    assert res["verified"] == [True]
    assert res["unsatisfied_rejected"] and res["wrong_input_rejected"]
    assert res["m"] <= gpu_ntt.TILE
    assert K.LAUNCHES["ntt_stage"] == 0, K.LAUNCHES
    assert all(K.LAUNCHES[k] > 0 for k in K.PROOF_KERNELS if k != "ntt_stage"), K.LAUNCHES
    assert K.LAUNCHES["mont_pow"] == 0 and K.LAUNCHES["point_double"] == 0, K.LAUNCHES
    assert all(K.LAUNCHES[k] == 0 for k in K.PROBE_KERNELS), K.LAUNCHES


def test_ntt_rows_entry_at_every_size_and_split(cuda):
    """K2's gather entry: NTTDomain.ntt and intt on the card equal the CPU's
    at n = 2 .. 2^12 and 2^15 (one K2 launch a transform); the entry at
    other tiles and clusters -- clusters of 2 to 8 CTAs, and CTAs of 1,024
    elements, whose shared memory needs the opt-in above 48 KiB --
    equals the walk of the kernel's split; a transposed (n, 16) view
    transforms as its rows do; operands on the CPU, or rows not 16-byte
    aligned, raise."""
    import numpy as np

    from zklaim_tpu_torch.kernels.cases import random_field
    from zklaim_tpu_torch.ff.montgomery import FR
    from zklaim_tpu_torch.ntt.radix2 import NTTDomain

    for log_n in list(range(1, 13)) + [15]:
        n = 1 << log_n
        x = random_field(FR, n, np.random.default_rng(log_n), cuda)
        gpu, cpu = NTTDomain(n, cuda), NTTDomain(n, "cpu")
        before = K.LAUNCHES["ntt_local"]
        got = gpu.ntt(x)
        assert K.LAUNCHES["ntt_local"] == before + 1, log_n
        assert max_abs_err(got.cpu(), cpu.ntt(x.cpu())) == 0, log_n
        assert max_abs_err(gpu.intt(x).cpu(), cpu.intt(x.cpu())) == 0, log_n
    n = 1 << 12
    dom = NTTDomain(n, cuda)
    x = random_field(FR, n, np.random.default_rng(3), cuda)
    view = x.t().contiguous().t()
    assert not view.is_contiguous()
    assert max_abs_err(dom.ntt(view), dom.ntt(x)) == 0
    assert max_abs_err(dom.coset_intt(view).cpu(), NTTDomain(n, "cpu").coset_intt(x.cpu())) == 0
    for tile, cluster in ((16, 4), (64, 8), (32, 2), (2048, 2), (1024, 4)):
        for tw in (dom.tw_flat, dom.tw_inv_flat):
            got = gpu_ntt.ntt_local_rows(x, tw, tile, cluster)
            want = gpu_ntt.ntt_local_cluster_plain(x, tw, tile, cluster, rows=True)
            assert max_abs_err(got, want) == 0, (tile, cluster)
            assert max_abs_err(gpu_ntt.ntt_local(x.t().contiguous()[:, gpu_ntt.bitrev_rows(n, cuda)]
                                                 .contiguous(), tw, tile, cluster), want) == 0
    buf = torch.zeros(n * 16 + 4, dtype=torch.int32, device=cuda)
    off = buf[1 : 1 + n * 16].view(n, 16)
    for bad in (lambda: gpu_ntt.ntt_local_rows(off, dom.tw_flat),          # not 16-byte aligned
                lambda: gpu_ntt.ntt_local_rows(x, dom.tw_flat.cpu()),      # twiddles on the CPU
                lambda: gpu_ntt.ntt_local(x.t().contiguous(), dom.tw_flat.cpu()),
                lambda: gpu_ntt.ntt_local_rows(x.long(), dom.tw_flat)):
        with pytest.raises(ValueError):
            bad()


def test_batched_transforms_launch_k2_once_and_k3_once_a_pass(cuda):
    """NTTDomain's four transforms on (n, B, 16) on the card equal the CPU's,
    B odd and even, at n = 2 .. 2^11 and the four-step NTT's shapes, and a
    batch launches K2 once and K3 once a pass: LAUNCHES shows no loop over
    B.  A strided batch (every other column of a wider input) transforms as
    its contiguous copy; the batched entries at small tiles and clusters
    equal the walks of the kernels' splits."""
    import numpy as np

    from zklaim_tpu_torch.ff.montgomery import FR
    from zklaim_tpu_torch.kernels.cases import random_field
    from zklaim_tpu_torch.ntt.radix2 import NTTDomain

    for n, batch in ((2, 3), (4, 5), (256, 1), (256, 7), (2048, 3), (2048, 8), (256, 128),
                     (128, 256)):
        x = random_field(FR, n * batch, np.random.default_rng(n + batch), cuda).view(n, batch, 16)
        gpu, cpu = NTTDomain(n, cuda), NTTDomain(n, "cpu")
        passes = len(gpu_ntt.global_passes(n, batch=batch))
        for op in ("ntt", "intt", "coset_ntt", "coset_intt"):
            before = dict(K.LAUNCHES)
            got = getattr(gpu, op)(x)
            torch.cuda.synchronize()
            assert K.LAUNCHES["ntt_local"] == before["ntt_local"] + 1, (n, batch, op)
            assert K.LAUNCHES["ntt_stage"] == before["ntt_stage"] + passes, (n, batch, op)
            assert max_abs_err(got.cpu(), getattr(cpu, op)(x.cpu())) == 0, (n, batch, op)
    n, batch = 2048, 5
    dom = NTTDomain(n, cuda)
    wide = random_field(FR, n * 2 * batch, np.random.default_rng(9), cuda).view(n, 2 * batch, 16)
    view = wide[:, ::2]
    assert not view.is_contiguous()
    assert max_abs_err(dom.ntt(view), dom.ntt(view.contiguous())) == 0
    x = view.contiguous()
    for tile, cluster in ((16, 4), (64, 8), (32, 2), (1024, 4)):
        for tw in (dom.tw_flat, dom.tw_inv_flat):
            got = gpu_ntt.ntt_local_rows(x, tw, tile, cluster)
            want = gpu_ntt.ntt_local_cluster_plain(x, tw, tile, cluster, rows=True)
            assert max_abs_err(got, want) == 0, (tile, cluster)
            planes = got.clone()
            assert max_abs_err(gpu_ntt.ntt_global(planes, tw, tile, n=n),
                               gpu_ntt.ntt_global_columns_plain(got, tw, tile, n=n)) == 0
    with pytest.raises(ValueError):                  # a width that is no multiple of n
        gpu_ntt.ntt_global(torch.zeros((16, 3 * n // 2), dtype=torch.int32, device=cuda),
                           dom.tw_flat, n=n)


def test_kernels_launch_on_their_operands_card(cuda):
    """With card 0 current, operands on card 1: every kernel of a proof's
    transforms and sums lands on card 1 (results there, equal to the plain
    versions), card 0 stays current, and operands on two cards raise."""
    import numpy as np

    from zklaim_tpu_torch.ec.gpu_curve import point_add_plain, point_add_planes
    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.kernels.cases import curve_inputs, random_field
    from zklaim_tpu_torch.ntt.radix2 import NTTDomain

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    one = torch.device("cuda:1")
    rng = np.random.default_rng(4)
    with torch.cuda.device(0):
        a, b = (random_field(M.FR, 4096, rng, one) for _ in range(2))
        prod = M.mont_mul(M.FR, a, b)
        assert prod.device == one and max_abs_err(prod, M.mont_mul_plain(M.FR, a, b)) == 0
        dom = NTTDomain(1 << 12, one)
        y = dom.ntt(a)
        assert y.device == one and max_abs_err(y.cpu(), NTTDomain(1 << 12, "cpu").ntt(a.cpu())) == 0
        p, q = curve_inputs(1, 1000, rng, one)
        s = point_add_planes(1, p, q)
        assert s.device == one and max_abs_err(s, point_add_plain(1, p, q)) == 0
        torch.cuda.synchronize(one)
        assert torch.cuda.current_device() == 0
        with pytest.raises(ValueError):
            M.mont_mul(M.FR, a, b.to("cuda:0"))
        with pytest.raises(ValueError):
            point_add_planes(1, p, q.to("cuda:0"))


def test_probe_wrappers_reject_bad_operands(cuda):
    from zklaim_tpu_torch.tools.grid_micro import point_add_tiled
    from zklaim_tpu_torch.tools.mont_micro import mont_chain
    from zklaim_tpu_torch.tools.padd_micro import point_add_chain
    from zklaim_tpu_torch.tools.pallas_op_micro import op_chain

    x = torch.zeros((16, 8), dtype=torch.int32, device=cuda)
    p = torch.zeros((3, 16, 8), dtype=torch.int32, device=cuda)
    for bad in (lambda: mont_chain(x.long(), 1), lambda: mont_chain(x.t(), 1),
                lambda: mont_chain(x, -1), lambda: op_chain("u32mul", x.float(), 1),
                lambda: op_chain("f32fma", x, 1), lambda: op_chain("u64mul", x, 1),
                lambda: point_add_tiled(p, p[..., :4], 4), lambda: point_add_tiled(p, p, 0),
                lambda: point_add_chain(p.transpose(1, 2), 1), lambda: point_add_chain(p, -1)):
        with pytest.raises(ValueError):
            bad()


def test_probes_scale_linearly_in_chain_length(cuda):
    """The compiler did not fold a probe's loop: the time of 4 K steps is
    well above that of K steps (between 2 and 6 times it), for every op, for
    K6 at the card's width and at its original's 1,024 lanes in CTAs of one
    warp, and for K9 at its original's 1,024 lanes in its CTAs of one warp;
    and no op runs above one instruction a lane a clock on every SM (132 SMs
    x 128 lanes x 2 GHz): merged steps would."""
    from zklaim_tpu_torch.tools import mont_micro, padd_micro, pallas_op_micro
    from zklaim_tpu_torch.utils.profiling import best_ms

    sms = K.sm_count(cuda)
    for lanes, threads, ks in ((mont_micro.WIDE_LANES, 256, (256, 1024)),
                               (mont_micro.LANES, 32, (64, 256))):
        assert mont_micro.chain_threads(lanes, sms) == threads
        x = mont_micro.probe_input(lanes, cuda)
        t1, t4 = (best_ms(lambda k=k: mont_micro.mont_chain(x, k), cuda) for k in ks)
        assert 2 < t4 / t1 < 6, (lanes, t1, t4)
    pt = padd_micro.probe_input(padd_micro.LANES, cuda)
    assert padd_micro.chain_threads(pt.shape[2], sms) == 32
    t1, t4 = (best_ms(lambda k=k: padd_micro.point_add_chain(pt, k), cuda) for k in (32, 128))
    assert 2 < t4 / t1 < 6, ("point_add_chain", t1, t4)
    for op in pallas_op_micro.OPS:
        v = pallas_op_micro.probe_input(op, pallas_op_micro.WIDE_COLS, cuda)
        t1, t4 = (best_ms(lambda k=k: pallas_op_micro.op_chain(op, v, k), cuda)
                  for k in (2000, 8000))
        assert 2 < t4 / t1 < 6, (op, t1, t4)
        assert v.numel() * 6000 / ((t4 - t1) * 1e-3) < 132 * 128 * 2e9, (op, t1, t4)


def test_mont_chain_on_ragged_lanes_and_plane_strides(cuda):
    """K6 on lane counts no CTA size divides -- 1,023 and 1,101 lanes (32 and
    35 CTAs of one warp, on as many SMs) and the card's width + 77 (4,225
    CTAs of 256, the last part full) -- at K = 0, 1 and 3, on contiguous
    planes and on planes whose plane stride is no multiple of 4 lanes: equal
    to mont_chain_plain, one launch a call."""
    from zklaim_tpu_torch.tools import mont_micro

    sms = K.sm_count(cuda)
    for n, threads in ((1023, 32), (1024 + 77, 32), (mont_micro.WIDE_LANES + 77, 256)):
        assert mont_micro.chain_threads(n, sms) == threads
        x = mont_micro.probe_input(n, cuda)
        wider = torch.zeros((16, n + 3), dtype=torch.int32, device=cuda)
        wider[:, :n] = x
        for planes in (x, wider[:, :n]):
            for k in (0, 1, 3):
                before = K.LAUNCHES["mont_chain"]
                got = mont_micro.mont_chain(planes, k)
                torch.cuda.synchronize()
                assert K.LAUNCHES["mont_chain"] == before + 1
                assert max_abs_err(got, mont_micro.mont_chain_plain(x, k)) == 0, (n, k,
                                                                                   planes.stride())


def test_point_add_tiled_at_every_tile_on_a_ragged_n(cuda):
    """K8 with a tile's CTA sized to fill its SM (min(tile, 384) threads):
    at every tile of the sweep, on lane counts no tile divides (the last
    CTA part full, a tile wider than n), equal to the plain add; one launch
    a call."""
    import numpy as np

    from zklaim_tpu_torch.kernels.cases import curve_inputs
    from zklaim_tpu_torch.tools import grid_micro

    for n in (grid_micro.N + 77, 1000, 129):
        p, q = curve_inputs(1, n, np.random.default_rng(n), cuda)
        want = grid_micro.point_add_tiled_plain(p, q, 1)
        for tile in grid_micro.TILES:
            before = K.LAUNCHES["point_add_tiled"]
            got = grid_micro.point_add_tiled(p, q, tile)
            torch.cuda.synchronize()
            assert K.LAUNCHES["point_add_tiled"] == before + 1
            assert max_abs_err(got, want) == 0, (n, tile)


def test_mont_mul_on_the_edge_values(cuda):
    """K1 on every pair of the edge values of the CPU model test of fe_mul
    (0, 1, R mod p, p - 1, p - 2, values with p's top word), Fq and Fr,
    through its vector and its strided path, equal to mont_mul_plain."""
    from zklaim_tpu_torch.ff import montgomery as M
    from zklaim_tpu_torch.kernels.cases import edge_pairs

    for spec in (M.FQ, M.FR):
        a, b = edge_pairs(spec, cuda)
        want = M.mont_mul_plain(spec, a, b)
        assert max_abs_err(M.mont_mul(spec, a, b), want) == 0, spec.name
        assert max_abs_err(M.mont_mul(spec, a.t().contiguous().t(), b), want) == 0, spec.name


def test_bench_entry_point_in_a_fresh_process(cuda):
    """`python -m zklaim_tpu_torch.bench --full` and the default run each
    print one JSON row taken on the card (a fresh process: no CUDA context
    exists when the first row resets the peak-memory counter)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for args, metric in ((["--full"], "groth16_prover_latency_1payload"),
                         (["--log2n", "12"], "g1_msm_2^12_points_per_sec")):
        out = subprocess.run([sys.executable, "-m", "zklaim_tpu_torch.bench", *args], cwd=root,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        row = json.loads(out.stdout.strip().splitlines()[-1])
        assert row["metric"] == metric and row["impl"] == "torch" and row["value"] > 0
        assert row["device"].startswith(torch.cuda.get_device_name(0))
