"""The P/B decision pass's picks and MV-field MC entries on the card:
kernels D (``qpel_pick``) and E (``bi_pick``) of ``csrc/inter_me.cu`` and
the field entries of ``csrc/mc.cu`` (``mc_kernel.blocks_fields``,
``qpel_fields``) against their plain forms (``encoder.fast_inter.
qpel_pick_plain``, ``bi_pick_plain``, ``ops.mc.mc_blocks_fields_plain``,
``mc_qpel_fields_plain``) run on the same CUDA tensors, tolerance 0
(floats bit for bit).

Every test here is marked ``gpu`` and asks the ``cuda`` fixture for the
card (it skips without one): D at every size class on 1080p grids (17
rows of 64 blocks: ragged against a CTA of 128 blocks) and small ragged
grids, with planted ties (flat costs, equal costs of different SATDs
and bits at sqrt-lambda 2) and sqrt-lambda 0; E over every class of a
CTU (16, 32 and 64) with planted equalities of rd0, rd1 and the bi cost;
the field entries at 8 and 10 bits, every size class, luma, the Cb/Cr
pair and bi calls, with MVs that reach past the padded planes, each equal
to its plain form and to the job-table entry on the same jobs; each new
entry replays in a CUDA graph; and a 192x128 P and B decision pass on
``cuda`` equals the CPU's with one pick a size class and list, one bi
pick a B frame and every MC launch through a field entry.  Run on the
GPU machine with
``python -m pytest tests/test_torch_inter_pick_kernel.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from thevc_tpu_torch.encoder import fast_inter
from thevc_tpu_torch.ops import inter_me_kernel as kern
from thevc_tpu_torch.ops import mc, mc_kernel

SIZES = fast_inter.INTER_SIZES
LAM, SQRT_LAM, CW = 57.92, 7.61, 1.1
# 1080p grids (1088 x 1920 padded) of each size class
GRIDS_1080P = {8: (136, 240), 16: (68, 120), 32: (34, 60), 64: (17, 30)}


@pytest.fixture
def cuda():
    # decided here, not at import: the test workers must all collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def scalar(dev, v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=dev)


def pick_inputs(seed: int, nby: int, nbx: int, satd_top: int = 4000,
                reach: int = 40) -> tuple:
    """Seeded numpy inputs of a quarter-pel pick: SATD int32 [nb, 49],
    the coarse field (dy, dx, ref) int64 [nby, nbx] and the integer
    winner int64 [nb] near it."""
    rng = np.random.RandomState(seed)
    nb = nby * nbx
    satd = rng.randint(0, satd_top, (nb, 49)).astype(np.int32)
    c_dy, c_dx = (rng.randint(-reach, reach + 1, (nby, nbx)).astype(np.int64)
                  for _ in range(2))
    c_ref = rng.randint(0, 3, (nby, nbx)).astype(np.int64)
    int_mx = c_dx.reshape(-1) + rng.randint(-3, 4, nb)
    int_my = c_dy.reshape(-1) + rng.randint(-3, 4, nb)
    return satd, (c_dy, c_dx, c_ref), int_mx, int_my


def on(dev, satd, coarse, int_mx, int_my):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(satd), tuple(t(c) for c in coarse), t(int_mx), t(int_my)


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _pick_both(dev, satd, coarse, int_mx, int_my, sqrt_lam):
    args = on(dev, satd, coarse, int_mx, int_my) + (scalar(dev, sqrt_lam),)
    before = kern.pick_launches
    got = fast_inter.qpel_pick(*args)
    assert kern.pick_launches == before + 1
    want = fast_inter.qpel_pick_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("sqrt_lam", [0.0, 2.0, SQRT_LAM])
@pytest.mark.parametrize("s", SIZES)
def test_qpel_pick_equals_plain_on_1080p_grids(cuda, s, sqrt_lam):
    nby, nbx = GRIDS_1080P[s]
    _pick_both(cuda, *pick_inputs(s, nby, nbx), sqrt_lam)


@pytest.mark.gpu
@pytest.mark.parametrize("nby,nbx", [(1, 1), (1, 7), (5, 1), (3, 43),
                                     (11, 13)])
def test_qpel_pick_ragged_grids(cuda, nby, nbx):
    """Grids that do not fill the last CTA, one block wide or high (the
    above-right neighbour reads zero at the right edge)."""
    _pick_both(cuda, *pick_inputs(nby * 100 + nbx, nby, nbx), SQRT_LAM)


@pytest.mark.gpu
@pytest.mark.parametrize("sqrt_lam", [0.0, SQRT_LAM])
def test_qpel_pick_flat_costs_take_the_first_candidate(cuda, sqrt_lam):
    """Equal SATDs and a zero coarse field: at sqrt-lambda 0 every cost
    ties and candidate 0 wins; else the least bits, first of them."""
    nby, nbx = 9, 31
    satd, _coarse, _mx, _my = pick_inputs(3, nby, nbx)
    satd[:] = 777
    zero = np.zeros((nby, nbx), np.int64)
    got = _pick_both(cuda, satd, (zero, zero, zero), zero.reshape(-1),
                     zero.reshape(-1), sqrt_lam)
    if sqrt_lam == 0.0:
        assert int(got[0].min()) == int(got[0].max()) == -3
        assert int(got[1].min()) == int(got[1].max()) == -3


@pytest.mark.gpu
@pytest.mark.parametrize("s", SIZES)
def test_qpel_pick_planted_ties(cuda, s):
    """At sqrt-lambda 2 equal costs from different SATDs and bits: per
    block two candidates are set to the same least cost (the SATD of the
    one with more bits lowered by twice the difference), in either
    order; the first in candidate order wins, as ``argmin``'s."""
    nby, nbx = GRIDS_1080P[s]
    satd, coarse, int_mx, int_my = pick_inputs(50 + s, nby, nbx)
    base = 100000
    satd += base + 1000             # the other candidates cost more
    dev = torch.device("cpu")
    # the bits of every candidate, from the plain form's own helpers
    c_dy, c_dx, _ = (torch.from_numpy(c) for c in coarse)
    px, py = fast_inter._mv_pred_median(c_dx * 4, c_dy * 4)
    steps = torch.arange(-3, 4, device=dev)
    bits = fast_inter._mv_bits(
        px.reshape(-1), py.reshape(-1),
        torch.from_numpy(int_mx)[:, None] * 4 + steps,
        torch.from_numpy(int_my)[:, None] * 4 + steps).reshape(-1, 49)
    bits = bits.numpy()
    rng = np.random.RandomState(s)
    nb = nby * nbx
    a = rng.randint(0, 49, nb)
    b = rng.randint(0, 49, nb)
    b = np.where(b == a, (a + 1) % 49, b)
    rows = np.arange(nb)
    satd[rows, a] = base - 2 * bits[rows, a]
    satd[rows, b] = base - 2 * bits[rows, b]
    got = _pick_both(cuda, satd, coarse, int_mx, int_my, 2.0)
    first = np.minimum(a, b)
    want_x = int_mx * 4 + first % 7 - 3
    np.testing.assert_array_equal(got[0].cpu().numpy(), want_x)


def bi_classes(seed: int, dev, ctu: int, h: int = 1088, w: int = 1920,
               plant: bool = True) -> tuple:
    """Seeded inputs of the bi pick over every class up to ``ctu`` of an
    h x w frame, on ``dev``: {s: (leaf0, leaf1, terms)}; with ``plant``
    a quarter of the blocks get rd0 equal to the bi cost, a quarter rd1,
    a quarter rd0 == rd1 (the bi cost computed by the plain form on the
    CPU first)."""
    rng = np.random.RandomState(seed)
    lam, cw = scalar("cpu", LAM), scalar("cpu", CW)
    out = {}
    for s in (s for s in SIZES if s <= ctu):
        nby, nbx = h // s, w // s
        nb = nby * nbx

        def leaf():
            rd = (rng.rand(nby, nbx) * 1e5).astype(np.float32)
            mvx, mvy = (rng.randint(-300, 301, (nby, nbx)).astype(np.int32)
                        for _ in range(2))
            ref = rng.randint(0, 4, (nby, nbx)).astype(np.int32)
            return [torch.from_numpy(v) for v in (rd, mvx, mvy, ref)]
        leaf0, leaf1 = leaf(), leaf()
        terms = []
        for k in range(6):
            terms.append(torch.from_numpy(
                (rng.rand(nb) * 300).astype(np.float32) if k % 2
                else rng.randint(0, 1 << 20, nb).astype(np.int32)))
        if plant:
            inf = torch.full((nby, nbx), float("inf"))
            rd_bi = fast_inter.bi_pick_plain(
                {s: ((inf, *leaf0[1:]), (inf, *leaf1[1:]), terms)}, lam, cw,
                s)[s][0]
            kind = rng.randint(0, 4, (nby, nbx))
            kind = torch.from_numpy(kind)
            leaf0[0] = torch.where((kind == 1) | (kind == 3), rd_bi, leaf0[0])
            leaf1[0] = torch.where(kind == 2, rd_bi, leaf1[0])
            leaf1[0] = torch.where(kind == 3, leaf0[0], leaf1[0])
            # rd0 == rd1 below the bi cost
            low = leaf0[0] * 0.5
            leaf0[0] = torch.where(kind == 0, low, leaf0[0])
            leaf1[0] = torch.where(kind == 0, low, leaf1[0])
        out[s] = (tuple(t.contiguous().to(dev) for t in leaf0),
                  tuple(t.contiguous().to(dev) for t in leaf1),
                  tuple(t.to(dev) for t in terms))
    return out


def _bi_both(dev, classes, ctu):
    lam, cw = scalar(dev, LAM), scalar(dev, CW)
    before = kern.bi_launches
    got = fast_inter.bi_pick(classes, lam, cw, ctu)
    assert kern.bi_launches == before + 1
    want = fast_inter.bi_pick_plain(classes, lam, cw, ctu)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want)
    for s in want:
        assert_same(got[s], want[s])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("ctu", [16, 32, 64])
def test_bi_pick_equals_plain(cuda, ctu, plant):
    got = _bi_both(cuda, bi_classes(ctu + plant, cuda, ctu, plant=plant),
                   ctu)
    if plant:
        # every direction occurs
        d = torch.cat([g[1].reshape(-1) for g in got.values()])
        assert set(d.unique().tolist()) == {1, 2, 3}


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,ctu", [(16, 16, 16), (96, 160, 32),
                                     (192, 320, 64)])
def test_bi_pick_ragged_grids(cuda, h, w, ctu):
    """Classes whose blocks do not fill the last CTA of 256, down to one
    block of 16x16."""
    _bi_both(cuda, bi_classes(h + w, cuda, ctu, h, w), ctu)


def planes_and_fields(seed: int, dev, s: int, nby: int, nbx: int, bd: int,
                      luma: bool, n_refs: int = 2, reach: int = 200):
    """Seeded padded planes (luma [P, ...] or Cb then Cr [2P, ...]) and
    (ref, mvx, mvy) int32 [nb] of a grid of s x s blocks (luma) or s/2 x
    s/2 (chroma), MVs past the padded plane's edges."""
    rng = np.random.RandomState(seed)
    size = s if luma else s // 2
    pad = fast_inter.PAD_FULL if luma else fast_inter.PAD_C
    rows, cols = nby * size + 2 * pad, nbx * size + 2 * pad
    n_planes = n_refs if luma else 2 * n_refs
    planes = torch.from_numpy(rng.randint(0, 1 << bd, (n_planes, rows, cols))
                              .astype(np.int16)).to(dev)
    nb = nby * nbx
    fields = (torch.from_numpy(rng.randint(0, n_refs, nb).astype(np.int32)),
              torch.from_numpy(rng.randint(-4 * reach, 4 * reach + 1, nb)
                               .astype(np.int32)),
              torch.from_numpy(rng.randint(-4 * reach, 4 * reach + 1, nb)
                               .astype(np.int32)))
    return planes, tuple(t.to(dev) for t in fields), size, pad


@pytest.mark.gpu
@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", SIZES)
def test_blocks_fields_equal_plain_and_the_job_table(cuda, s, bd, luma, bi):
    nby, nbx = (5, 7) if s < 64 else (3, 4)
    planes, fields, size, pad = planes_and_fields(s * bd + luma, cuda, s,
                                                  nby, nbx, bd, luma)
    kw = dict(pair=not luma)
    if bi:
        p1, f1, _, _ = planes_and_fields(s * bd + luma + 7, cuda, s, nby,
                                         nbx, bd, luma, n_refs=3)
        kw.update(planes1=p1, fields1=f1)
    before = (mc_kernel.blocks_launches, mc_kernel.blocks_field_launches)
    got = mc.mc_blocks_fields(planes, fields, size, nbx, pad, luma, bd, bi,
                              **kw)
    assert (mc_kernel.blocks_launches, mc_kernel.blocks_field_launches) == (
        before[0] + 1, before[1] + 1)
    want = mc.mc_blocks_fields_plain(planes, fields, size, nbx, pad, luma,
                                     bd, bi, **kw)
    jobs = mc.field_jobs(fields, size, nbx, pad, luma)
    table_kw = dict(pair=not luma)
    if bi:
        table_kw.update(planes1=kw["planes1"], jobs1=mc.field_jobs(
            kw["fields1"], size, nbx, pad, luma))
    table = mc_kernel.blocks(planes, jobs, "2d", luma, bd, bi, size, size,
                             **table_kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int16
    assert torch.equal(got, want) and torch.equal(got, table)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", SIZES)
def test_qpel_fields_equal_plain_and_the_origin_table(cuda, s, bd):
    nby, nbx = (5, 7) if s < 64 else (2, 3)
    planes, (ref, _mx, _my), _, pad = planes_and_fields(s + bd, cuda, s, nby,
                                                        nbx, bd, True)
    rng = np.random.RandomState(s)
    nb = nby * nbx
    fields = (ref.long(),) + tuple(
        torch.from_numpy(rng.randint(-90, 91, nb).astype(np.int64)).to(cuda)
        for _ in range(2))
    before = (mc_kernel.qpel_launches, mc_kernel.qpel_field_launches)
    got = mc.mc_qpel_fields(planes, fields, s, nbx, pad, bd)
    assert (mc_kernel.qpel_launches, mc_kernel.qpel_field_launches) == (
        before[0] + 1, before[1] + 1)
    want = mc.mc_qpel_fields_plain(planes, fields, s, nbx, pad, bd)
    table = mc_kernel.qpel(planes, mc.qpel_origins(fields, s, nbx, pad)
                           .to(torch.int32).contiguous(), s, bd)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, table)


@pytest.mark.gpu
def test_new_entries_replay_in_a_cuda_graph(cuda):
    """No host synchronisation inside D, E or the field entries: each
    captures into a CUDA graph and its replay equals the eager call."""
    satd, coarse, int_mx, int_my = on(cuda, *pick_inputs(8, 17, 30))
    sl, lam, cw = scalar(cuda, SQRT_LAM), scalar(cuda, LAM), scalar(cuda, CW)
    classes = bi_classes(9, cuda, 32, 128, 192)
    planes, fields, size, pad = planes_and_fields(4, cuda, 16, 4, 6, 8, True)
    cplanes, cfields, csize, cpad = planes_and_fields(5, cuda, 16, 4, 6, 8,
                                                      False)
    qfields = (fields[0].long(), fields[1].long() // 4,
               fields[2].long() // 4)

    def calls():
        d = kern.qpel_pick(satd, coarse, int_mx, int_my, sl)
        e = kern.bi_pick(classes, lam, cw, 32)
        b = mc_kernel.blocks_fields(planes, fields, size, 6, pad, True, 8,
                                    True, planes1=planes, fields1=fields)
        c = mc_kernel.blocks_fields(cplanes, cfields, csize, 6, cpad, False,
                                    8, False, pair=True)
        q = mc_kernel.qpel_fields(planes, qfields, 16, 6, pad, 8)
        return (*d, *(t for s in sorted(e) for t in e[s]), b, c, q)
    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert_same(out, eager)


@pytest.mark.gpu
def test_entries_refuse_bad_cuda_inputs(cuda):
    """On CUDA tensors each check refuses a bad input with its error and
    launches nothing."""
    satd, coarse, int_mx, int_my = on(cuda, *pick_inputs(1, 3, 5))
    sl = scalar(cuda, SQRT_LAM)
    kern.check_qpel_pick(satd, coarse, int_mx, int_my, sl)
    before = kern.pick_launches
    for bad, err in [((satd.long(), coarse, int_mx, int_my, sl), TypeError),
                     ((satd[:-1], coarse, int_mx, int_my, sl), ValueError),
                     ((satd, coarse, int_mx.int(), int_my, sl), TypeError),
                     ((satd, coarse, int_mx.cpu(), int_my, sl), ValueError),
                     ((satd, coarse, int_mx, int_my, sl.double()),
                      ValueError)]:
        with pytest.raises(err):
            kern.qpel_pick(*bad)
    assert kern.pick_launches == before
    classes = bi_classes(2, cuda, 16, 32, 48, plant=False)
    lam, cw = scalar(cuda, LAM), scalar(cuda, CW)
    kern.check_bi_pick(classes, lam, cw, 16)
    with pytest.raises(ValueError, match="expected"):
        kern.bi_pick(classes, lam, cw, 32)
    leaf0, leaf1, terms = classes[8]
    strided = torch.zeros(2 * terms[0].numel(), dtype=torch.int32,
                          device=cuda)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        kern.bi_pick({**classes, 8: (leaf0, leaf1, (strided,) + terms[1:])},
                     lam, cw, 16)
    planes, fields, size, pad = planes_and_fields(3, cuda, 8, 2, 3, 8, True)
    with pytest.raises(TypeError):
        mc_kernel.blocks_fields(planes, tuple(f.long() for f in fields),
                                size, 3, pad, True, 8, False)
    with pytest.raises(TypeError):
        mc_kernel.qpel_fields(planes, fields, 8, 3, pad, 8)


def _decide(device, p, b_slice, bit_inc):
    h, w = p["org"].shape
    refs = [(k, p["ry"][k], p["rcb"][k], p["rcr"][k]) for k in range(2)]
    return fast_inter.decide_frame_p(
        p["org"], p["org_cb"], p["org_cr"], refs, w, h, 32 + 6 * bit_inc,
        30 + 6 * bit_inc, 30 + 6 * bit_inc, LAM, SQRT_LAM, SQRT_LAM,
        (1.0, 2.0, 5.5), (0.5, 3.5, CW), 4, 2, 64, 64, bit_inc,
        (256 << bit_inc) - 1, refs[::-1] if b_slice else None, device=device)


def _smooth(rng, h, w, top):
    a = rng.rand(h + 8, w + 8)
    for _ in range(3):
        a = (a[:-2, :-2] + a[1:-1, 1:-1] * 2 + a[2:, 2:]) / 4
    a = (a - a.min()) / (a.max() - a.min())
    return np.rint(a[:h, :w] * top).astype(np.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("b_slice", [False, True])
def test_pass_runs_the_picks_and_field_entries(cuda, bit_inc, b_slice):
    """A 192x128 P or B pass on ``cuda`` equals the CPU's, with one
    quarter-pel pick a size class and list, one bi pick a B frame, and
    every MC launch through a field entry (no job table built)."""
    rng = np.random.RandomState(21 + bit_inc)
    top = (256 << bit_inc) - 1
    h, w = 128, 192
    p = dict(org=_smooth(rng, h, w, top), org_cb=_smooth(rng, h // 2, w // 2,
                                                          top),
             org_cr=_smooth(rng, h // 2, w // 2, top), ry=[], rcb=[], rcr=[])
    for _k in range(2):
        dy, dx = rng.randint(-9, 10, 2)
        for key, pl, f in (("ry", p["org"], 1), ("rcb", p["org_cb"], 2),
                           ("rcr", p["org_cr"], 2)):
            q = np.roll(pl, (dy // f, dx // f), (0, 1)).astype(np.int32)
            q += rng.randint(-2, 3, q.shape)
            p[key].append(np.clip(q, 0, top).astype(np.int16))
    lists, classes = 1 + b_slice, len(SIZES)

    def counts():
        return (kern.pick_launches, kern.bi_launches,
                mc_kernel.blocks_launches, mc_kernel.blocks_field_launches,
                mc_kernel.qpel_launches, mc_kernel.qpel_field_launches)
    before = counts()
    got = _decide("cuda", p, b_slice, bit_inc)
    torch.cuda.synchronize()
    d = [a - b for a, b in zip(counts(), before)]
    # a size class: per list luma and the Cb/Cr pair, for B one bi luma
    # and one bi pair
    mc_calls = (2 * lists + 2 * b_slice) * classes
    assert d == [lists * classes, int(b_slice), mc_calls, mc_calls,
                 lists * classes, lists * classes]
    want = _decide("cpu", p, b_slice, bit_inc)
    assert len(got) == len(want) == (14 if b_slice else 10)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
