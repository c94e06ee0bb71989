"""The P/B decision pass's motion-search kernels (``csrc/inter_me.cu``:
the coarse search, the integer refinement and the merge/skip model)
against their plain forms (``encoder/fast_inter.py``), and their
bindings' refusals.

The refusals run here (``ops.inter_me_kernel.check_*`` raise before
anything is built, and every entry refuses a CPU tensor), and so does
the build's naming of a library by its source and included headers.  The rest is
marked ``gpu``: each test asks the ``cuda`` fixture for the card and
skips without one.  On the card each kernel equals its plain form run
on the same CUDA tensors, tolerance 0 (floats bit for bit): 8 and 10
bits, every size class, P (one reference) and B-like lists (two and
three), search ranges 16, 32 and 64, partial coarse tiles, coarse
fields and winners that reach past the picture into the padding, flat
planes with a zero lambda (every candidate ties), the 10-bit 64x64 SSE
that wraps in int32; ties planted across the coarse kernel's split of
the work (references, dy items, dx runs; 1 and 16 references), search
ranges 0, 1 and 16, pooled planes that are not whole tiles; merge grids
whose blocks do not fill the last team or CTA, and winners whose left,
above and zero candidates coincide (out-of-grid zeros too); the
entries' refusals of CUDA tensors; a whole P and B decision pass on
``cuda`` equals the CPU's, through one coarse launch a list and one
refinement and one merge launch a size class and list; and each entry
replays in a CUDA graph.  Run on the GPU machine with
``python -m pytest tests/test_torch_inter_me_kernel.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from thevc_tpu_torch.encoder import fast_inter
from thevc_tpu_torch.ops import inter_me_kernel as kern

SIZES = fast_inter.INTER_SIZES
LAM, SQRT_LAM, CW = 57.92, 7.61, 1.1


@pytest.fixture
def cuda():
    # decided here, not at import: the test workers must all collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _smooth(rng, h, w, top):
    a = rng.rand(h + 8, w + 8)
    for _ in range(3):
        a = (a[:-2, :-2] + a[1:-1, 1:-1] * 2 + a[2:, 2:]) / 4
    a = (a - a.min()) / (a.max() - a.min())
    return np.rint(a[:h, :w] * top).astype(np.int16)


def make_planes(seed: int, h: int, w: int, n_refs: int, bit_inc: int,
                flat: bool = False) -> dict:
    """Seeded source planes and padded reference stacks (the references
    the source shifted by up to 9 samples plus noise), numpy int16."""
    rng = np.random.RandomState(seed)
    top = (256 << bit_inc) - 1
    if flat:
        y = np.full((h, w), top // 3, np.int16)
        cb = cr = np.full((h // 2, w // 2), top // 2, np.int16)
        refs = [(y, cb, cr)] * n_refs
    else:
        y = _smooth(rng, h, w, top)
        cb = _smooth(rng, h // 2, w // 2, top)
        cr = _smooth(rng, h // 2, w // 2, top)
        refs = []
        for _ in range(n_refs):
            dy, dx = rng.randint(-9, 10, 2)
            refs.append(tuple(np.clip(np.roll(p, (dy // k, dx // k), (0, 1))
                                      .astype(np.int32)
                                      + rng.randint(-3 << bit_inc,
                                                    4 << bit_inc, p.shape),
                                      0, top).astype(np.int16)
                              for p, k in ((y, 1), (cb, 2), (cr, 2))))
    pad = fast_inter.PAD_FULL
    pad_c = fast_inter.PAD_C
    return dict(
        org=y, org_cb=cb, org_cr=cr, top=top, bit_inc=bit_inc,
        ry=np.stack([np.pad(r[0], pad, mode="edge") for r in refs]),
        rc=np.stack([np.pad(r[c], pad_c, mode="edge")
                     for c in (1, 2) for r in refs]))


def on(dev, p: dict) -> dict:
    return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
            else v for k, v in p.items()}


def scalar(dev, v: float) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=dev)


def quarter(p: dict, rng_q: int) -> tuple:
    """The pooled source and each reference's pooled band, as the pass
    makes them (``_avgpool``, ``_RefEntry.quarter``)."""
    h, w = p["org"].shape
    pad = fast_inter.PAD_FULL
    org_q = fast_inter._avgpool(p["org"].to(torch.int32), 4).to(torch.int16)
    bands = [fast_inter._avgpool(r[pad - 4 * rng_q:pad + h + 4 * rng_q,
                                   pad - 4 * rng_q:pad + w + 4 * rng_q]
                                 .to(torch.int32), 4).to(torch.int16)
             for r in p["ry"]]
    return org_q.contiguous(), [b.contiguous() for b in bands]


def random_coarse(rng, dev, nby, nbx, n_refs, reach=64):
    """A coarse field: full-pel MVs, multiples of 4 within +-reach."""
    c = [4 * rng.randint(-reach // 4, reach // 4 + 1, (nby, nbx)),
         4 * rng.randint(-reach // 4, reach // 4 + 1, (nby, nbx)),
         rng.randint(0, n_refs, (nby, nbx))]
    return tuple(torch.from_numpy(v.astype(np.int64)).to(dev) for v in c)


def random_merge_inputs(rng, dev, p, s, n_refs, spread=260):
    """Winners (quarter pel within +-spread, a third sharing their left
    neighbour's MV) and transform-RD estimates of one size class."""
    h, w = p["org"].shape
    nby, nbx = h // s, w // s
    nb = nby * nbx
    mvx = rng.randint(-spread, spread + 1, nb)
    mvy = rng.randint(-spread, spread + 1, nb)
    same = rng.rand(nb) < 1 / 3
    same[::nbx] = False
    for k in np.flatnonzero(same):
        mvx[k], mvy[k] = mvx[k - 1], mvy[k - 1]
    refv = rng.randint(0, n_refs, nb)
    scale = s * s * (p["top"] // 4) ** 2 // 16
    rd_terms = (rng.randint(0, scale + 1, nb).astype(np.int32),
                (rng.rand(nb) * 200).astype(np.float32),
                rng.randint(0, scale // 4 + 1, nb).astype(np.int32),
                (rng.rand(nb) * 50).astype(np.float32),
                rng.randint(0, scale // 4 + 1, nb).astype(np.int32),
                (rng.rand(nb) * 50).astype(np.float32))
    winner = tuple(v.astype(np.int32) for v in (mvx, mvy, refv))
    return (tuple(torch.from_numpy(v).to(dev) for v in rd_terms),
            tuple(torch.from_numpy(v).to(dev) for v in winner))


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), int((a.long() - b.long()).abs().max())


def sizes_of(ctu):
    return tuple(s for s in SIZES if s <= ctu)


# ---- refusals (no card) -----------------------------------------------


def _coarse_inputs(rng_q=4, n_refs=2, hq=16, wq=32, dtype=torch.int16):
    org = torch.zeros((hq, wq), dtype=dtype)
    refs = [torch.zeros((hq + 2 * rng_q, wq + 2 * rng_q), dtype=dtype)
            for _ in range(n_refs)]
    return org, refs, rng_q, torch.tensor(np.float32(1.0)), SIZES


def test_coarse_refusals():
    kern.check_coarse(*_coarse_inputs())
    with pytest.raises(ValueError, match="search range 68"):
        kern.check_coarse(*_coarse_inputs(rng_q=17))
    with pytest.raises(TypeError, match="dtype"):
        kern.check_coarse(*_coarse_inputs(dtype=torch.int32))
    with pytest.raises(ValueError, match="references"):
        kern.check_coarse(*_coarse_inputs(n_refs=17))
    with pytest.raises(ValueError, match="references"):
        kern.check_coarse(*_coarse_inputs(n_refs=0))
    org, refs, rng_q, sl, _ = _coarse_inputs()
    with pytest.raises(ValueError, match="prefix"):
        kern.check_coarse(org, refs, rng_q, sl, (16, 32))
    with pytest.raises(ValueError, match="grid of 64"):
        kern.check_coarse(*_coarse_inputs(hq=8))
    with pytest.raises(ValueError, match="shape"):
        kern.check_coarse(org, [refs[0][1:]], rng_q, sl, SIZES)
    with pytest.raises(ValueError, match="contiguous"):
        kern.check_coarse(org.t().contiguous().t(), refs, rng_q, sl,
                          (8, 16, 32))
    with pytest.raises(ValueError, match="sqrt_lam"):
        kern.check_coarse(org, refs, rng_q, torch.tensor(1.0,
                                                         dtype=torch.float64),
                          SIZES)
    # the entry refuses a CPU tensor before building anything
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern.coarse_search(org, refs, rng_q, sl, SIZES)


def _refine_inputs(s=16, dtype=torch.int16, cdtype=torch.int64):
    org = torch.zeros((64, 128), dtype=dtype)
    refs = torch.zeros((2, 64 + 160, 128 + 160), dtype=torch.int16)
    nby, nbx = 64 // s, 128 // s
    coarse = tuple(torch.zeros((nby, nbx), dtype=cdtype) for _ in range(3))
    return org, refs, coarse, s, nby, nbx, torch.tensor(np.float32(1)), 0


def test_refine_refusals():
    kern.check_refine(*_refine_inputs())
    with pytest.raises(ValueError, match="size 12"):
        kern.check_refine(*_refine_inputs(s=12))
    with pytest.raises(TypeError, match="dtype"):
        kern.check_refine(*_refine_inputs(dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        kern.check_refine(*_refine_inputs(cdtype=torch.int32))
    a = list(_refine_inputs())
    a[-1] = 5
    with pytest.raises(ValueError, match="bit increment"):
        kern.check_refine(*a)
    a = list(_refine_inputs())
    a[4] = 5                              # 5 block rows of 16 > 64 rows
    with pytest.raises(ValueError, match="smaller"):
        kern.check_refine(*a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern.int_refine(*_refine_inputs(), fast_inter.PAD_FULL)


def _merge_inputs(s=16, n_refs=2, dtype=torch.int16, mv_dtype=torch.int32,
                  n_c=None):
    nby, nbx = 64 // s, 128 // s
    nb = nby * nbx
    orgs = (torch.zeros((64, 128), dtype=dtype),
            torch.zeros((32, 64), dtype=dtype),
            torch.zeros((32, 64), dtype=dtype))
    ry = torch.zeros((n_refs, 224, 288), dtype=torch.int16)
    rc = torch.zeros((n_c or 2 * n_refs, 120, 152), dtype=torch.int16)
    rd_terms = tuple(torch.zeros(nb, dtype=torch.float32 if k % 2
                                 else torch.int32) for k in range(6))
    winner = tuple(torch.zeros(nb, dtype=mv_dtype) for _ in range(3))
    one = torch.tensor(np.float32(1))
    return orgs, ry, rc, s, nby, nbx, rd_terms, winner, one, one, 0


def test_merge_refusals():
    kern.check_merge(*_merge_inputs())
    with pytest.raises(TypeError, match="dtype"):
        kern.check_merge(*_merge_inputs(dtype=torch.uint8))
    with pytest.raises(TypeError, match="dtype"):
        kern.check_merge(*_merge_inputs(mv_dtype=torch.int64))
    with pytest.raises(ValueError, match="Cb, then Cr"):
        kern.check_merge(*_merge_inputs(n_c=3))
    a = list(_merge_inputs())
    a[6] = a[6][:5]
    with pytest.raises(ValueError, match="rd_terms"):
        kern.check_merge(*a)
    a = list(_merge_inputs())
    a[6] = (a[6][1],) + a[6][1:]        # float dist
    with pytest.raises(TypeError, match="dtype"):
        kern.check_merge(*a)
    a = list(_merge_inputs())
    a[-1] = -1
    with pytest.raises(ValueError, match="bit increment"):
        kern.check_merge(*a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kern.merge_model(*_merge_inputs(), fast_inter.PAD_FULL,
                         fast_inter.PAD_C)


def test_pass_refuses_search_range_above_64():
    """The pass refuses a search range past the reference padding, which
    is the coarse kernel's band too (64)."""
    y = np.zeros((64, 64), np.int16)
    c = np.zeros((32, 32), np.int16)
    with pytest.raises(ValueError, match="search range 68"):
        fast_inter.decide_frame_p(
            y, c, c, [(0, y, c, c)], 64, 64, 32, 30, 30, LAM, SQRT_LAM,
            SQRT_LAM, (1.0, 2.0, 5.5), (0.5, 3.5, 1.1), 4, 2, 68, 64,
            device="cpu")


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and the ``csrc/`` headers it
    includes, so an edited header rebuilds every library that includes
    it; the MC and motion-search sources share the interpolation's."""
    from thevc_tpu_torch.ops import build
    assert [p.name for p in build.sources("mc")] == ["mc.cu",
                                                      "mc_common.cuh"]
    assert [p.name for p in build.sources("inter_me")] == [
        "inter_me.cu", "mc_common.cuh"]
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build.library_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert build.library_path("k") != before


def test_coarse_outputs_lay_the_classes_out_in_one_buffer():
    """The coarse entry's outputs: one int64 buffer, class after class,
    each class's (dy, dx, ref) planes [3, hq * 4 / s, wq * 4 / s] where
    the kernel writes them (3 * the blocks of the classes before)."""
    hq, wq = 48, 80
    for sizes in (SIZES, (8, 16, 32), (8,)):
        outs = kern.coarse_outputs(hq, wq, sizes, torch.device("cpu"))
        assert tuple(outs) == sizes
        base = outs[sizes[0]].data_ptr()
        at = 0
        for s in sizes:
            o = outs[s]
            assert o.dtype == torch.int64 and o.is_contiguous()
            assert tuple(o.shape) == (3, hq * 4 // s, wq * 4 // s)
            assert o.data_ptr() == base + 8 * at
            at += 3 * (hq * 4 // s) * (wq * 4 // s)
        assert outs[sizes[0]].untyped_storage().nbytes() == 8 * at


def test_merge_check_raises_at_the_first_bad_input():
    """The merge entry's checks run once, in order, and the first input
    that fails names itself: with rd_terms short and the winner of the
    wrong dtype, rd_terms; with the winner alone bad, the winner; good
    inputs pass."""
    a = _merge_inputs()
    kern.check_merge(*a)
    b = list(a)
    b[7] = tuple(t.long() for t in a[7])
    with pytest.raises(TypeError, match="mvx has dtype"):
        kern.check_merge(*b)
    b[6] = a[6][:5]
    with pytest.raises(ValueError, match="rd_terms"):
        kern.check_merge(*b)


def periodic_bands(seed: int, hq: int, wq: int, rng_q: int, n_refs: int,
                   planted: dict) -> tuple:
    """A pooled source that repeats every (10, 14) samples and its
    references' pooled bands: reference r of ``planted`` repeats it at
    phase (py, px), so that its offsets (rng + py + 10 a, rng + px + 14 b)
    cost a SAD of 0 (at +-py, +-px the MV bits tie too); the others are
    noise.  numpy int16."""
    rng = np.random.RandomState(seed)
    f = rng.randint(0, 1024, (10, 14))
    y, x = np.mgrid[0:hq, 0:wq]
    org = f[y % 10, x % 14].astype(np.int16)
    by, bx = np.mgrid[0:hq + 2 * rng_q, 0:wq + 2 * rng_q]
    bands = []
    for r in range(n_refs):
        if r in planted:
            py, px = planted[r]
            bands.append(f[(by - rng_q - py) % 10, (bx - rng_q - px) % 14]
                         .astype(np.int16))
        else:
            bands.append(rng.randint(0, 1024, by.shape).astype(np.int16))
    return org, bands


# ---- on the card ------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("search", [16, 32, 64])
@pytest.mark.parametrize("n_refs", [1, 2, 3])
def test_coarse_search_equals_plain(cuda, bit_inc, search, n_refs):
    p = on(cuda, make_planes(search + n_refs, 128, 192, n_refs, bit_inc))
    rng_q = search // 4
    org_q, bands = quarter(p, rng_q)
    sl = scalar(cuda, SQRT_LAM)
    before = kern.coarse_launches
    got = kern.coarse_search(org_q, bands, rng_q, sl, SIZES)
    assert kern.coarse_launches == before + 1
    want = fast_inter.coarse_fields_plain(org_q, bands, rng_q,
                                          *org_q.shape, sl, 64)
    torch.cuda.synchronize()
    for s in SIZES:
        assert_same(got[s], want[s])


@pytest.mark.gpu
@pytest.mark.parametrize("ctu,h,w", [(32, 96, 160), (16, 48, 80),
                                     (64, 64, 128)])
def test_coarse_search_partial_tiles_and_ctus(cuda, ctu, h, w):
    """Pooled sources that are not a whole number of 16x16 tiles, and
    the classes up to a CTU of 16 or 32."""
    p = on(cuda, make_planes(ctu, h, w, 2, 0))
    org_q, bands = quarter(p, 8)
    sl = scalar(cuda, SQRT_LAM)
    got = fast_inter._coarse_fields(org_q, bands, 8, *org_q.shape, sl, ctu)
    want = fast_inter.coarse_fields_plain(org_q, bands, 8, *org_q.shape,
                                          sl, ctu)
    torch.cuda.synchronize()
    assert sorted(got) == list(sizes_of(ctu))
    for s in got:
        assert_same(got[s], want[s])


@pytest.mark.gpu
def test_coarse_search_flat_ties_take_the_first_offset(cuda):
    p = on(cuda, make_planes(0, 64, 128, 2, 0, flat=True))
    org_q, bands = quarter(p, 16)
    sl = scalar(cuda, 0.0)
    got = kern.coarse_search(org_q, bands, 16, sl, SIZES)
    want = fast_inter.coarse_fields_plain(org_q, bands, 16, *org_q.shape,
                                          sl, 64)
    for s in SIZES:
        assert_same(got[s], want[s])
        dy, dx, r = got[s]
        assert (dy == -64).all() and (dx == -64).all() and (r == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("sqrt_lam", [0.0, SQRT_LAM])
@pytest.mark.parametrize("n_refs", [1, 2, 16])
def test_coarse_search_planted_ties(cuda, sqrt_lam, n_refs):
    """Offsets of equal cost in different dy items (slots), dx runs (of
    12) and references: the least (cost, code) wins, as the plain form's
    first minimum.  With a zero lambda every planted offset ties, across
    references too; with a lambda the four at (+-5, +-7) tie on their
    bits, the first (-5, -7) wins."""
    rng_q = 16
    planted = {0: (5, 7)} if n_refs == 1 else {
        n_refs // 2 - 1: (5, 7), n_refs - 1: (-5, 7)}
    org, bands = periodic_bands(n_refs, 48, 64, rng_q, n_refs, planted)
    org_q = torch.from_numpy(org).to(cuda)
    bands = [torch.from_numpy(b).to(cuda) for b in bands]
    sl = scalar(cuda, sqrt_lam)
    got = kern.coarse_search(org_q, bands, rng_q, sl, SIZES)
    want = fast_inter.coarse_fields_plain(org_q, bands, rng_q, 48, 64, sl,
                                          64)
    torch.cuda.synchronize()
    first = min(planted)
    for s in SIZES:
        assert_same(got[s], want[s])
        dy, dx, r = got[s]
        assert (r == first).all()
        if sqrt_lam:
            assert (dy == -20).all() and (dx == -28).all()
        else:
            assert (dy == -4 * 15).all() and (dx == -28).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rng_q", [0, 1, 16])
@pytest.mark.parametrize("n_refs", [1, 16])
def test_coarse_search_ranges_and_references(cuda, rng_q, n_refs):
    """Search ranges 0 (one offset), 4 and 64 full pel, 1 and 16
    references (eight pairs of bands through shared memory)."""
    p = on(cuda, make_planes(rng_q + n_refs, 64, 128, n_refs, 0))
    org_q, bands = quarter(p, rng_q)
    sl = scalar(cuda, SQRT_LAM)
    got = kern.coarse_search(org_q, bands, rng_q, sl, SIZES)
    want = fast_inter.coarse_fields_plain(org_q, bands, rng_q,
                                          *org_q.shape, sl, 64)
    torch.cuda.synchronize()
    for s in SIZES:
        assert_same(got[s], want[s])


@pytest.mark.gpu
@pytest.mark.parametrize("ctu,hq,wq", [(32, 8, 24), (32, 40, 56),
                                       (16, 12, 20), (16, 4, 36)])
def test_coarse_search_ragged_pooled_planes(cuda, ctu, hq, wq):
    """Pooled planes that are not whole 16x16 tiles: the last tile row
    and column hold cells outside the picture, whose blocks are never
    written."""
    rng = np.random.RandomState(hq * wq)
    rng_q = 16
    org_q = torch.from_numpy(rng.randint(0, 256, (hq, wq))
                             .astype(np.int16)).to(cuda)
    bands = [torch.from_numpy(rng.randint(0, 256, (hq + 2 * rng_q,
                                                   wq + 2 * rng_q))
                              .astype(np.int16)).to(cuda) for _ in range(2)]
    sl = scalar(cuda, SQRT_LAM)
    got = fast_inter._coarse_fields(org_q, bands, rng_q, hq, wq, sl, ctu)
    want = fast_inter.coarse_fields_plain(org_q, bands, rng_q, hq, wq, sl,
                                          ctu)
    torch.cuda.synchronize()
    assert sorted(got) == list(sizes_of(ctu))
    for s in got:
        assert_same(got[s], want[s])


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("s", SIZES)
def test_int_refine_equals_plain(cuda, bit_inc, s):
    """From the coarse kernel's own field and from random fields that
    reach the padding's edge, P and B-like lists."""
    for n_refs in (1, 2):
        p = on(cuda, make_planes(s + n_refs, 128, 192, n_refs, bit_inc))
        nby, nbx = 128 // s, 192 // s
        sl = scalar(cuda, SQRT_LAM)
        org_q, bands = quarter(p, 16)
        fields = [kern.coarse_search(org_q, bands, 16, sl, SIZES)[s],
                  random_coarse(np.random.RandomState(s), cuda, nby, nbx,
                                n_refs)]
        for coarse in fields:
            got = kern.int_refine(p["org"], p["ry"], coarse, s, nby, nbx,
                                  sl, bit_inc, fast_inter.PAD_FULL)
            want = fast_inter.int_refine_plain(p["org"], p["ry"], coarse, s,
                                               nby, nbx, sl, bit_inc)
            torch.cuda.synchronize()
            assert_same(got, want)


@pytest.mark.gpu
def test_int_refine_flat_ties_take_the_first_candidate(cuda):
    p = on(cuda, make_planes(0, 64, 128, 2, 0, flat=True))
    s = 16
    coarse = random_coarse(np.random.RandomState(2), cuda, 4, 8, 2)
    sl = scalar(cuda, 0.0)
    got = kern.int_refine(p["org"], p["ry"], coarse, s, 4, 8, sl, 0,
                          fast_inter.PAD_FULL)
    assert_same(got, fast_inter.int_refine_plain(p["org"], p["ry"], coarse,
                                                 s, 4, 8, sl, 0))
    assert torch.equal(got[0], coarse[1].reshape(-1) - 3)
    assert torch.equal(got[1], coarse[0].reshape(-1) - 3)


def _refine_both(cuda, org, ry, coarse, s, nby, nbx, sqrt_lam, bit_inc):
    """The kernel and the plain form on the same CUDA tensors, held equal
    at tolerance 0; returns the kernel's (int_mx, int_my)."""
    sl = scalar(cuda, sqrt_lam)
    got = kern.int_refine(org, ry, coarse, s, nby, nbx, sl, bit_inc,
                          fast_inter.PAD_FULL)
    want = fast_inter.int_refine_plain(org, ry, coarse, s, nby, nbx, sl,
                                       bit_inc)
    torch.cuda.synchronize()
    assert_same(got, want)
    return got


def _zero_coarse(cuda, nby, nbx):
    z = torch.zeros((nby, nbx), dtype=torch.int64, device=cuda)
    return z, z.clone(), z.clone()


# (period in rows, period in columns, planted MV (dy, dx), the first
# minimum with sqrt_lam 0, and with the real one): a reference that
# repeats with the period gives every candidate a period from the planted
# one the same window.  (4, 4): (+-2, +-2) tie, slots (1, 1), (1, 5),
# (5, 1), (5, 5), with equal MV bits too; (4, 7): dy -2 and +2 tie, other
# lanes at every s; (7, 2): dx -3, -1, 1, 3 tie, bits split them into -1
# and +1 (lanes 2l, 2l + 1 apart at s >= 32, one lane below)
PLANTED = [((4, 4), (-2, -2), (-2, -2), (-2, -2)),
           ((4, 7), (-2, 1), (-2, 1), (-2, 1)),
           ((7, 2), (1, -1), (1, -3), (1, -1))]


@pytest.mark.gpu
@pytest.mark.parametrize("real_lam", [False, True], ids=["lam0", "lam"])
@pytest.mark.parametrize("planted", range(len(PLANTED)))
@pytest.mark.parametrize("s", SIZES)
def test_int_refine_planted_ties_across_lanes(cuda, s, planted, real_lam):
    """Equal-cost candidates that the reduction leaves on different lanes
    (and, for (7, 2) below s = 32, on one lane): the first in (dy, dx)
    raster order wins, as the plain form's ``argmin``.  The coarse field
    is zero, so the predictor is zero and MV bits are symmetric."""
    (per_y, per_x), (my, mx), first0, first = PLANTED[planted]
    rng = np.random.RandomState(40 + s + planted)
    nby, nbx = 256 // s // 2, 384 // s // 2
    h, w = nby * s, nbx * s
    pad = fast_inter.PAD_FULL
    g = rng.randint(0, 256, (per_y, per_x))
    ys = np.arange(h + 2 * pad)[:, None]
    xs = np.arange(w + 2 * pad)[None, :]
    ry = g[ys % per_y, xs % per_x].astype(np.int16)[None]
    # org(y, x) = the reference at (y + my, x + mx)
    org = g[(np.arange(h)[:, None] + pad + my) % per_y,
            (np.arange(w)[None, :] + pad + mx) % per_x].astype(np.int16)
    org, ry = torch.from_numpy(org).to(cuda), torch.from_numpy(ry).to(cuda)
    got = _refine_both(cuda, org, ry, _zero_coarse(cuda, nby, nbx), s, nby,
                       nbx, SQRT_LAM if real_lam else 0.0, 0)
    dy, dx = first if real_lam else first0
    assert (got[0] == dx).all() and (got[1] == dy).all()


@pytest.mark.gpu
@pytest.mark.parametrize("src_top", [True, False], ids=["src4095", "src0"])
@pytest.mark.parametrize("s", SIZES)
def test_int_refine_extreme_samples_at_12_bits(cuda, s, src_top):
    """bit_inc 4: a source of 4095 against windows of 0 with a sparse
    4095 (and the reverse), so that an s = 64 block's SAD reaches
    16,773,120 and the candidates differ by multiples of 4095."""
    top, bit_inc = 4095, 4
    rng = np.random.RandomState(70 + s)
    nby, nbx = 128 // s, 192 // s
    h, w = nby * s, nbx * s
    pad = fast_inter.PAD_FULL
    org = np.full((h, w), top if src_top else 0, np.int16)
    sparse = rng.rand(1, h + 2 * pad, w + 2 * pad) < 0.02
    ry = np.where(sparse, top, 0) if src_top else np.where(sparse, 0, top)
    org = torch.from_numpy(org).to(cuda)
    ry = torch.from_numpy(ry.astype(np.int16)).to(cuda)
    for sl in (0.0, SQRT_LAM):
        coarse = random_coarse(np.random.RandomState(s), cuda, nby, nbx, 1)
        _refine_both(cuda, org, ry, coarse, s, nby, nbx, sl, bit_inc)
    # every candidate of the uniform reverse plane ties: the first wins
    flat = torch.full((1, h + 2 * pad, w + 2 * pad), 0 if src_top else top,
                      dtype=torch.int16, device=cuda)
    coarse = random_coarse(np.random.RandomState(s), cuda, nby, nbx, 1)
    got = _refine_both(cuda, org, flat, coarse, s, nby, nbx, 0.0, bit_inc)
    assert torch.equal(got[0], coarse[1].reshape(-1) - 3)
    assert torch.equal(got[1], coarse[0].reshape(-1) - 3)


@pytest.mark.gpu
@pytest.mark.parametrize("s,nby,nbx", [(8, 5, 7), (16, 3, 5), (32, 3, 3),
                                       (64, 1, 3)])
def test_int_refine_ragged_grids(cuda, s, nby, nbx):
    """Grids whose blocks do not fill the last CTA (32, 16 and 4 blocks a
    CTA below s = 64), on planes 5 rows and 3 columns larger than the
    grid: the source's rows are not 16-byte aligned and the references'
    width is odd, so that rows start on either half of a word."""
    for bit_inc in (0, 2):
        p = on(cuda, make_planes(80 + s, nby * s + 5, nbx * s + 3, 2,
                                 bit_inc))
        coarse = random_coarse(np.random.RandomState(s + bit_inc), cuda,
                               nby, nbx, 2)
        for sl in (0.0, SQRT_LAM):
            _refine_both(cuda, p["org"], p["ry"], coarse, s, nby, nbx, sl,
                         bit_inc)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("s", SIZES)
def test_int_refine_windows_past_the_plane(cuda, s, offset):
    """Coarse MVs that take windows past the padded plane's edges (the
    clamped reads) and onto the last columns and rows of the unclamped
    ones; with ``offset`` the reference stack starts one sample into its
    storage, so that no row is word aligned as allocated."""
    nby, nbx = 128 // s, 192 // s
    p = on(cuda, make_planes(90 + s, nby * s, nbx * s, 2, 2))
    ry = p["ry"]
    if offset:
        flat = torch.zeros(ry.numel() + 1, dtype=torch.int16, device=cuda)
        flat[1:] = ry.reshape(-1)
        ry = flat[1:].view(ry.shape)
        assert ry.is_contiguous() and ry.data_ptr() % 4 == 2
    pad, kw = fast_inter.PAD_FULL, s + 6
    rows, cols = ry.shape[1], ry.shape[2]
    rng = np.random.RandomState(s)
    by = (np.arange(nby) * s)[:, None]
    bx = (np.arange(nbx) * s)[None, :]
    # window origins: past each edge, and each side of the word and
    # plane limits of the unclamped reads
    x_at = np.array([-kw, -3, -1, 0, 1, 2, cols - kw - 3, cols - kw - 2,
                     cols - kw - 1, cols - kw, cols - 2])
    y_at = np.array([-kw, -1, 0, 1, rows - kw - 1, rows - kw, rows - kw + 1,
                     rows - 2])
    x0 = x_at[rng.randint(0, len(x_at), (nby, nbx))]
    y0 = y_at[rng.randint(0, len(y_at), (nby, nbx))]
    c_dx = torch.from_numpy((x0 - bx - pad + 3).astype(np.int64)).to(cuda)
    c_dy = torch.from_numpy((y0 - by - pad + 3).astype(np.int64)).to(cuda)
    c_ref = torch.from_numpy(rng.randint(0, 2, (nby, nbx))).to(cuda)
    for sl in (0.0, SQRT_LAM):
        _refine_both(cuda, p["org"], ry, (c_dy, c_dx, c_ref), s, nby, nbx,
                     sl, 2)


def _merge_both(cuda, p, s, rd_terms, winner, lam, cw):
    h, w = p["org"].shape
    args = (p["org"], p["org_cb"], p["org_cr"], p["ry"], p["rc"], s,
            h // s, w // s, rd_terms, winner, scalar(cuda, lam),
            scalar(cuda, cw), p["bit_inc"])
    got = fast_inter.merge_model(*args)
    want = fast_inter.merge_model_plain(*args)
    torch.cuda.synchronize()
    assert_same(got, want)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("n_refs", [1, 2])
def test_merge_model_equals_plain(cuda, bit_inc, s, n_refs):
    """Winners up to 65 samples away (neighbours' windows in the
    padding), some blocks taking skip."""
    p = on(cuda, make_planes(3 * s + n_refs, 128, 192, n_refs, bit_inc))
    rd_terms, winner = random_merge_inputs(np.random.RandomState(s), cuda,
                                           p, s, n_refs)
    before = kern.merge_launches
    _merge_both(cuda, p, s, rd_terms, winner, LAM, CW)
    assert kern.merge_launches == before + 1


@pytest.mark.gpu
def test_merge_model_flat_ties_take_the_left_candidate(cuda):
    p = on(cuda, make_planes(0, 64, 128, 2, 0, flat=True))
    s = 16
    rd_terms, winner = random_merge_inputs(np.random.RandomState(3), cuda,
                                           p, s, 2)
    got = _merge_both(cuda, p, s, rd_terms, winner, 0.0, CW)
    left = torch.cat([torch.zeros((4, 1), dtype=torch.int32, device=cuda),
                      winner[0].reshape(4, 8)[:, :-1]], 1)
    assert torch.equal(got[1], left)


@pytest.mark.gpu
def test_merge_model_10bit_64_sse_wraps(cuda):
    p = make_planes(0, 64, 128, 2, 2, flat=True)
    p["org"] = np.zeros_like(p["org"])
    p["ry"] = np.full_like(p["ry"], 1023)
    p = on(cuda, p)
    rd_terms, winner = random_merge_inputs(np.random.RandomState(4), cuda,
                                           p, 64, 2)
    _merge_both(cuda, p, 64, rd_terms, winner, LAM, CW)


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,w", [(8, 40, 56), (16, 48, 80),
                                   (32, 96, 160), (64, 64, 192)])
def test_merge_model_ragged_grids(cuda, s, h, w):
    """Block counts that do not fill the last team or CTA: 35 blocks of 8
    (16 a CTA, 4 a warp), 15 of 16 (4 a CTA), 15 of 32 (2 a CTA), 3 of
    64."""
    p = on(cuda, make_planes(s + h, h, w, 2, 0))
    rd_terms, winner = random_merge_inputs(np.random.RandomState(h), cuda,
                                           p, s, 2)
    before = kern.merge_launches
    _merge_both(cuda, p, s, rd_terms, winner, LAM, CW)
    assert kern.merge_launches == before + 1


def coinciding_winners(rng, nby: int, nbx: int, n_refs: int) -> tuple:
    """Winners drawn from four MVs, the zero MV with reference 0 among
    them, so that a block's left, above and zero candidates often share
    MV and reference, in every combination (out-of-grid ones are zero;
    blocks 0 and 1 take the zero MV, so that block 1's three coincide).
    numpy int32 (mvx, mvy, ref) [nby * nbx]."""
    pick = rng.randint(0, 4, nby * nbx)
    pick[:2] = 0
    return tuple(np.array(v)[pick].astype(np.int32)
                 for v in ([0, 0, 9, -6], [0, 0, -3, 5],
                           [0, min(1, n_refs - 1), 0, n_refs - 1]))


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("s", SIZES)
def test_merge_model_coinciding_candidates(cuda, bit_inc, s):
    """Left, above and zero candidates equal in every combination (each
    distinct one predicted once, its SSE reused): kernel == plain."""
    p = on(cuda, make_planes(7 * s + bit_inc, 128, 192, 2, bit_inc))
    nby, nbx = 128 // s, 192 // s
    rd_terms, _ = random_merge_inputs(np.random.RandomState(s), cuda, p, s,
                                      2)
    winner = tuple(torch.from_numpy(v).to(cuda) for v in coinciding_winners(
        np.random.RandomState(s + 1), nby, nbx, 2))
    got = _merge_both(cuda, p, s, rd_terms, winner, LAM, CW)
    # block 1's candidates and winner are all the zero MV
    assert int(got[1].reshape(-1)[1]) == int(got[2].reshape(-1)[1]) == 0


@pytest.mark.gpu
def test_merge_refusals_on_the_card(cuda):
    """On CUDA tensors the checks take good inputs and refuse each bad
    one with its own error."""
    a = [tuple(t.to(cuda) for t in v) if isinstance(v, tuple)
         else v.to(cuda) if isinstance(v, torch.Tensor) else v
         for v in _merge_inputs()]
    kern.check_merge(*a)
    d0 = a[6][0]
    strided = torch.zeros(2 * d0.numel(), dtype=torch.int32,
                          device=cuda)[::2]
    cases = [(6, (d0.to(torch.int64),) + a[6][1:], TypeError, "dtype"),
             (6, (d0[:-1],) + a[6][1:], ValueError, "shape"),
             (6, (strided,) + a[6][1:], ValueError, "contiguous"),
             (6, (d0.cpu(),) + a[6][1:], ValueError, "is on cpu"),
             (6, a[6][:5], ValueError, "rd_terms"),
             (7, a[7][:2] + (strided,), ValueError, "contiguous"),
             (7, a[7][:2] + (d0[:-1],), ValueError, "shape"),
             (0, (a[0][0].to(torch.int32),) + a[0][1:], TypeError, "dtype"),
             (0, (a[0][0][:, :64],) + a[0][1:], ValueError, "contiguous"),
             (0, (a[0][0][:32],) + a[0][1:], ValueError, "smaller"),
             (2, a[2][:3], ValueError, "Cb, then Cr"),
             (8, a[8].double(), ValueError, "lam"),
             (10, 5, ValueError, "bit increment"),
             (3, 12, ValueError, "size 12")]
    for k, bad, err, match in cases:
        b = list(a)
        b[k] = bad
        with pytest.raises(err, match=match):
            kern.check_merge(*b)


@pytest.mark.gpu
def test_entries_replay_in_a_cuda_graph(cuda):
    """No host synchronisation inside an entry: each captures into a
    CUDA graph and its replay equals the eager call."""
    p = on(cuda, make_planes(9, 64, 128, 2, 0))
    s, nby, nbx = 16, 4, 8
    sl, lam, cw = scalar(cuda, SQRT_LAM), scalar(cuda, LAM), scalar(cuda, CW)
    org_q, bands = quarter(p, 16)
    rd_terms, winner = random_merge_inputs(np.random.RandomState(5), cuda,
                                           p, s, 2)

    def calls():
        c = kern.coarse_search(org_q, bands, 16, sl, SIZES)
        r = kern.int_refine(p["org"], p["ry"], c[s], s, nby, nbx, sl, 0,
                            fast_inter.PAD_FULL)
        m = kern.merge_model((p["org"], p["org_cb"], p["org_cr"]), p["ry"],
                             p["rc"], s, nby, nbx, rd_terms, winner, lam, cw,
                             0, fast_inter.PAD_FULL, fast_inter.PAD_C)
        return (*c[s], *r, *m)
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


def _decide(device, p, refs1, bit_inc):
    h, w = p["org"].shape
    refs = [(k, p["ry_host"][k], p["cb_host"][k], p["cr_host"][k])
            for k in range(2)]
    return fast_inter.decide_frame_p(
        p["org"], p["org_cb"], p["org_cr"], refs, w, h, 32 + 6 * bit_inc,
        30 + 6 * bit_inc, 30 + 6 * bit_inc, LAM, SQRT_LAM, SQRT_LAM,
        (1.0, 2.0, 5.5), (0.5, 3.5, CW), 4, 2, 64, 64, bit_inc,
        (256 << bit_inc) - 1, refs[::-1] if refs1 else None, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("b_slice", [False, True])
def test_decision_pass_on_cuda_equals_cpu(cuda, bit_inc, b_slice):
    """A 192x128 P or B decision pass on ``cuda`` (the kernels) gives the
    CPU's maps (the plain forms), with one coarse launch a list and one
    refinement and one merge launch a size class and list."""
    rng = np.random.RandomState(11 + bit_inc)
    top = (256 << bit_inc) - 1
    h, w = 128, 192
    y = _smooth(rng, h, w, top)
    cb, cr = _smooth(rng, h // 2, w // 2, top), _smooth(rng, h // 2, w // 2,
                                                        top)
    p = dict(org=y, org_cb=cb, org_cr=cr, ry_host=[], cb_host=[],
             cr_host=[])
    for k in range(2):
        dy, dx = rng.randint(-9, 10, 2)
        for key, pl, f in (("ry_host", y, 1), ("cb_host", cb, 2),
                           ("cr_host", cr, 2)):
            q = np.roll(pl, (dy // f, dx // f), (0, 1)).astype(np.int32)
            q += rng.randint(-2, 3, q.shape)
            p[key].append(np.clip(q, 0, top).astype(np.int16))
    lists = 2 if b_slice else 1
    counts = (kern.coarse_launches, kern.refine_launches,
              kern.merge_launches)
    got = _decide("cuda", p, b_slice, bit_inc)
    launched = (kern.coarse_launches - counts[0],
                kern.refine_launches - counts[1],
                kern.merge_launches - counts[2])
    assert launched == (lists, 4 * lists, 4 * lists)
    want = _decide("cpu", p, b_slice, bit_inc)
    assert len(got) == len(want) == (14 if b_slice else 10)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
