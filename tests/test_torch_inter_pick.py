"""The P/B decision pass's picks and MV-field MC entries on the CPU:
``encoder.fast_inter.qpel_pick_plain`` and ``bi_pick_plain`` (the plain
forms of kernels D and E of ``csrc/inter_me.cu``) against the JAX
package's lines of the same computation, the field entries' plain forms
(``ops.mc.mc_blocks_fields_plain``, ``mc_qpel_fields_plain``) against the
job-table path they replace, and the bindings' refusals.

The JAX side is ``thevc_tpu/encoder/fast_inter.py`` written out here op
by op over its own helpers (``_mv_pred_median``, ``_golomb_bits``): the
quarter-pel loop of ``_inter_size_pass`` (the predictor at :226, the 49
costs and the first minimum at :280-314) and the bi stage's MV bits and
RD sum (``_bi_size_pass`` :507-526) with the direction (:649-651), run
eagerly so that XLA fuses no multiply-add.  Inputs are seeded numpy: SATD,
coarse fields and integer winners with planted ties and flat costs, MVs
within the range where the reference's float32 ``log2`` bit length is
exact (``test_golomb_bits_exact_up_to_2_15``), and bi inputs with planted
equal rd0, rd1 and bi costs.  Tolerance 0 throughout.

The refusals (``inter_me_kernel.check_qpel_pick``, ``check_bi_pick``,
``mc_kernel.check_fields``, ``check_qpel_fields``) raise before anything
is built, and every entry refuses a CPU tensor.  The kernels themselves
run on the card: ``tests/test_torch_inter_pick_kernel.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from thevc_tpu.encoder import fast_inter as ref
from thevc_tpu_torch.encoder import fast_inter as port
from thevc_tpu_torch.ops import build as _build
from thevc_tpu_torch.ops import inter_me_kernel as kern
from thevc_tpu_torch.ops import mc, mc_kernel

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

LAM, SQRT_LAM, CW = 57.92, 7.61, 1.1
SIZES = port.INTER_SIZES


def pick_inputs(seed: int, nby: int, nbx: int, reach: int = 40,
                satd_top: int = 4000) -> tuple:
    """SATD int32 [nb, 49], the coarse field (dy, dx, ref) int64 [nby,
    nbx] and the integer winner int64 [nb] within 3 of it, numpy."""
    rng = np.random.RandomState(seed)
    nb = nby * nbx
    satd = rng.randint(0, satd_top, (nb, 49)).astype(np.int32)
    c_dy, c_dx = (rng.randint(-reach, reach + 1, (nby, nbx)).astype(np.int64)
                  for _ in range(2))
    c_ref = rng.randint(0, 3, (nby, nbx)).astype(np.int64)
    int_mx = c_dx.reshape(-1) + rng.randint(-3, 4, nb)
    int_my = c_dy.reshape(-1) + rng.randint(-3, 4, nb)
    return satd, (c_dy, c_dx, c_ref), int_mx, int_my


def jax_qpel_pick(satd, coarse, int_mx, int_my, sqrt_lam: float) -> tuple:
    """``thevc_tpu/encoder/fast_inter.py:226`` and ``:280-314`` on the
    same SATD: the median predictor of the coarse field, each
    candidate's bits and cost, the first minimum by a strict < -> (mv_qx,
    mv_qy, ref) numpy."""
    c_dy, c_dx, c_ref = (jnp.asarray(c) for c in coarse)
    mv_px, mv_py = ref._mv_pred_median(c_dx * 4, c_dy * 4)
    pred_x, pred_y = mv_px.reshape(-1), mv_py.reshape(-1)
    int_mx, int_my = jnp.asarray(int_mx), jnp.asarray(int_my)
    satd = jnp.asarray(satd)
    sl = jnp.float32(sqrt_lam)
    best_cost = best_q = None
    for qdy in range(-3, 4):
        for qdx in range(-3, 4):
            code = (qdy + 3) * 7 + (qdx + 3)
            mvqx = int_mx * 4 + qdx
            mvqy = int_my * 4 + qdy
            bits = (ref._golomb_bits(mvqx - pred_x)
                    + ref._golomb_bits(mvqy - pred_y) + 2)
            cost = (satd[:, code].astype(jnp.float32)
                    + sl * bits.astype(jnp.float32))
            if best_cost is None:
                best_cost = cost
                best_q = jnp.full(cost.shape, code, jnp.int32)
            else:
                take = cost < best_cost
                best_cost = jnp.where(take, cost, best_cost)
                best_q = jnp.where(take, code, best_q)
    return (np.asarray(int_mx * 4 + best_q % 7 - 3),
            np.asarray(int_my * 4 + best_q // 7 - 3),
            np.asarray(c_ref).reshape(-1))


def _pick_both(satd, coarse, int_mx, int_my, sqrt_lam: float) -> tuple:
    got = port.qpel_pick_plain(
        torch.from_numpy(satd), tuple(torch.from_numpy(c) for c in coarse),
        torch.from_numpy(int_mx), torch.from_numpy(int_my),
        torch.tensor(sqrt_lam, dtype=torch.float32))
    want = jax_qpel_pick(satd, coarse, int_mx, int_my, sqrt_lam)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    return got


@pytest.mark.parametrize("sqrt_lam", [0.0, 2.0, SQRT_LAM])
@pytest.mark.parametrize("nby,nbx", [(1, 1), (3, 5), (8, 16), (5, 23)])
def test_qpel_pick_plain_equals_jax(nby, nbx, sqrt_lam):
    _pick_both(*pick_inputs(nby * 31 + nbx, nby, nbx), sqrt_lam)


def test_qpel_pick_plain_large_mvs_equal_jax():
    """Coarse MVs up to 3000 full pel: bit lengths of differences up to
    about 2^15, where the reference's float32 log2 is still exact."""
    _pick_both(*pick_inputs(5, 6, 9, reach=3000), SQRT_LAM)


@pytest.mark.parametrize("sqrt_lam", [0.0, SQRT_LAM])
def test_qpel_pick_plain_flat_costs_equal_jax(sqrt_lam):
    """Equal SATDs: at sqrt-lambda 0 every cost ties and candidate 0 (the
    (-3, -3) offset) wins in both."""
    satd, coarse, int_mx, int_my = pick_inputs(7, 4, 6)
    satd[:] = 321
    got = _pick_both(satd, coarse, int_mx, int_my, sqrt_lam)
    if sqrt_lam == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), int_mx * 4 - 3)
        np.testing.assert_array_equal(got[1].numpy(), int_my * 4 - 3)


def test_qpel_pick_plain_planted_ties_equal_jax():
    """At sqrt-lambda 2 two candidates a block share the least cost from
    different SATDs and bits; the first in candidate order wins."""
    nby, nbx = 6, 10
    satd, coarse, int_mx, int_my = pick_inputs(9, nby, nbx)
    base = 100000
    satd += base + 1000
    c_dy, c_dx, _ = (torch.from_numpy(c) for c in coarse)
    px, py = port._mv_pred_median(c_dx * 4, c_dy * 4)
    steps = torch.arange(-3, 4)
    bits = port._mv_bits(px.reshape(-1), py.reshape(-1),
                         torch.from_numpy(int_mx)[:, None] * 4 + steps,
                         torch.from_numpy(int_my)[:, None] * 4 + steps
                         ).reshape(-1, 49).numpy()
    rng = np.random.RandomState(1)
    nb = nby * nbx
    a = rng.randint(0, 49, nb)
    b = (a + 1 + rng.randint(0, 48, nb)) % 49
    rows = np.arange(nb)
    satd[rows, a] = base - 2 * bits[rows, a]
    satd[rows, b] = base - 2 * bits[rows, b]
    got = _pick_both(satd, coarse, int_mx, int_my, 2.0)
    np.testing.assert_array_equal(got[0].numpy(),
                                  int_mx * 4 + np.minimum(a, b) % 7 - 3)


def bi_inputs(seed: int, nby: int, nbx: int, plant: bool) -> tuple:
    """Both lists' leaves (rd float32, mvx, mvy, ref int32 [nby, nbx])
    and the bi terms ([nb]: int32 dist, float32 bits), numpy; with
    ``plant`` rd0, rd1 or both set to the bi cost (``jax_bi_pick``'s) or
    to one value below it."""
    rng = np.random.RandomState(seed)
    nb = nby * nbx

    def leaf():
        return [(rng.rand(nby, nbx) * 1e5).astype(np.float32),
                *(rng.randint(-3000, 3001, (nby, nbx)).astype(np.int32)
                  for _ in range(2)),
                rng.randint(0, 4, (nby, nbx)).astype(np.int32)]
    leaf0, leaf1 = leaf(), leaf()
    terms = [(rng.rand(nb) * 300).astype(np.float32) if k % 2
             else rng.randint(0, 1 << 20, nb).astype(np.int32)
             for k in range(6)]
    if plant:
        inf = np.full((nby, nbx), np.inf, np.float32)
        rd_bi = jax_bi_pick([inf] + leaf0[1:], [inf] + leaf1[1:], terms)[0]
        kind = rng.randint(0, 4, (nby, nbx))
        leaf0[0] = np.where(kind % 2 == 1, rd_bi, leaf0[0]).astype(np.float32)
        leaf1[0] = np.where(kind == 2, rd_bi, leaf1[0]).astype(np.float32)
        leaf1[0] = np.where(kind == 3, leaf0[0], leaf1[0]).astype(np.float32)
        low = (leaf0[0] * 0.5).astype(np.float32)
        leaf0[0] = np.where(kind == 0, low, leaf0[0])
        leaf1[0] = np.where(kind == 0, low, leaf1[0])
    return leaf0, leaf1, terms


def jax_bi_pick(leaf0, leaf1, terms) -> tuple:
    """``thevc_tpu/encoder/fast_inter.py:507-526`` (the MV bits of both
    lists and the bi RD sum) and ``:649-651`` (the direction) -> (rd,
    dir) numpy [nby, nbx]."""
    rd0, rd1 = jnp.asarray(leaf0[0]), jnp.asarray(leaf1[0])
    mvx2 = jnp.stack([jnp.asarray(leaf0[1]), jnp.asarray(leaf1[1])]
                     ).reshape(2, -1)
    mvy2 = jnp.stack([jnp.asarray(leaf0[2]), jnp.asarray(leaf1[2])]
                     ).reshape(2, -1)
    ref2 = jnp.stack([jnp.asarray(leaf0[3]), jnp.asarray(leaf1[3])]
                     ).reshape(2, -1)
    mvbits = (ref._golomb_bits(mvx2) + ref._golomb_bits(mvy2) + 2
              + ref2).astype(jnp.float32).sum(axis=0)
    d_y, b_y, d_cb, b_cb, d_cr, b_cr = (jnp.asarray(t) for t in terms)
    lam, cw = jnp.float32(LAM), jnp.float32(CW)
    rd_bi = (d_y.astype(jnp.float32)
             + cw * (d_cb + d_cr).astype(jnp.float32)
             + lam * (b_y + b_cb + b_cr + mvbits + 5.0)).reshape(rd0.shape)
    rd = jnp.minimum(jnp.minimum(rd0, rd1), rd_bi)
    direc = jnp.where(rd == rd_bi, jnp.int32(3),
                      jnp.where(rd == rd0, jnp.int32(1), jnp.int32(2)))
    return np.asarray(rd), np.asarray(direc)


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("ctu", [16, 32, 64])
def test_bi_pick_plain_equals_jax(ctu, plant):
    h, w = 128, 192
    classes, want = {}, {}
    for s in (s for s in SIZES if s <= ctu):
        leaf0, leaf1, terms = bi_inputs(s + plant, h // s, w // s, plant)
        classes[s] = (tuple(torch.from_numpy(v) for v in leaf0),
                      tuple(torch.from_numpy(v) for v in leaf1),
                      tuple(torch.from_numpy(t) for t in terms))
        want[s] = jax_bi_pick(leaf0, leaf1, terms)
    got = port.bi_pick_plain(classes, torch.tensor(LAM), torch.tensor(CW),
                             ctu)
    assert sorted(got) == sorted(want)
    dirs = set()
    for s, (rd, direc) in got.items():
        assert rd.dtype == torch.float32 and direc.dtype == torch.int32
        np.testing.assert_array_equal(rd.numpy().view(np.int32),
                                      want[s][0].view(np.int32))
        np.testing.assert_array_equal(direc.numpy(), want[s][1])
        dirs |= set(np.unique(want[s][1]).tolist())
    if plant:
        assert dirs == {1, 2, 3}


def planes_and_fields(seed: int, s: int, nby: int, nbx: int, bd: int,
                      luma: bool, n_refs: int = 2, reach: int = 150):
    """Seeded padded planes (luma [P, ...], or Cb then Cr [2P, ...]) and
    (ref, mvx, mvy) int32 [nb] of a grid of blocks of s (luma) or s / 2
    (chroma), MVs that reach past the padded planes."""
    rng = np.random.RandomState(seed)
    size = s if luma else s // 2
    pad = port.PAD_FULL if luma else port.PAD_C
    rows, cols = nby * size + 2 * pad, nbx * size + 2 * pad
    planes = torch.from_numpy(rng.randint(
        0, 1 << bd, (n_refs if luma else 2 * n_refs, rows, cols))
        .astype(np.int16))
    nb = nby * nbx
    fields = (torch.from_numpy(rng.randint(0, n_refs, nb).astype(np.int32)),
              *(torch.from_numpy(rng.randint(-4 * reach, 4 * reach + 1, nb)
                                 .astype(np.int32)) for _ in range(2)))
    return planes, fields, size, pad


def table_path(planes, fields, s: int, nby: int, nbx: int, luma: bool,
               bd: int, bi: bool, planes1=None, fields1=None):
    """The job-table path the field entries replace: the jobs of
    ``fast_inter._luma_jobs`` / ``_chroma_jobs`` on ``_block_grid``, then
    ``mc.mc_blocks``."""
    by, bx = port._block_grid(s, nby, nbx, planes.device)
    if not luma:
        by, bx = by // 2, bx // 2
    make = port._luma_jobs if luma else port._chroma_jobs

    def jobs(f):
        r, mx, my = f
        return make(r, mx, my, by, bx)
    size = s if luma else s // 2
    kw = dict(pair=not luma)
    if fields1 is not None:
        kw.update(planes1=planes1, jobs1=jobs(fields1))
    return mc.mc_blocks(planes, jobs(fields), "2d", luma, bd, bi, size, size,
                        **kw)


@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", SIZES)
def test_blocks_fields_plain_equals_the_job_table_path(s, bd, luma, bi):
    nby, nbx = (3, 4) if s < 64 else (2, 2)
    planes, fields, size, pad = planes_and_fields(s + bd + luma, s, nby,
                                                  nbx, bd, luma)
    kw, p1, f1 = {}, None, None
    if bi:
        p1, f1, _, _ = planes_and_fields(s + bd + luma + 5, s, nby, nbx, bd,
                                         luma, n_refs=3)
        kw = dict(planes1=p1, fields1=f1)
    got = mc.mc_blocks_fields(planes, fields, size, nbx, pad, luma, bd, bi,
                              pair=not luma, **kw)
    want = table_path(planes, fields, s, nby, nbx, luma, bd, bi, p1, f1)
    assert got.dtype == want.dtype == torch.int16
    assert torch.equal(got, want)
    jobs = mc.field_jobs(fields, size, nbx, pad, luma)
    assert jobs.dtype == torch.int32 and jobs.shape == (nby * nbx, 5)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", SIZES)
def test_qpel_fields_plain_equals_the_origin_table_path(s, bd):
    """The field form against the origins ``_qpel_preds`` built before
    (int64 reference and integer MV, int32 block grid)."""
    nby, nbx = (3, 4) if s < 64 else (2, 2)
    planes, (r, _mx, _my), _, pad = planes_and_fields(s * bd, s, nby, nbx,
                                                      bd, True)
    rng = np.random.RandomState(s)
    nb = nby * nbx
    int_mx, int_my = (torch.from_numpy(rng.randint(-90, 91, nb)
                                       .astype(np.int64)) for _ in range(2))
    r = r.long()
    by, bx = port._block_grid(s, nby, nbx, planes.device)
    origins = torch.stack([r, bx + int_mx + (pad - 3),
                           by + int_my + (pad - 3)], dim=1)
    got = mc.mc_qpel_fields(planes, (r, int_mx, int_my), s, nbx, pad, bd)
    assert torch.equal(got, mc.mc_qpel(planes, origins, s, bd))
    assert torch.equal(mc.qpel_origins((r, int_mx, int_my), s, nbx, pad),
                       origins)


def test_dispatchers_take_the_plain_forms_on_the_cpu(monkeypatch):
    """CPU tensors never enter the kernels' bindings; a ``meta`` tensor
    raises ``ValueError``."""
    def boom(*a, **k):
        raise AssertionError("a binding was called for a CPU tensor")
    for name in ("blocks_fields", "qpel_fields"):
        monkeypatch.setattr(mc_kernel, name, boom)
    for name in ("qpel_pick", "bi_pick"):
        monkeypatch.setattr(kern, name, boom)
    satd, coarse, int_mx, int_my = (
        torch.from_numpy(a) if isinstance(a, np.ndarray)
        else tuple(torch.from_numpy(c) for c in a)
        for a in pick_inputs(2, 2, 3))
    sl = torch.tensor(SQRT_LAM)
    port.qpel_pick(satd, coarse, int_mx, int_my, sl)
    leaf0, leaf1, terms = bi_inputs(3, 2, 3, False)
    classes = {8: (tuple(map(torch.from_numpy, leaf0)),
                   tuple(map(torch.from_numpy, leaf1)),
                   tuple(map(torch.from_numpy, terms)))}
    port.bi_pick(classes, torch.tensor(LAM), torch.tensor(CW), 8)
    planes, fields, size, pad = planes_and_fields(1, 8, 2, 3, 8, True)
    mc.mc_blocks_fields(planes, fields, size, 3, pad, True, 8, False)
    mc.mc_qpel_fields(planes, tuple(f.long() for f in fields), 8, 3, pad, 8)
    with pytest.raises(ValueError):
        port.qpel_pick(satd.to("meta"), coarse, int_mx, int_my, sl)
    with pytest.raises(ValueError):
        port.bi_pick(classes, torch.tensor(LAM, device="meta"),
                     torch.tensor(CW), 8)
    with pytest.raises(ValueError):
        mc.mc_blocks_fields(planes.to("meta"), fields, size, 3, pad, True,
                            8, False)
    with pytest.raises(ValueError):
        mc.mc_qpel_fields(planes.to("meta"), fields, 8, 3, pad, 8)


@pytest.fixture
def no_build(monkeypatch):
    """Any build of a kernel library fails the test: the checks raise
    first."""
    def boom(*a, **k):
        raise AssertionError("a kernel library was built")
    monkeypatch.setattr(_build, "load", boom)


def _pick_args():
    satd, coarse, int_mx, int_my = pick_inputs(4, 3, 5)
    return [torch.from_numpy(satd), tuple(torch.from_numpy(c)
                                          for c in coarse),
            torch.from_numpy(int_mx), torch.from_numpy(int_my),
            torch.tensor(SQRT_LAM)]


def test_qpel_pick_refusals(no_build):
    a = _pick_args()
    kern.check_qpel_pick(*a)
    satd, coarse, int_mx, _int_my, sl = a
    cases = [
        (0, satd.long(), TypeError, "dtype"),
        (0, satd[:-1], ValueError, "shape"),
        (0, satd.t().contiguous().t(), ValueError, "contiguous"),
        (1, coarse[:2], ValueError, "dy, dx, ref"),
        (1, (coarse[0].int(),) + coarse[1:], TypeError, "dtype"),
        (1, (coarse[0][:, :-1],) + coarse[1:], ValueError, "shape"),
        (1, (coarse[0][:0],) + coarse[1:], ValueError, "empty"),
        (2, int_mx.int(), TypeError, "dtype"),
        (2, int_mx[:-1], ValueError, "shape"),
        (2, torch.zeros(2 * int_mx.numel(), dtype=torch.int64)[::2],
         ValueError, "contiguous"),
        (4, sl.double(), ValueError, "sqrt_lam"),
        (4, torch.zeros(2), ValueError, "sqrt_lam")]
    for k, bad, err, match in cases:
        b = list(a)
        b[k] = bad
        with pytest.raises(err, match=match):
            kern.check_qpel_pick(*b)
    with pytest.raises(ValueError, match="CUDA"):
        kern.qpel_pick(*a)


def _bi_classes(ctu: int, h: int = 64, w: int = 128):
    out = {}
    for s in (s for s in SIZES if s <= ctu):
        leaf0, leaf1, terms = bi_inputs(s, h // s, w // s, False)
        out[s] = (tuple(map(torch.from_numpy, leaf0)),
                  tuple(map(torch.from_numpy, leaf1)),
                  tuple(map(torch.from_numpy, terms)))
    return out


def test_bi_pick_refusals(no_build):
    lam, cw = torch.tensor(LAM), torch.tensor(CW)
    classes = _bi_classes(32)
    kern.check_bi_pick(classes, lam, cw, 32)
    leaf0, leaf1, terms = classes[16]
    strided = torch.zeros(2 * terms[0].numel(), dtype=torch.int32)[::2]
    cases = [
        ({**_bi_classes(64)}, 32, ValueError, "expected"),      # above CTU
        ({s: v for s, v in classes.items() if s != 16}, 32, ValueError,
         "expected"),                                         # a class gone
        ({**classes, 16: (leaf0[:3], leaf1, terms)}, 32, ValueError,
         "leaf"),
        ({**classes, 16: ((leaf0[0].double(),) + leaf0[1:], leaf1, terms)},
         32, TypeError, "dtype"),
        ({**classes, 16: (leaf0, (leaf1[0],) + tuple(t.long()
                                                      for t in leaf1[1:]),
                          terms)}, 32, TypeError, "dtype"),
        ({**classes, 16: (leaf0, leaf1, (terms[0].float(),) + terms[1:])},
         32, TypeError, "dtype"),
        ({**classes, 16: (leaf0, leaf1, (terms[0][:-1],) + terms[1:])},
         32, ValueError, "shape"),
        ({**classes, 16: (leaf0, leaf1, (strided,) + terms[1:])}, 32,
         ValueError, "contiguous"),
        ({**classes, 16: ((leaf0[0].reshape(-1),) + leaf0[1:], leaf1,
                          terms)}, 32, ValueError, "nby, nbx")]
    for bad, ctu, err, match in cases:
        with pytest.raises(err, match=match):
            kern.check_bi_pick(bad, lam, cw, ctu)
    with pytest.raises(ValueError, match="lam"):
        kern.check_bi_pick(classes, lam.double(), cw, 32)
    with pytest.raises(ValueError, match="cw"):
        kern.check_bi_pick(classes, lam, torch.zeros(3), 32)
    with pytest.raises(ValueError, match="CUDA"):
        kern.bi_pick(classes, lam, cw, 32)


def test_field_entry_refusals(no_build):
    planes, fields, size, pad = planes_and_fields(6, 16, 3, 4, 8, True)
    mc_kernel.check_fields(planes, fields, size, 4, pad, True, 8)
    cplanes, cfields, csize, cpad = planes_and_fields(6, 16, 3, 4, 8, False)
    mc_kernel.check_fields(cplanes, cfields, csize, 4, cpad, False, 8,
                           pair=True)
    strided = torch.zeros(2 * fields[0].numel(), dtype=torch.int32)[::2]
    cases = [
        (dict(fields=(fields[0].long(),) + fields[1:]), TypeError, "dtype"),
        (dict(fields=(fields[0], fields[1][:-1], fields[2])), ValueError,
         "shape"),
        (dict(fields=(strided,) + fields[1:]), ValueError, "contiguous"),
        (dict(fields=fields[:2]), ValueError, "ref, mvx, mvy"),
        (dict(nbx=5), ValueError, "grid"),
        (dict(size=12), ValueError, "block size"),
        (dict(size=4), ValueError, "block size"),
        (dict(bd=7), ValueError, "bit depth"),
        (dict(pad=0), ValueError, "padding"),
        (dict(planes=planes.int()), TypeError, "dtype"),
        (dict(planes=planes[0]), ValueError, "rows, cols"),
        (dict(planes=planes[:1], pair=True), ValueError, "P even"),
        (dict(planes1=planes), ValueError, "planes1 and fields1")]
    base = dict(planes=planes, fields=fields, size=size, nbx=4, pad=pad,
                luma=True, bd=8)
    for change, err, match in cases:
        kw = {**base, **change}
        pos = [kw.pop(k) for k in ("planes", "fields", "size", "nbx", "pad",
                                   "luma", "bd")]
        with pytest.raises(err, match=match):
            mc_kernel.check_fields(*pos, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        mc_kernel.blocks_fields(planes, fields, size, 4, pad, True, 8, False)
    qf = tuple(f.long() for f in fields)
    mc_kernel.check_qpel_fields(planes, qf, 16, 4, pad, 8)
    for bad, err, match in [
            ((planes, fields, 16, 4, pad, 8), TypeError, "dtype"),
            ((planes, qf, 12, 4, pad, 8), ValueError, "block size"),
            ((planes, qf, 16, 5, pad, 8), ValueError, "grid"),
            ((planes, qf, 16, 4, 2, 8), ValueError, "padding"),
            ((planes, qf, 16, 4, pad, 13), ValueError, "bit depth"),
            ((planes[0], qf, 16, 4, pad, 8), ValueError, "rows, cols"),
            ((planes, (qf[0][:-1],) + qf[1:], 16, 4, pad, 8), ValueError,
             "grid")]:
        with pytest.raises(err, match=match):
            mc_kernel.check_qpel_fields(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        mc_kernel.qpel_fields(planes, qf, 16, 4, pad, 8)
