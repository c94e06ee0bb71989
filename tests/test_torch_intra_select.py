"""The intra decision pass's selection steps on the CPU: the plain forms
of the kernels of ``csrc/intra_select.cu`` against the JAX package.

The three kernels' plain forms (``encoder.fast_intra``):
``intra_select_plain`` (the open-loop MPM, mode bits, costs and the top
3 of a luma class), ``intra_pick_plain`` (the RD pick of the top 3 and
the chroma candidates' ids) and ``intra_dp_plain`` (each chroma class's
pick, ``chroma_pick_plain``, then the quadtree DP and the unit maps,
``dp_expand_plain``).  The JAX side runs op by op (not jitted), so that
XLA fuses no multiply-add and every float rounds as in the port:

- ``intra_select_plain`` against ``_mpm_vec`` and ``jax.lax.top_k(-cost,
  3)`` written out over the reference's lines (fast_intra.py:467-492) on
  seeded SATDs with ties planted (a small range of values, so that most
  blocks tie) and SATD-best modes, for a class below the CTU size and
  one at it: modes and bits exact;
- ``_size_pass_impl`` and ``_chroma_pass_impl`` (with the chroma pick)
  against the JAX ones (the unified form) on seeded 64x64 (CTU 32) and
  128x64 (CTU 64, bit increment 2) frames: the JAX coefficient-bit model
  takes XLA's ``log2``, so bits agree within rtol 1e-5, and a pick may
  fall the other way where two candidates' costs are that close; modes
  on at least 99% of blocks, and where the modes agree the dist exact;
  the chroma classes get the same luma best on both sides (the port's);
- ``dp_expand_plain`` against the JAX ``_dp_expand`` on seeded leaves
  (the same picked chroma classes on both sides): intra, P and B, CTU 32
  and 64, frames that are no CTU multiple (1080 and 72 rows' worth of
  crossing and outside blocks) and the NxN gate opened (``max_sig = 4``
  at CTU 64, ``min_tr_log2 = 2``): every map exact;
- ``chroma_pick_plain`` against the reference's pick (fast_intra.py:
  588-600) written out in numpy float32 on seeded candidates with ties:
  exact;
- the bindings' checks (``ops.intra_select_kernel.check_*``) refuse
  dtypes, shapes, sizes, grids and scalars, and every entry a CPU
  tensor, with nothing built; the dispatchers refuse any device but the
  CPU and CUDA;
- ``chip_smoke.select_bound`` counts a 1080p frame's DP bytes (I, P and
  B) each storage once: the luma classes' ids that the chroma classes
  share are not counted again, and a chroma class is read one id a
  block.

The kernels against these plain forms on the card:
``tests/test_torch_intra_select_kernel.py`` (``-m gpu``).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from thevc_tpu.encoder import fast_intra as ref
from thevc_tpu_torch.encoder import fast_intra as fi
from thevc_tpu_torch.ops import build, intra_select_kernel as kern

torch.set_num_threads(1)

SIZES = (4, 8, 16, 32, 64)
BITS3 = (1.0, 2.0, 5.5)
SQRT_LAM, LAM = 7.55, 57.0
CBITS2 = (0.5, 3.5, 1.1)
BIT_RTOL = 1e-5
MODE_AGREE = 0.99


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _satd_with_ties(rng, nb: int) -> tuple:
    """Seeded SATDs [nb, 35] from a small range (ties in most blocks) and
    their first-minimum modes."""
    satd = rng.randint(0, 4, (nb, 35)) * 8 + rng.randint(100, 110, (nb, 1))
    satd[::3] = 120                              # whole rows tied
    return satd.astype(np.int32), satd.argmin(axis=1).astype(np.int32)


def _jax_select(satd, best, s, nby, nbx, ctu):
    """The reference's lines 467-492 over its own ``_mpm_vec``."""
    best_a = jnp.asarray(best).reshape(nby, nbx)
    left = jnp.concatenate(
        [jnp.full((nby, 1), ref.DC_IDX, jnp.int32), best_a[:, :-1]], axis=1)
    above = jnp.concatenate(
        [jnp.full((1, nbx), ref.DC_IDX, jnp.int32), best_a[:-1, :]], axis=0)
    ys = np.arange(nby, dtype=np.int32) * s
    if s < ctu:
        above = jnp.where(jnp.asarray((ys % ctu) != 0)[:, None], above,
                          ref.DC_IDX)
    else:
        above = jnp.full((nby, nbx), ref.DC_IDX, jnp.int32)
    m0, m1, m2 = ref._mpm_vec(left.reshape(-1), above.reshape(-1))
    modes = jnp.arange(35, dtype=jnp.int32)[None, :]
    b0, b12, bo = (jnp.float32(b) for b in BITS3)
    bits_plain = jnp.where(
        modes == m0[:, None], b0,
        jnp.where((modes == m1[:, None]) | (modes == m2[:, None]), b12, bo))
    cost = jnp.asarray(satd).astype(jnp.float32) + bits_plain * jnp.float32(
        SQRT_LAM)
    _, topk = jax.lax.top_k(-cost, 3)
    return (np.asarray(topk),
            np.asarray(jnp.take_along_axis(bits_plain, topk, axis=1)))


@pytest.mark.parametrize("s,ctu", [(4, 32), (8, 64), (16, 32), (32, 32),
                                   (64, 64)])
def test_select_equals_jax_mpm_and_top_k(s, ctu):
    rng = np.random.RandomState(s + ctu)
    nby, nbx = 128 // s + 2, 192 // s + 1
    satd, best = _satd_with_ties(rng, nby * nbx)
    topk, mbits = fi.intra_select_plain(
        torch.from_numpy(satd), torch.from_numpy(best), s, nby, nbx, ctu,
        tuple(_f32(b) for b in BITS3), _f32(SQRT_LAM))
    want_k, want_b = _jax_select(satd, best, s, nby, nbx, ctu)
    assert topk.dtype == torch.int32 and mbits.dtype == torch.float32
    np.testing.assert_array_equal(topk.numpy(), want_k)
    np.testing.assert_array_equal(mbits.numpy().view(np.int32),
                                  want_b.view(np.int32))
    # ties were planted: some blocks' top 3 hold equal costs
    cost = satd[np.arange(len(satd))[:, None], want_k].astype(np.float32) \
        + want_b * np.float32(SQRT_LAM)
    assert (cost[:, :-1] == cost[:, 1:]).any()


def _content(rng, h: int, w: int, bit_inc: int) -> np.ndarray:
    hi = 256 << bit_inc
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
    noise = rng.randint(0, 24, (h, w))
    return ((base + noise) * (1 << bit_inc) % hi).astype(np.int16)


FRAMES = {"64x64": (64, 64, 32, 0, 21), "128x64": (128, 64, 64, 2, 22)}


@pytest.fixture(scope="module")
def planes():
    out = {}
    for name, (w, h, ctu, bit_inc, seed) in FRAMES.items():
        rng = np.random.RandomState(seed)
        y, cb, cr = (_content(rng, h // d, w // d, bit_inc) for d in (1, 2, 2))
        out[name] = [np.ascontiguousarray(p, np.int16)
                     for p in fi._source_planes(y, cb, cr, w, h, ctu)]
    return out


def _classes():
    return [(f, s) for f, v in FRAMES.items() for s in SIZES if s <= v[2]]


def _agree(a, b) -> np.ndarray:
    same = np.asarray(a) == np.asarray(b)
    assert same.mean() >= MODE_AGREE, (same.size - same.sum(), same.size)
    return same


@pytest.mark.parametrize("frame,s", _classes())
def test_size_and_chroma_pass_agree_with_jax(planes, frame, s):
    w, h, ctu, bit_inc, _ = FRAMES[frame]
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    nby, nbx = hp // s, wp // s
    max_val = (256 << bit_inc) - 1
    qp, qp_c = 32 + 6 * bit_inc, 30 + 6 * bit_inc
    py, pcb, pcr = planes[frame]
    luma = fi._size_pass_impl(
        torch.from_numpy(py), s, nby, nbx, torch.tensor(qp, dtype=torch.int32),
        (tuple(_f32(b) for b in BITS3), _f32(SQRT_LAM), _f32(LAM)), bit_inc,
        max_val, ctu)
    want = ref._size_pass_impl(
        jnp.asarray(py.astype(np.int32)), s, nby, nbx, jnp.int32(qp),
        (tuple(jnp.float32(b) for b in BITS3), jnp.float32(SQRT_LAM),
         jnp.float32(LAM)), bit_inc, max_val, ctu, True)
    for k in (0, 3, 4):
        _agree(luma[k].numpy(), want[k])
    same = _agree(luma.mode.numpy(), want[0])
    np.testing.assert_array_equal(luma.dist.numpy()[same],
                                  np.asarray(want[1])[same])
    np.testing.assert_allclose(luma.bits.numpy()[same],
                               np.asarray(want[2])[same], rtol=BIT_RTOL)
    if s == 4:
        return
    # the chroma class, fed the port's luma best on both sides
    lam_w_bits2 = ((_f32(CBITS2[0]), _f32(CBITS2[1])), _f32(LAM),
                   _f32(CBITS2[2]))
    cands = fi._chroma_pass_impl(
        torch.from_numpy(pcb), torch.from_numpy(pcr), s, nby, nbx, luma.cids,
        torch.tensor(qp_c, dtype=torch.int32),
        torch.tensor(qp_c, dtype=torch.int32), bit_inc, max_val)
    cdir, ccost = fi.chroma_pick_plain(cands, lam_w_bits2)
    best = jnp.asarray(luma.mode.numpy())
    wdir, wcost = ref._chroma_pass_impl(
        jnp.asarray(pcb.astype(np.int32)), jnp.asarray(pcr.astype(np.int32)),
        s, nby, nbx, best, best, jnp.int32(qp_c), jnp.int32(qp_c),
        ((jnp.float32(CBITS2[0]), jnp.float32(CBITS2[1])), jnp.float32(LAM),
         jnp.float32(CBITS2[2])), bit_inc, max_val)
    same = _agree(cdir.numpy(), wdir)
    np.testing.assert_allclose(ccost.numpy()[same], np.asarray(wcost)[same],
                               rtol=BIT_RTOL)


def _np_chroma_pick(ids, dist, bits, nb):
    """The reference's pick (fast_intra.py:588-600) in numpy float32, one
    rounding an operation."""
    f = np.float32
    d = (dist[:nb * 5] + dist[nb * 5:]).reshape(nb, 5).astype(f)
    cb = (bits[:nb * 5] + bits[nb * 5:]).reshape(nb, 5)
    mb = np.asarray([CBITS2[1]] * 4 + [CBITS2[0]], f)[None]
    cost = f(CBITS2[2]) * d + f(LAM) * (cb + mb)
    sel = cost.argmin(axis=1)
    vals = np.concatenate([ids[:, :4], np.full((nb, 1), 36, np.int32)], 1)
    return (np.take_along_axis(vals, sel[:, None], 1)[:, 0],
            np.take_along_axis(cost, sel[:, None], 1)[:, 0])


def _cands(rng, nby: int, nbx: int, ties: bool = True) -> tuple:
    """Seeded chroma candidates: ids, dist and bits (numpy), some blocks
    with every candidate tied."""
    nb = nby * nbx
    best = rng.randint(0, 35, nb).astype(np.int32)
    ids = fi._chroma_ids(torch.from_numpy(best)).numpy()
    dist = rng.randint(0, 4000, 2 * nb * 5).astype(np.int32)
    bits = (rng.randint(0, 400, 2 * nb * 5) / 8.0).astype(np.float32)
    if ties:
        for a in (dist, bits):
            v = a.reshape(2, nb, 5)
            v[:, ::4] = v[:, ::4, :1]
        # DM's mode bits are cheaper: tie it through the distortion
        dist.reshape(2, nb, 5)[:, 1::4, 4] += 1
    return ids.reshape(nby, nbx, 5), dist, bits


def test_chroma_pick_equals_reference_pick():
    rng = np.random.RandomState(3)
    nby, nbx = 9, 14
    ids, dist, bits = _cands(rng, nby, nbx)
    lam_w_bits2 = ((_f32(CBITS2[0]), _f32(CBITS2[1])), _f32(LAM),
                   _f32(CBITS2[2]))
    cdir, ccost = fi.chroma_pick_plain(fi.ChromaCands(
        torch.from_numpy(ids), torch.from_numpy(dist),
        torch.from_numpy(bits)), lam_w_bits2)
    wdir, wcost = _np_chroma_pick(ids.reshape(-1, 5), dist, bits, nby * nbx)
    np.testing.assert_array_equal(cdir.numpy().reshape(-1), wdir)
    np.testing.assert_array_equal(ccost.numpy().reshape(-1).view(np.int32),
                                  wcost.view(np.int32))
    assert (wdir == ids.reshape(-1, 5)[:, 0]).any()   # tied: the first


def dp_leaves(seed: int, ctu: int, wp: int, hp: int, kind: str):
    """Seeded DP inputs as numpy arrays: res, picked cres and cres8_nxn,
    and inter leaves (None, P 4-tuples or B 8-tuples)."""
    rng = np.random.RandomState(seed)
    res, cres, inter = {}, {}, {}
    for s in SIZES:
        if s > ctu:
            continue
        n = (hp // s, wp // s)
        # distortion growing faster than the area, so that every depth
        # and the NxN partition win somewhere
        res[s] = (rng.randint(0, 35, n).astype(np.int32),
                  rng.randint(0, 10 * s ** 3, n).astype(np.int32),
                  (rng.rand(*n) * s).astype(np.float32),
                  rng.randint(0, 35, n).astype(np.int32),
                  rng.randint(0, 35, n).astype(np.int32))
        if s < 8:
            continue
        cres[s] = (rng.randint(0, 37, n).astype(np.int32),
                   (rng.rand(*n) * 20 * s * s).astype(np.float32))
        if kind == "I":
            continue
        leaf = [(rng.rand(*n) * 12 * s ** 3).astype(np.float32),
                rng.randint(-40000, 40000, n).astype(np.int32),
                rng.randint(-300, 300, n).astype(np.int32),
                rng.randint(0, 4, n).astype(np.int32)]
        if kind == "B":
            leaf += [rng.randint(1, 4, n).astype(np.int32),
                     rng.randint(-300, 300, n).astype(np.int32),
                     rng.randint(-40000, 40000, n).astype(np.int32),
                     rng.randint(0, 4, n).astype(np.int32)]
        inter[s] = tuple(leaf)
    cres8 = (rng.randint(0, 37, (hp // 8, wp // 8)).astype(np.int32),
             (rng.rand(hp // 8, wp // 8) * 1280).astype(np.float32))
    return res, cres, cres8, (inter if kind != "I" else None)


DP_CASES = [  # kind, ctu, width, height, max_sig, min_tr_log2
    ("I", 64, 200, 136, 3, 2),
    ("I", 32, 96, 72, 3, 2),
    ("I", 64, 128, 64, 4, 2),        # the NxN gate open (no legal SPS)
    ("I", 32, 120, 88, 3, 2),        # ... at CTU 32
    ("P", 64, 200, 136, 3, 2),
    ("P", 32, 96, 72, 2, 3),
    ("B", 64, 128, 72, 4, 2),
    ("B", 32, 96, 80, 3, 2),
]


@pytest.mark.parametrize("kind,ctu,w,h,max_sig,mtl", DP_CASES)
def test_dp_expand_plain_equals_jax(kind, ctu, w, h, max_sig, mtl):
    from thevc_tpu.encoder import fast_inter as ref_inter
    from thevc_tpu_torch.encoder import fast_inter
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    res, cres, cres8, inter = dp_leaves(w + h + ctu, ctu, wp, hp, kind)
    pen = fast_inter._INTRA_PEN_BITS if inter is not None else 0.0
    lam = np.float32(LAM)

    def jx(d):
        return {k: tuple(jnp.asarray(a) for a in v) for k, v in d.items()}

    def th(d):
        return {k: tuple(torch.from_numpy(a) for a in v)
                for k, v in d.items()}
    out_j = np.asarray(ref._dp_expand(
        jx(res), jx(cres), tuple(jnp.asarray(a) for a in cres8), w, h,
        jnp.float32(lam), max_sig, mtl, ctu, wp, hp,
        inter=None if inter is None else jx(inter), intra_pen=pen))
    out_p = fi.dp_expand_plain(
        th(res), th(cres), tuple(torch.from_numpy(a) for a in cres8), w, h,
        torch.tensor(lam), max_sig, mtl, ctu, wp, hp,
        inter=None if inter is None else th(inter), intra_pen=pen)
    token = (out_j, wp, hp)
    if kind == "I":
        want = ref.collect_frame(token)
        got = fi.collect_frame((out_p, wp, hp))
    else:
        want = (ref_inter.collect_frame_p if kind == "P"
                else ref_inter.collect_frame_b)(token)
        got = fast_inter.collect_frame_p((out_p, wp, hp))
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"map {k}")
    # the cases reach what they are for: leaves at several depths, the
    # NxN branch where its gate is open, inter leaves on P and B slices
    assert len(np.unique(got[0])) > 1
    if max_sig == 4:
        assert got[2].any()
    if kind != "I":
        assert got[6].any() and not got[6].all()


# -- the bindings' refusals, nothing built


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(build, "compile_source", refuse)
    monkeypatch.setattr(kern, "build", refuse)


def _select_args(nb=6, s=8, nby=2, nbx=3, ctu=32):
    return [torch.zeros((nb, 35), dtype=torch.int32),
            torch.zeros((nb,), dtype=torch.int32), s, nby, nbx, ctu,
            tuple(_f32(b) for b in BITS3), _f32(SQRT_LAM)]


def _pick_args(s=8, nby=2, nbx=4):
    nb = nby * nbx
    return [torch.zeros((nb, 3), dtype=torch.int32),
            torch.zeros((nb, 3), dtype=torch.float32),
            torch.zeros((nb * 3,), dtype=torch.int32),
            torch.zeros((nb * 3,), dtype=torch.float32), _f32(LAM), s, nby,
            nbx]


@pytest.mark.parametrize("change,match", [
    ({0: torch.zeros((6, 35), dtype=torch.int64)}, "dtype"),
    ({0: torch.zeros((6, 34), dtype=torch.int32)}, "shape"),
    ({1: torch.zeros((7,), dtype=torch.int32)}, "shape"),
    ({0: torch.zeros((35, 6), dtype=torch.int32).t()}, "contiguous"),
    ({2: 12}, "size"),
    ({5: 24}, "CTU"),
    ({2: 64}, "CTU"),
    ({3: 0, 0: torch.zeros((0, 35), dtype=torch.int32),
      1: torch.zeros((0,), dtype=torch.int32)}, "empty"),
    ({7: 7.55}, "0-d float32"),
    ({7: torch.tensor(7.55, dtype=torch.float64)}, "dtype"),
    ({6: (_f32(1.0), _f32(2.0))}, "classes"),
])
def test_check_select_refuses(no_build, change, match):
    a = _select_args()
    for k, v in change.items():
        a[k] = v
    with pytest.raises((ValueError, TypeError), match=match):
        kern.check_select(*a)
    with pytest.raises((ValueError, TypeError)):
        kern.select(*a)


@pytest.mark.parametrize("change,match", [
    ({0: torch.zeros((8, 3), dtype=torch.int64)}, "dtype"),
    ({1: torch.zeros((8, 4), dtype=torch.float32)}, "shape"),
    ({2: torch.zeros((24,), dtype=torch.float32)}, "dtype"),
    ({3: torch.zeros((23,), dtype=torch.float32)}, "shape"),
    ({4: torch.zeros((1,), dtype=torch.float32)}, "shape"),
    ({5: 4, 6: 1, 7: 8}, "even grid"),
    ({5: 6}, "size"),
])
def test_check_pick_refuses(no_build, change, match):
    a = _pick_args()
    for k, v in change.items():
        a[k] = v
    with pytest.raises((ValueError, TypeError), match=match):
        kern.check_pick(*a)
    with pytest.raises((ValueError, TypeError)):
        kern.pick(*a)


def _dp_args(ctu=32, w=96, h=72, kind="P"):
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    res, cres, cres8, inter = dp_leaves(5, ctu, wp, hp, kind)
    lam = _f32(LAM)
    lam_w_bits2 = ((_f32(CBITS2[0]), _f32(CBITS2[1])), lam, _f32(CBITS2[2]))
    rng = np.random.RandomState(6)

    def cands(s):
        ids, dist, bits = _cands(rng, hp // s, wp // s, ties=False)
        return fi.ChromaCands(torch.from_numpy(ids), torch.from_numpy(dist),
                              torch.from_numpy(bits))
    return dict(
        res={s: tuple(torch.from_numpy(a) for a in v) for s, v in res.items()},
        cres={s: cands(s) for s in cres}, cres8_nxn=cands(8), width=w,
        height=h, lam=lam, lam_w_bits2=lam_w_bits2, max_sig=3, min_tr_log2=2, ctu_size=ctu, wp=wp,
        hp=hp, inter=None if inter is None else {
            s: tuple(torch.from_numpy(a) for a in v)
            for s, v in inter.items()}, intra_pen=8.0)


def _bad_dp(name):
    a = _dp_args()
    if name == "ctu":
        a["ctu_size"] = 128
    elif name == "grid":
        a["wp"] = 100
    elif name == "frame":
        a["width"] = 200
    elif name == "depth":
        a["max_sig"] = 5
    elif name == "lam":
        a["lam"] = torch.tensor([57.0])
    elif name == "classes":
        del a["res"][32]
    elif name == "luma dtype":
        r = list(a["res"][16])
        r[2] = r[2].to(torch.float64)
        a["res"][16] = tuple(r)
    elif name == "chroma shape":
        c = a["cres"][8]
        a["cres"][8] = c._replace(dist=c.dist[1:])
    elif name == "ids":
        c = a["cres8_nxn"]
        a["cres8_nxn"] = c._replace(ids=c.ids.reshape(-1, 5))
    elif name == "scalars":
        bits2, clam, _cw = a["lam_w_bits2"]
        a["lam_w_bits2"] = (bits2, clam, torch.tensor([CBITS2[2]]))
    elif name == "inter classes":
        a["inter"][4] = a["inter"][8]
    elif name == "inter fields":
        a["inter"][8] = a["inter"][8][:3]
    elif name == "inter dtype":
        v = list(a["inter"][16])
        v[3] = v[3].to(torch.int64)
        a["inter"][16] = tuple(v)
    return a


DP_REFUSALS = {"ctu": "CTU size", "grid": "grid", "frame": "outside",
               "depth": "out of range", "lam": "shape", "classes": "classes",
               "luma dtype": "dtype", "chroma shape": "shape",
               "ids": "shape", "scalars": "shape",
               "inter classes": "inter classes", "inter fields": "fields",
               "inter dtype": "dtype"}


@pytest.mark.parametrize("name", sorted(DP_REFUSALS))
def test_check_dp_refuses(no_build, name):
    a = _bad_dp(name)
    with pytest.raises((ValueError, TypeError), match=DP_REFUSALS[name]):
        kern.check_dp(**a)
    with pytest.raises((ValueError, TypeError)):
        kern.dp(**a)


def test_checks_pass_good_inputs_and_entries_refuse_cpu(no_build):
    kern.check_select(*_select_args())
    kern.check_pick(*_pick_args())
    kern.check_dp(**_dp_args())
    kern.check_dp(**_dp_args(ctu=64, w=200, h=136, kind="B"))
    kern.check_dp(**_dp_args(ctu=16, w=40, h=24, kind="I"))
    with pytest.raises(ValueError, match="CUDA"):
        kern.select(*_select_args())
    with pytest.raises(ValueError, match="CUDA"):
        kern.pick(*_pick_args())
    with pytest.raises(ValueError, match="CUDA"):
        kern.dp(**_dp_args())


def test_dispatchers_take_cpu_plain_and_refuse_other_devices(no_build):
    a = _select_args()
    topk, mbits = fi.intra_select(*a)
    assert topk.shape == (6, 3) and mbits.dtype == torch.float32
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in a]
    with pytest.raises(ValueError, match="unsupported device"):
        fi.intra_select(*meta)
    p = _pick_args()
    assert len(fi.intra_pick(*p)) == 6
    with pytest.raises(ValueError, match="unsupported device"):
        fi.intra_pick(*[t.to("meta") if isinstance(t, torch.Tensor) else t
                        for t in p])
    d = _dp_args()
    assert fi._dp_expand(**d).shape == (10, d["hp"] // 4, d["wp"] // 4)
    d["lam"] = d["lam"].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fi._dp_expand(**d)


def test_dp_args_layout():
    # the C struct: 15 five-pointer, three-pointer and eight-pointer
    # class records, five scalar pointers, a float, nine ints, the output
    # pointer (8-byte aligned)
    n = 5 * (5 + 3 + 8) + 5
    size = n * 8 + 4 + 9 * 4
    size = -(-size // 8) * 8 + 8
    assert ctypes.sizeof(kern.DpArgs) == size
    assert kern.DpArgs.out.offset == size - 8


@pytest.mark.parametrize("kind", ["I", "P", "B"])
def test_dp_bound_counts_each_storage_once(kind):
    import chip_smoke
    w, h, ctu = 1920, 1080, 64
    a = _dp_args(ctu=ctu, w=w, h=h, kind=kind)
    wp, hp = a["wp"], a["hp"]
    # the luma classes carry the chroma classes' ids, as the pass's do
    res = {s: fi.LumaClass(*v, (a["cres"][s] if s >= 8
                                else a["cres8_nxn"]).ids)
           for s, v in a["res"].items()}
    args = (res, a["cres"], a["cres8_nxn"], w, h, a["lam"],
            a["lam_w_bits2"], a["max_sig"], a["min_tr_log2"], ctu, wp, hp,
            a["inter"], a["intra_pen"])
    planes, unit = {"I": (6, 1), "P": (10, 2), "B": (14, 2)}[kind]
    out = torch.empty((planes, hp // 4, wp // 4),
                      dtype=torch.int8 if unit == 1 else torch.int16)
    blocks = {s: (hp // s) * (wp // s) for s in SIZES}
    assert sum(blocks.values()) == 173910
    fields = {"I": 0, "P": 4, "B": 8}[kind]
    want = (20 * sum(blocks.values())                  # five luma fields
            + 84 * (sum(blocks[s] for s in SIZES[1:]) + blocks[8])
            + 4 * fields * sum(blocks[s] for s in SIZES[1:])
            + planes * unit * blocks[4]                # the maps
            + 4 * 4)                   # lam (the chroma lam), cw, bits
    got = chip_smoke.select_bound("dp", args, out)
    assert got["bytes"] == want
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(
        1000 * want / chip_smoke.HBM_BYTES_S, rel=1e-12)
    if kind == "I":
        assert want == 10644736

