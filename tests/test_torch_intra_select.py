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
- the multi-class select and pick (``intra_select`` and ``intra_pick``
  on CPU tensors: ``intra_select_pass_plain`` and
  ``intra_pick_pass_plain``) on every class's sweep of small frames at
  CTU 16, 32 and 64 and 8 and 10 bits: each class equal to the per-class
  plain forms and the top 3 to the JAX lines (exact), and on SATD rows
  whose costs tie across SATDs and bit classes (sqrt-lambda 2) and whole
  rows equal, against the JAX lines (exact);
- the luma classes of ``_luma_passes`` (the sweeps, one select, the
  TU-RDs, one pick) and ``_chroma_pass_impl`` (with the chroma pick)
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
  dtypes, shapes, a class above the CTU, a missing class, grids, an
  unaligned SATD, an odd 4x4 grid for the pick and scalars, and every
  entry a CPU tensor, with nothing built; the class tables' C layout;
  the dispatchers refuse any device but the CPU and CUDA;
- ``chip_smoke.select_bound`` counts a 1080p pass's select and pick
  bytes (every class, the scalars once) and a frame's DP bytes (I, P and
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
CTU_SIZES = (16, 32, 64)
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


def _jax_select(satd, best, s, nby, nbx, ctu, sqrt_lam=SQRT_LAM):
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
        sqrt_lam)
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


def _same(got, want, what: str = "") -> None:
    """Tensors or tuples of them equal: dtypes, shapes, ints, floats as
    bits."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for k, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{what}[{k}]")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


def _tied_classes(rng, ctu: int, wp: int, hp: int) -> dict:
    """Seeded SATD rows of every class up to ``ctu`` whose costs tie at
    sqrt-lambda 2 (bits * sqrt_lam 2, 4 and 11): SATDs from a base plus
    0, 2, 7 or 9, so that modes of different SATDs and bit classes meet
    at one cost, and every fourth row all equal."""
    out = {}
    for s in SIZES:
        if s > ctu:
            break
        nby, nbx = hp // s, wp // s
        nb = nby * nbx
        satd = rng.choice([0, 2, 7, 9], (nb, 35)) + rng.randint(90, 99,
                                                                (nb, 1))
        satd[::4] = 200
        satd = torch.from_numpy(satd.astype(np.int32))
        out[s] = (satd, satd.argmin(dim=1).to(torch.int32), nby, nbx)
    return out


@pytest.mark.parametrize("ctu", CTU_SIZES)
def test_select_pass_orders_ties_as_top_k(ctu):
    rng = np.random.RandomState(ctu)
    classes = _tied_classes(rng, ctu, 128, 64)
    bits3 = tuple(_f32(b) for b in BITS3)
    top = fi.intra_select(classes, ctu, bits3, _f32(2.0))
    assert sorted(top) == sorted(classes)
    crossed = 0
    for s, (satd, best, nby, nbx) in classes.items():
        want_k, want_b = _jax_select(satd.numpy(), best.numpy(), s, nby, nbx,
                                     ctu, sqrt_lam=2.0)
        np.testing.assert_array_equal(top[s][0].numpy(), want_k)
        np.testing.assert_array_equal(top[s][1].numpy().view(np.int32),
                                      want_b.view(np.int32))
        _same(top[s], fi.intra_select_plain(satd, best, s, nby, nbx, ctu,
                                            bits3, _f32(2.0)), f"s={s}")
        # equal costs of different bit classes among the top 3
        rows = np.arange(len(want_k))[:, None]
        cost = satd.numpy()[rows, want_k] + want_b * 2.0
        tie = (cost[:, :-1] == cost[:, 1:]) & (want_b[:, :-1]
                                                != want_b[:, 1:])
        crossed += int(tie.sum())
    assert crossed > 0


PASS_CASES = [(ctu, bit_inc) for ctu in CTU_SIZES for bit_inc in (0, 2)]


@pytest.mark.parametrize("ctu,bit_inc", PASS_CASES)
def test_select_and_pick_passes_equal_per_class_and_jax(ctu, bit_inc):
    w, h = 64, 48
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    rng = np.random.RandomState(ctu + bit_inc)
    y, cb, cr = (_content(rng, h // d, w // d, bit_inc) for d in (1, 2, 2))
    py = np.ascontiguousarray(fi._source_planes(y, cb, cr, w, h, ctu)[0],
                              np.int16)
    pt = torch.from_numpy(py)
    max_val = (256 << bit_inc) - 1
    qp = torch.tensor(32 + 6 * bit_inc, dtype=torch.int32)
    bits3 = tuple(_f32(b) for b in BITS3)
    sl, lam = _f32(SQRT_LAM), _f32(LAM)
    grids = {s: (hp // s, wp // s) for s in SIZES if s <= ctu}
    classes = {s: (*fi.intra_sweep(pt, s, *g, bit_inc, max_val), *g)
               for s, g in grids.items()}
    top = fi.intra_select(classes, ctu, bits3, sl)
    cands = {}
    for s, (satd, best, nby, nbx) in classes.items():
        _same(top[s], fi.intra_select_plain(satd, best, s, nby, nbx, ctu,
                                            bits3, sl), f"select s={s}")
        want_k, want_b = _jax_select(satd.numpy(), best.numpy(), s, nby, nbx,
                                     ctu)
        np.testing.assert_array_equal(top[s][0].numpy(), want_k)
        np.testing.assert_array_equal(top[s][1].numpy().view(np.int32),
                                      want_b.view(np.int32))
        dist_k, cbits_k = fi.tu_rd_modes((pt,), s, nby, nbx, top[s][0],
                                         (qp,), bit_inc, max_val, luma=True)
        cands[s] = (*top[s], dist_k, cbits_k, nby, nbx)
    picked = fi.intra_pick(cands, ctu, lam)
    luma = fi._luma_passes(pt, wp, hp, qp, (bits3, sl, lam), bit_inc,
                           max_val, ctu)
    for s, a in cands.items():
        _same(picked[s], fi.intra_pick_plain(*a[:4], lam, s, *a[4:]),
              f"pick s={s}")
        _same(tuple(v.reshape(-1) for v in luma[s][:5]), picked[s][:5],
              f"pass s={s}")
        _luma_agrees_with_jax(luma[s], py, s, wp, hp, ctu, bit_inc)


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


def _luma_passes(py, w, h, ctu, bit_inc, sqrt_lam=SQRT_LAM):
    """The port's luma classes of a frame (``fi._luma_passes``: the
    sweeps, one select over every class, the TU-RDs, one pick)."""
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    qp = 32 + 6 * bit_inc
    return fi._luma_passes(
        torch.from_numpy(py), wp, hp, torch.tensor(qp, dtype=torch.int32),
        (tuple(_f32(b) for b in BITS3), _f32(sqrt_lam), _f32(LAM)),
        bit_inc, (256 << bit_inc) - 1, ctu)


def _luma_agrees_with_jax(luma, py, s, wp, hp, ctu, bit_inc,
                          sqrt_lam=SQRT_LAM):
    """One class of ``_luma_passes`` against the JAX ``_size_pass_impl``:
    the modes on at least 99% of the blocks, the dist exact and the bits
    within rtol 1e-5 where the best modes agree."""
    qp = 32 + 6 * bit_inc
    want = ref._size_pass_impl(
        jnp.asarray(py.astype(np.int32)), s, hp // s, wp // s, jnp.int32(qp),
        (tuple(jnp.float32(b) for b in BITS3), jnp.float32(sqrt_lam),
         jnp.float32(LAM)), bit_inc, (256 << bit_inc) - 1, ctu, True)
    for k in (0, 3, 4):
        _agree(luma[k].numpy(), want[k])
    same = _agree(luma.mode.numpy(), want[0])
    np.testing.assert_array_equal(luma.dist.numpy()[same],
                                  np.asarray(want[1])[same])
    np.testing.assert_allclose(luma.bits.numpy()[same],
                               np.asarray(want[2])[same], rtol=BIT_RTOL)


@pytest.fixture(scope="module")
def luma_passes(planes):
    return {name: _luma_passes(planes[name][0], w, h, ctu, bit_inc)
            for name, (w, h, ctu, bit_inc, _) in FRAMES.items()}


@pytest.mark.parametrize("frame,s", _classes())
def test_size_and_chroma_pass_agree_with_jax(planes, luma_passes, frame, s):
    w, h, ctu, bit_inc, _ = FRAMES[frame]
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    nby, nbx = hp // s, wp // s
    max_val = (256 << bit_inc) - 1
    qp_c = 30 + 6 * bit_inc
    py, pcb, pcr = planes[frame]
    luma = luma_passes[frame][s]
    _luma_agrees_with_jax(luma, py, s, wp, hp, ctu, bit_inc)
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


GRIDS16 = {4: (4, 6), 8: (2, 3), 16: (1, 2)}      # a 96x64 frame, CTU 16


def _select_args(ctu=16, grids=GRIDS16):
    classes = {s: (torch.zeros((nby * nbx, 35), dtype=torch.int32),
                   torch.zeros((nby * nbx,), dtype=torch.int32), nby, nbx)
               for s, (nby, nbx) in grids.items()}
    return [classes, ctu, tuple(_f32(b) for b in BITS3), _f32(SQRT_LAM)]


def _pick_args(ctu=16, grids=GRIDS16):
    def cls(nby, nbx):
        nb = nby * nbx
        return (torch.zeros((nb, 3), dtype=torch.int32),
                torch.zeros((nb, 3), dtype=torch.float32),
                torch.zeros((nb * 3,), dtype=torch.int32),
                torch.zeros((nb * 3,), dtype=torch.float32), nby, nbx)
    return [{s: cls(*g) for s, g in grids.items()}, ctu, _f32(LAM)]


def _change_class(a, s, k, t):
    """Argument list ``a`` with field k of class s replaced by t."""
    v = list(a[0][s])
    v[k] = t
    a[0] = {**a[0], s: tuple(v)}
    return a


def _bad_select(name):
    a = _select_args()
    if name == "satd dtype":
        return _change_class(a, 8, 0, torch.zeros((6, 35), dtype=torch.int64))
    if name == "satd shape":
        return _change_class(a, 8, 0, torch.zeros((6, 34), dtype=torch.int32))
    if name == "best shape":
        return _change_class(a, 16, 1, torch.zeros((3,), dtype=torch.int32))
    if name == "contiguous":
        return _change_class(a, 4, 0, torch.zeros((35, 24),
                                                  dtype=torch.int32).t())
    if name == "aligned":
        # one row in: 140 bytes past a 16-byte boundary
        return _change_class(a, 8, 0, torch.zeros(
            (7, 35), dtype=torch.int32)[1:])
    if name == "above the CTU":
        a[0][32] = (torch.zeros((1, 35), dtype=torch.int32),
                    torch.zeros((1,), dtype=torch.int32), 1, 1)
        return a
    if name == "missing class":
        del a[0][8]
        return a
    if name == "CTU":
        a[1] = 24
        return a
    if name == "empty grid":
        a[0][16] = (torch.zeros((0, 35), dtype=torch.int32),
                    torch.zeros((0,), dtype=torch.int32), 0, 2)
        return a
    if name == "scalar type":
        a[3] = 7.55
        return a
    if name == "scalar dtype":
        a[3] = torch.tensor(7.55, dtype=torch.float64)
        return a
    if name == "bit classes":
        a[2] = (_f32(1.0), _f32(2.0))
        return a
    raise KeyError(name)


SELECT_REFUSALS = {"satd dtype": "dtype", "satd shape": "shape",
                   "best shape": "shape", "contiguous": "contiguous",
                   "aligned": "aligned", "above the CTU": "above the CTU",
                   "missing class": "classes", "CTU": "CTU size",
                   "empty grid": "empty", "scalar type": "0-d float32",
                   "scalar dtype": "dtype", "bit classes": "classes"}


@pytest.mark.parametrize("name", sorted(SELECT_REFUSALS))
def test_check_select_refuses(no_build, name):
    a = _bad_select(name)
    with pytest.raises((ValueError, TypeError),
                       match=SELECT_REFUSALS[name]):
        kern.check_select(*a)
    with pytest.raises((ValueError, TypeError)):
        kern.select(*a)


def _bad_pick(name):
    a = _pick_args()
    if name == "topk dtype":
        return _change_class(a, 8, 0, torch.zeros((6, 3), dtype=torch.int64))
    if name == "mbits shape":
        return _change_class(a, 4, 1, torch.zeros((24, 4),
                                                  dtype=torch.float32))
    if name == "dist dtype":
        return _change_class(a, 16, 2, torch.zeros((6,), dtype=torch.float32))
    if name == "cbits shape":
        return _change_class(a, 8, 3, torch.zeros((17,), dtype=torch.float32))
    if name == "lam shape":
        a[2] = torch.zeros((1,), dtype=torch.float32)
        return a
    if name == "odd 4x4 grid":
        return _pick_args(grids={4: (3, 4), 8: (2, 2), 16: (1, 1)})
    if name == "above the CTU":
        return _pick_args(ctu=16, grids={**GRIDS16, 32: (1, 1)})
    if name == "missing class":
        return _pick_args(ctu=32, grids=GRIDS16)
    raise KeyError(name)


PICK_REFUSALS = {"topk dtype": "dtype", "mbits shape": "shape",
                 "dist dtype": "dtype", "cbits shape": "shape",
                 "lam shape": "shape", "odd 4x4 grid": "even grid",
                 "above the CTU": "above the CTU",
                 "missing class": "classes"}


@pytest.mark.parametrize("name", sorted(PICK_REFUSALS))
def test_check_pick_refuses(no_build, name):
    a = _bad_pick(name)
    with pytest.raises((ValueError, TypeError), match=PICK_REFUSALS[name]):
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
    grids64 = {s: (272 // s, 480 // s) for s in SIZES}
    kern.check_select(*_select_args(64, grids64))
    kern.check_pick(*_pick_args(64, grids64))
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
    top = fi.intra_select(*a)
    assert sorted(top) == [4, 8, 16]
    assert top[4][0].shape == (24, 3) and top[4][1].dtype == torch.float32
    meta = _select_args()
    meta[0] = {s: (v[0].to("meta"), v[1].to("meta"), *v[2:])
               for s, v in meta[0].items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fi.intra_select(*meta)
    p = _pick_args()
    picked = fi.intra_pick(*p)
    assert sorted(picked) == [4, 8, 16] and len(picked[8]) == 6
    assert picked[4][5].shape == (6, 5) and picked[8][5].shape == (6, 5)
    p[0] = {s: (*(t.to("meta") for t in v[:4]), *v[4:])
            for s, v in p[0].items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fi.intra_pick(*p)
    d = _dp_args()
    assert fi._dp_expand(**d).shape == (10, d["hp"] // 4, d["wp"] // 4)
    d["lam"] = d["lam"].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fi._dp_expand(**d)


def test_select_and_pick_args_layout():
    # the C structs: a select class is four pointers and four ints, a
    # pick class ten pointers and four ints
    assert ctypes.sizeof(kern.SelectArgs) == 5 * 48 + 4 * 8 + 2 * 4
    assert kern.SelectArgs.classes.offset == 5 * 48 + 4 * 8
    assert ctypes.sizeof(kern.PickArgs) == -(-(5 * 96 + 8 + 4) // 8) * 8
    assert kern.PickArgs.lam.offset == 5 * 96


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



@pytest.mark.parametrize("name", ["select", "pick"])
def test_select_and_pick_bounds_count_each_storage_once(name):
    import chip_smoke
    grids = {s: (1088 // s, 1920 // s) for s in SIZES}
    blocks = {s: nby * nbx for s, (nby, nbx) in grids.items()}
    nb = sum(blocks.values())
    if name == "select":
        args = _select_args(64, grids)
        out = fi.intra_select(*args)
        # SATD rows and best in, top 3 and their bits out; 4 scalars
        want = nb * (35 * 4 + 4 + 3 * 4 + 3 * 4) + 4 * 4
    else:
        args = _pick_args(64, grids)
        out = fi.intra_pick(*args)
        # the top 3, their bits, dist and bits in; five fields and the
        # chroma ids out (the 4x4 class's a quarter); lambda
        want = (nb * (4 * 3 * 4 + 5 * 4) + 20 * (nb - blocks[4])
                + 20 * blocks[4] // 4 + 4)
    got = chip_smoke.select_bound(name, args, out)
    assert got["bytes"] == want
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(
        1000 * want / chip_smoke.HBM_BYTES_S, rel=1e-12)
