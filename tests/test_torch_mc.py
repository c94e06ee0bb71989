"""The port's motion-compensation interpolation (``thevc_tpu_torch.ops.mc``)
against the JAX package's ``ops/jx_mc.py`` (CPU JAX) and the numpy
``ops/interp.py``, with tolerance 0 (integer codec math).

Every filter case (copy, hor, ver, 2d) runs for luma and chroma, uni and
bi, at bit depths 8 and 10, over the PU sizes an HEVC stream makes
(square, AMP, and the 2-sample chroma of 4x8 / 8x4 luma PUs), with mixed
phases in one batch, a batch of one and a ragged batch.  The device
window gather is held against slices of ``Picture.padded()``, including
MVs that ``clip_mv`` clamps.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from thevc_tpu.decoder.mv import clip_mv
from thevc_tpu.decoder.refpic import Picture
from thevc_tpu.ops import interp, jx_mc
from thevc_tpu_torch.decoder import inter as port_inter
from thevc_tpu_torch.ops import mc

# (luma, out_h, out_w)
SIZES = [(True, 8, 8), (True, 16, 16), (True, 64, 64), (True, 4, 16),
         (True, 16, 4), (False, 4, 2), (False, 2, 4), (False, 32, 32)]
MARGIN = 80                  # a 64x64 CTU's Picture margin (ctu + 16)


def _phases(rng, case, luma, n):
    """Per-PU (frac_x, frac_y) of one case, mixed across the batch."""
    top = 4 if luma else 8
    fx = rng.randint(1, top, n) if case in ("hor", "2d") else np.zeros(n)
    fy = rng.randint(1, top, n) if case in ("ver", "2d") else np.zeros(n)
    return fx.astype(np.int32), fy.astype(np.int32)


def _oracle(plane, luma, x, y, mvx, mvy, h, w, bd, bi):
    """interp.mc_luma / mc_chroma on the padded plane, one PU."""
    fn = interp.mc_luma if luma else interp.mc_chroma
    m = MARGIN if luma else MARGIN // 2
    return fn(plane, m, x, y, mvx, mvy, w, h, bd, bi)


def _windows(plane, luma, xs, ys, mvxs, mvys, case, h, w):
    """Slices of the padded plane that ``precompute_device`` stacks."""
    m, bits, half = (MARGIN, 2, 4) if luma else (MARGIN // 2, 3, 2)
    rows, cols = mc.window_shape(case, luma, h, w)
    out = []
    for x, y, mvx, mvy in zip(xs, ys, mvxs, mvys):
        x0 = m + x + (mvx >> bits) - (half - 1) * (case in ("hor", "2d"))
        y0 = m + y + (mvy >> bits) - (half - 1) * (case in ("ver", "2d"))
        out.append(plane[y0:y0 + rows, x0:x0 + cols])
    return np.stack(out).astype(np.int16)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("case", mc.CASES)
def test_mc_batch_equals_jax_and_numpy(case, luma, bi, bd):
    rng = np.random.RandomState(
        mc.CASES.index(case) + 4 * luma + 8 * bi + 16 * bd)
    bits = 2 if luma else 3
    # the padded plane of a 64x64 luma / 32x32 chroma picture
    size, m = (64, MARGIN) if luma else (32, MARGIN // 2)
    for is_luma, h, w in SIZES:
        if is_luma != luma:
            continue
        plane = rng.randint(0, 1 << bd, (size + 2 * m,
                                         size + 2 * m)).astype(np.int16)
        for n in (1, 37):
            fx, fy = _phases(rng, case, luma, n)
            span = size - max(h, w)
            xs = rng.randint(0, span + 1, n)
            ys = rng.randint(0, span + 1, n)
            mvx = (rng.randint(-4, 5, n) << bits) + fx
            mvy = (rng.randint(-4, 5, n) << bits) + fy
            win = _windows(plane, luma, xs, ys, mvx, mvy, case, h, w)
            got = mc.mc_batch(torch.from_numpy(win), torch.from_numpy(fx),
                              torch.from_numpy(fy), case, luma, bd, bi, h, w)
            assert got.dtype == torch.int16
            assert tuple(got.shape) == (n, h, w)
            ref = np.asarray(jx_mc.mc_batch(win, fx, fy, case=case,
                                            luma=luma, bd=bd, bi=bi,
                                            out_h=h, out_w=w))
            assert np.array_equal(got.numpy(), ref), (h, w, n)
            for k in range(n):
                blk = _oracle(plane, luma, int(xs[k]), int(ys[k]),
                              int(mvx[k]), int(mvy[k]), h, w, bd, bi)
                assert np.array_equal(got[k].numpy(), blk), (h, w, k)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("case", mc.CASES)
def test_mc_batch_extreme_windows(case, luma, bd):
    """All-0 and all-max windows, a 0/max checkerboard (the extremes of
    the first pass), and full-range int16 windows, where the int16 first
    pass and the output wrap as HM's ``Short`` does."""
    rng = np.random.RandomState(bd + 2 * luma)
    h, w = (16, 8) if luma else (8, 4)
    rows, cols = mc.window_shape(case, luma, h, w)
    max_val = (1 << bd) - 1
    checker = (np.indices((rows, cols)).sum(0) % 2) * max_val
    wins = np.stack([np.zeros((rows, cols)), np.full((rows, cols), max_val),
                     checker, max_val - checker]
                    + [rng.randint(-32768, 32768, (rows, cols))
                       for _ in range(4)]).astype(np.int16)
    n = len(wins)
    fx, fy = _phases(rng, case, luma, n)
    n_taps = 8 if luma else 4
    half = n_taps // 2
    filt = interp.LUMA_FILTER if luma else interp.CHROMA_FILTER
    for bi in (False, True):
        got = mc.mc_batch(torch.from_numpy(wins), torch.from_numpy(fx),
                          torch.from_numpy(fy), case, luma, bd, bi, h, w)
        ref = np.asarray(jx_mc.mc_batch(wins, fx, fy, case=case, luma=luma,
                                        bd=bd, bi=bi, out_h=h, out_w=w))
        assert np.array_equal(got.numpy(), ref), bi
        for k in range(n):
            # the window is the whole reference: its first tap sample
            # sits at (half - 1) before the block where a case filters
            y0 = (half - 1) * (case in ("ver", "2d"))
            x0 = (half - 1) * (case in ("hor", "2d"))
            blk = interp._mc_block(wins[k], y0, x0, int(fx[k]), int(fy[k]),
                                   w, h, filt, n_taps, bd, bi)
            assert np.array_equal(got[k].numpy(), blk), (bi, k)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w", [(8, 8), (4, 16), (2, 4), (64, 64)])
def test_bi_avg_batch_equals_jax_and_numpy(h, w, bd):
    rng = np.random.RandomState(h * w + bd)
    n = 29
    # the 14-bit internal domain of a bi prediction, extremes included
    lo, hi = -interp.IF_INTERNAL_OFFS, (1 << 14) - interp.IF_INTERNAL_OFFS
    p0 = rng.randint(lo - 600, hi + 600, (n, h, w)).astype(np.int16)
    p1 = rng.randint(lo - 600, hi + 600, (n, h, w)).astype(np.int16)
    p0[0], p1[0] = lo, lo
    p0[1], p1[1] = hi, hi
    got = mc.bi_avg_batch(torch.from_numpy(p0), torch.from_numpy(p1), bd)
    assert got.dtype == torch.int16
    ref = np.asarray(jx_mc.bi_avg_batch(p0, p1, bd))
    assert np.array_equal(got.numpy(), ref)
    for k in range(n):
        assert np.array_equal(got[k].numpy(), interp.bi_avg(p0[k], p1[k], bd))


def _picture(rng, w, h, ctu):
    planes = (rng.randint(0, 256, (h, w)).astype(np.int16),
              rng.randint(0, 256, (h // 2, w // 2)).astype(np.int16),
              rng.randint(0, 256, (h // 2, w // 2)).astype(np.int16))
    uh, uw = h // 4, w // 4
    frame = SimpleNamespace(pred_mode=np.zeros((uh, uw), np.int8),
                            mv=np.zeros((2, uh, uw, 2), np.int32),
                            ref_idx=np.full((2, uh, uw), -1, np.int8))
    return Picture(0, planes, frame, None, [[], []], margin=ctu + 16)


@pytest.mark.parametrize("ctu", [16, 64])
def test_gather_windows_equals_padded_slices(ctu):
    """The clamped device gather reads what ``Picture.padded()`` holds,
    for MVs inside the picture and MVs that ``clip_mv`` clamps."""
    rng = np.random.RandomState(ctu)
    pic_w, pic_h = 96, 80
    pic = _picture(rng, pic_w, pic_h, ctu)
    pads = pic.padded()
    n = 300
    size = rng.choice([4, 8, 16], n)
    cu_x = rng.randint(0, pic_w // 16, n) * 16
    cu_y = rng.randint(0, pic_h // 16, n) * 16
    xp = cu_x + rng.randint(0, 2, n) * (16 - size).clip(0)
    yp = cu_y + rng.randint(0, 2, n) * (16 - size).clip(0)
    # a third far outside the picture (clamped), the rest near it
    far = rng.rand(n) < 1 / 3
    mv = np.where(far[:, None], rng.randint(-4000, 4000, (n, 2)),
                  rng.randint(-120, 120, (n, 2)))
    clipped = port_inter.clip_mvs(mv, cu_x, cu_y, pic_w, pic_h, ctu)
    for k in range(n):
        assert tuple(clipped[k]) == clip_mv(tuple(mv[k]), cu_x[k], cu_y[k],
                                            pic_w, pic_h, ctu)
    assert (clipped != mv).any()               # some MVs were clamped
    planes = [torch.from_numpy(p) for p in (pic.rec_y, pic.rec_cb,
                                            pic.rec_cr)]
    for comp in range(3):
        d, bits, half = (1, 2, 4) if comp == 0 else (2, 3, 2)
        m = pic.margin // d
        for case in mc.CASES:
            for s in np.unique(size):
                sel = np.nonzero(size == s)[0]
                rows, cols = mc.window_shape(case, comp == 0, s // d, s // d)
                x0 = (xp[sel] // d + (clipped[sel, 0] >> bits)
                      - (half - 1) * (case in ("hor", "2d")))
                y0 = (yp[sel] // d + (clipped[sel, 1] >> bits)
                      - (half - 1) * (case in ("ver", "2d")))
                got = mc.gather_windows(
                    planes[comp][None],
                    torch.zeros(len(sel), dtype=torch.long),
                    torch.from_numpy(x0), torch.from_numpy(y0), rows, cols)
                want = np.stack([pads[comp][y + m:y + m + rows,
                                            x + m:x + m + cols]
                                 for x, y in zip(x0, y0)])
                assert np.array_equal(got.numpy(), want), (comp, case, s)


def test_scatter_blocks_and_layout():
    layout = port_inter.Layout(32, 16)
    flat = torch.zeros(layout.size, dtype=torch.int32)
    blocks = torch.arange(2 * 4 * 8, dtype=torch.int32).reshape(2, 4, 8)
    org = torch.tensor([layout.base(0) + 2 * 32 + 3, layout.base(2) + 5])
    port_inter.scatter_blocks(flat, blocks, org,
                              torch.tensor([layout.stride(0),
                                            layout.stride(2)]))
    y, cb, cr = layout.split(flat.numpy())
    assert y.shape == (16, 32) and cb.shape == cr.shape == (8, 16)
    assert np.array_equal(y[2:6, 3:11], blocks[0].numpy())
    assert np.array_equal(cr[0:4, 5:13], blocks[1].numpy())
    assert int(flat.count_nonzero()) == 2 * 4 * 8 - 1
    assert not cb.any()


def _wp_predictor(bd, weights):
    """A reference ``InterPredictor`` whose only state is its bit depth
    and explicit weights: weights[lst][ref][comp] = (flag, w, offset)."""
    from thevc_tpu.decoder.inter import InterPredictor
    ip = InterPredictor.__new__(InterPredictor)
    ip.bd = bd
    ip.wp = {"luma_log2_denom": 5, "chroma_log2_denom": 4, "wp": weights}
    return ip


@pytest.mark.parametrize("bd", [8, 10])
def test_weighted_prediction_equals_reference(bd):
    """weight_uni_batch / weight_bi_batch against the reference's
    ``_weight_uni`` / ``_weight_bi`` per PU, on 14-bit predictions over
    the whole range, with weights and offsets of either sign."""
    rng = np.random.RandomState(bd)
    n, h, w = 40, 8, 4
    p0 = rng.randint(-8192, 8192 + 2 ** 14 - 8192, (n, h, w)).astype(np.int16)
    p1 = rng.randint(-8192, 8192 + 2 ** 14 - 8192, (n, h, w)).astype(np.int16)
    weights = [[[(True, int(rng.randint(-40, 90)), int(rng.randint(-128, 128)))
                 for _c in range(3)] for _r in range(4)] for _l in range(2)]
    ip = _wp_predictor(bd, weights)
    lst = rng.randint(0, 2, n)
    ref0, ref1 = rng.randint(0, 4, n), rng.randint(0, 4, n)
    comp = rng.randint(0, 3, n)
    denom = np.where(comp == 0, 5, 4)
    scale = 1 << (bd - 8)
    want_u = np.stack([ip._weight_uni(p0[k], lst[k], ref0[k], comp[k])
                       for k in range(n)])
    want_b = np.stack([ip._weight_bi(p0[k], p1[k], ref0[k], ref1[k],
                                     comp[k]) for k in range(n)])
    wu = np.asarray([weights[lst[k]][ref0[k]][comp[k]][1:] for k in range(n)])
    w0 = np.asarray([weights[0][ref0[k]][comp[k]][1:] for k in range(n)])
    w1 = np.asarray([weights[1][ref1[k]][comp[k]][1:] for k in range(n)])
    t = torch.from_numpy
    got_u = mc.weight_uni_batch(t(p0), t(wu[:, 0]), t(wu[:, 1] * scale),
                                t(denom), bd)
    got_b = mc.weight_bi_batch(t(p0), t(p1), t(w0[:, 0]), t(w1[:, 0]),
                               t((w0[:, 1] + w1[:, 1]) * scale), t(denom), bd)
    np.testing.assert_array_equal(want_u, got_u.numpy())
    np.testing.assert_array_equal(want_b, got_b.numpy())
    # weights (1, 1), offset 0 and denominator 0 are the plain average
    one, zero = torch.ones(n, dtype=torch.int64), torch.zeros(n,
                                                             dtype=torch.int64)
    assert torch.equal(mc.weight_bi_batch(t(p0), t(p1), one, one, zero, zero,
                                          bd),
                       mc.bi_avg_batch(t(p0), t(p1), bd))
