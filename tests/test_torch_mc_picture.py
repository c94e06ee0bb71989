"""The port's whole-picture motion compensation (``ops.mc.mc_picture``)
and the encoder's block MC (``ops.mc.mc_blocks``), on the CPU, with
tolerance 0 (integer codec math).

``mc_picture_plain`` is held against the class-by-class path it replaced
in ``decoder/inter.py:predict_picture`` (kept here as a local function),
and against the numpy ``ops/interp.py`` (every job) and the JAX
package's ``ops/jx_mc.py`` (the 8x8 luma and 4x4 chroma lists), with the
JAX decoder's ``_weight_uni``/``_weight_bi`` for weighted jobs, on
seeded random job tables: every case, luma and chroma, uni, bi,
weighted uni and weighted bi, bit depths 8 and 10, windows past every
plane edge.  The port's CPU decode of the small low-delay P/B, random
access and 10-bit streams stays digest-OK and recon-exact, with every
picture's job table given to both paths.  The quarter-pel candidates of
the P/B decision pass (49 a block, one ``mc_blocks`` call) equal the
former seven ``torch.cat`` and ``mc_batch`` calls a size class.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_kernels import random_mc_jobs
from thevc_tpu.decoder.inter import InterPredictor
from thevc_tpu.encoder import fast_inter as jax_fast_inter
from thevc_tpu.ops import interp, jx_mc
from thevc_tpu_torch import native, streams
from thevc_tpu_torch.decoder.top import Decoder
from thevc_tpu_torch.encoder import fast_inter
from thevc_tpu_torch.ops import mc

MARGIN = 96                  # numpy padding past every window of the tables
UNI, BI, WUNI, WBI = (mc.KINDS.index(k)
                      for k in ("uni", "bi", "wuni", "wbi"))


def class_path(jobs, planes, size, bd):
    """The MC of ``predict_picture`` before the picture kernel: one uni
    job per (PU, list, component) in the old table's columns, sorted into
    (component, case, size, kind) classes; each class gathered from the
    stacked luma or chroma planes and filtered by one ``mc_batch``; bi
    halves met in pair buffers per block size, then ``bi_avg_batch``, or
    ``weight_bi_batch`` for all pairs when any slice was weighted."""
    dev = planes[0].device
    luma = torch.stack(planes[0::3])
    chroma = torch.stack([p for k, p in enumerate(planes) if k % 3])
    jobs = np.asarray(jobs, np.int64)
    kind = jobs[:, mc.J_KIND]
    is_bi = np.isin(kind, (BI, WBI))
    # pairs (h, w, origin, stride, w0, w1, offset, denominator, job),
    # ordered by size, numbered within it
    pairs = jobs[is_bi][:, [mc.J_H, mc.J_W, mc.J_DST, mc.J_STRIDE, mc.J_W0,
                            mc.J_W1, mc.J_OFF, mc.J_DEN]]
    pairs = np.concatenate([pairs, np.nonzero(is_bi)[0][:, None]], axis=1)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    size_key = pairs[:, 0] * 128 + pairs[:, 1]
    pair_idx = np.full(len(jobs), -1)
    for key in np.unique(size_key):
        sel = size_key == key
        pair_idx[pairs[sel, 8]] = np.arange(int(sel.sum()))
    table, keys = [], []
    for lst in (0, 1):
        sel = np.nonzero(is_bi | (lst == 0))[0]
        j = jobs[sel]
        c = mc.J_LIST + 6 * lst
        plane = j[:, c + mc.L_PLANE]
        old_kind = np.where(is_bi[sel], 1, np.where(kind[sel] == WUNI, 2, 0))
        table.append(np.stack([
            np.where(plane % 3 == 0, plane // 3, 2 * (plane // 3)
                     + plane % 3 - 1),
            j[:, c + mc.L_WX], j[:, c + mc.L_WY], j[:, c + mc.L_FX],
            j[:, c + mc.L_FY], j[:, mc.J_DST], j[:, mc.J_STRIDE],
            np.full(len(j), lst), pair_idx[sel], j[:, mc.J_W0],
            j[:, mc.J_OFF], j[:, mc.J_DEN]], axis=1))
        keys.append(np.stack([j[:, mc.J_LUMA], j[:, c + mc.L_CASE],
                              j[:, mc.J_H], j[:, mc.J_W], old_kind], axis=1))
    table, keys = np.concatenate(table), np.concatenate(keys)
    order = np.lexsort(keys.T[::-1])
    table, keys = table[order], keys[order]
    bounds = np.r_[0, np.nonzero(np.any(np.diff(keys, axis=0), axis=1))[0]
                   + 1, len(keys)]
    pred = torch.zeros(size, dtype=torch.int16, device=dev)
    tab = torch.from_numpy(table).to(dev)
    pair_tab = torch.from_numpy(pairs).to(dev)
    sizes, size_at = np.unique(size_key, return_index=True)
    counts = np.diff(np.r_[size_at, len(pairs)])
    bufs = {int(k): torch.empty((2, int(c), int(k) // 128, int(k) % 128),
                                dtype=torch.int16, device=dev)
            for k, c in zip(sizes, counts)}
    for a, b in zip(bounds[:-1], bounds[1:]):
        is_luma, case_id, h, w, old_kind = (int(v) for v in keys[a])
        case = mc.CASES[case_id]
        t = tab[a:b]
        rows, cols = mc.window_shape(case, bool(is_luma), h, w)
        win = mc.gather_windows(luma if is_luma else chroma, t[:, 0],
                                t[:, 1], t[:, 2], rows, cols)
        out = mc.mc_batch(win, t[:, 3], t[:, 4], case, bool(is_luma), bd,
                          old_kind != 0, h, w)
        if old_kind == 1:
            bufs[h * 128 + w][t[:, 7], t[:, 8]] = out
            continue
        if old_kind == 2:
            out = mc.weight_uni_batch(out, t[:, 9], t[:, 10], t[:, 11], bd)
        mc.scatter_blocks(pred, out, t[:, 5], t[:, 6])
    weighted = bool(np.isin(kind, (WUNI, WBI)).any())
    for (k, buf), a, c in zip(bufs.items(), size_at, counts):
        pt = pair_tab[a:a + c]
        if weighted:
            avg = mc.weight_bi_batch(buf[0], buf[1], pt[:, 4], pt[:, 5],
                                     pt[:, 6], pt[:, 7], bd)
        else:
            avg = mc.bi_avg_batch(buf[0], buf[1], bd)
        mc.scatter_blocks(pred, avg, pt[:, 2], pt[:, 3])
    return pred


def reference(jobs, planes, size, bd):
    """Every job through ``ops/interp.py`` on edge-padded planes (HM's
    per-PU MC), its lists combined by ``interp.bi_avg`` or the JAX
    decoder's ``InterPredictor._weight_uni``/``_weight_bi``; the 8x8 luma
    and 4x4 chroma lists also through ``jx_mc.mc_batch``, which must
    agree.  Returns the flat int16 prediction (numpy) and the number of
    lists checked through ``jx_mc``."""
    padded = [np.pad(p.numpy(), MARGIN, mode="edge") for p in planes]
    out = np.zeros(size, np.int16)
    jx_rows = {}
    for j in np.asarray(jobs, np.int64):
        h, w, luma, kind = (int(v) for v in j[:4])
        half = 4 if luma else 2
        fn = interp.mc_luma if luma else interp.mc_chroma
        preds = []
        for lst in range(1 + (kind in (BI, WBI))):
            plane, wx, wy, fx, fy, case = (int(v) for v in
                                           j[mc.J_LIST + 6 * lst:][:6])
            x, y = wx + (half - 1) * (fx != 0), wy + (half - 1) * (fy != 0)
            p = fn(padded[plane], MARGIN, x, y, fx, fy, w, h, bd,
                   kind != UNI)
            preds.append(p)
            if (h, w) == ((8, 8) if luma else (4, 4)):
                rows, cols = mc.window_shape(mc.CASES[case], bool(luma), h,
                                             w)
                win = padded[plane][MARGIN + wy:MARGIN + wy + rows,
                                    MARGIN + wx:MARGIN + wx + cols]
                jx_rows.setdefault((luma, case, kind != UNI), []).append(
                    (win, fx, fy, p))
        params = [(int(j[mc.J_W0]), int(j[mc.J_OFF]) >> (bd - 8),
                   int(j[mc.J_DEN])),
                  (int(j[mc.J_W1]), 0, int(j[mc.J_DEN]))]
        ip = SimpleNamespace(bd=bd, _wp_params=lambda lst, _r, _c:
                             params[lst])
        if kind == UNI:
            blk = preds[0]
        elif kind == BI:
            blk = interp.bi_avg(preds[0], preds[1], bd)
        elif kind == WUNI:
            blk = InterPredictor._weight_uni(ip, preds[0], 0, 0, 0)
        else:
            blk = InterPredictor._weight_bi(ip, preds[0], preds[1], 0, 0, 0)
        for r in range(h):
            at = int(j[mc.J_DST]) + r * int(j[mc.J_STRIDE])
            out[at:at + w] = blk[r]
    for (luma, case, bi), rows in jx_rows.items():
        h, w = (8, 8) if luma else (4, 4)
        got = np.asarray(jx_mc.mc_batch(
            np.stack([r[0] for r in rows]),
            np.asarray([r[1] for r in rows], np.int32),
            np.asarray([r[2] for r in rows], np.int32),
            case=mc.CASES[case], luma=bool(luma), bd=bd, bi=bool(bi),
            out_h=h, out_w=w))
        assert np.array_equal(got, np.stack([r[3] for r in rows]))
    return out, sum(len(r) for r in jx_rows.values())


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_mc_picture_plain_equals_class_path_and_references(bd, seed):
    rng = np.random.RandomState(100 * bd + seed)
    jobs, planes, size = random_mc_jobs(rng, bd, 160)
    kinds = jobs[:, mc.J_KIND]
    cases = np.concatenate([jobs[:, mc.J_LIST + mc.L_CASE],
                            jobs[np.isin(kinds, (BI, WBI)),
                                 mc.J_LIST + 6 + mc.L_CASE]])
    assert set(kinds) == {UNI, BI, WUNI, WBI} and set(cases) == {0, 1, 2, 3}
    assert set(jobs[:, mc.J_LUMA]) == {0, 1}
    mc.launches = 0
    got = mc.mc_picture(jobs, planes, size, bd)
    assert mc.launches > 0              # the CPU runs the plain version
    assert torch.equal(got, mc.mc_picture_plain(jobs, planes, size, bd))
    assert torch.equal(got, class_path(jobs, planes, size, bd))
    want, jx_lists = reference(jobs, planes, size, bd)
    assert np.array_equal(got.numpy(), want) and jx_lists > 0


def test_mc_picture_plain_of_one_class_and_no_jobs():
    rng = np.random.RandomState(7)
    jobs, planes, size = random_mc_jobs(rng, 8, 40)
    uni = jobs[jobs[:, mc.J_KIND] == UNI][:1]
    uni[:, mc.J_DST] = 0
    got = mc.mc_picture_plain(uni, planes, size, 8)
    assert np.array_equal(got.numpy(), reference(uni, planes, size, 8)[0])
    empty = mc.mc_picture_plain(jobs[:0], planes, 10, 8)
    assert empty.shape == (10,) and not empty.any()


@pytest.fixture(scope="module")
def decode_streams(tmp_path_factory):
    """The small LDP, RA and LDB streams of ``streams.robust_streams``,
    and a 3-frame 10-bit low-delay B stream of the same clip."""
    assert native.get_lib() is not None
    root = tmp_path_factory.mktemp("mc_picture")
    made = streams.robust_streams(root)
    clip = root / f"robust_{streams.ROBUST_W}x{streams.ROBUST_H}.yuv"
    s10, r10 = root / "ldb10.bin", root / "ldb10_rec.yuv"
    streams.encode(clip, s10, r10, streams.ROBUST_W, streams.ROBUST_H, 3,
                   cfg=streams.CFG / "encoder_lowdelay_tlayers.cfg",
                   extra=("--InternalBitDepth=10",))
    made["ldb10"] = (s10, r10, 3)
    return made


@pytest.mark.parametrize("name", ["ldp", "ra", "ldb", "ldb10"])
def test_cpu_decode_through_mc_picture(name, decode_streams, monkeypatch):
    stream, rec, frames = decode_streams[name]
    calls = []
    real = mc.mc_picture

    def record(jobs, planes, size, bd):
        calls.append((jobs, planes, size, bd))
        return real(jobs, planes, size, bd)
    monkeypatch.setattr(mc, "mc_picture", record)
    pics = Decoder("cpu").decode_stream(stream.read_bytes())
    assert len(pics) == frames and all(p.digest_ok for p in pics)
    got = b"".join(pl.astype("<u2" if name == "ldb10" else np.uint8)
                   .tobytes() for p in sorted(pics, key=lambda p: p.poc)
                   for pl in p.frame.planes())
    assert got == rec.read_bytes()
    # every P/B picture predicted through mc_picture (bi jobs in the
    # random-access stream), each table equal through the class path
    assert len(calls) == frames - 1
    if name == "ra":
        assert any((c[0][:, mc.J_KIND] == BI).any() for c in calls)
    for jobs, planes, size, bd in calls:
        assert bd == (10 if name == "ldb10" else 8)
        assert torch.equal(mc.mc_picture_plain(jobs, planes, size, bd),
                           class_path(jobs, planes, size, bd))


def seven_cat_loop(refs_y, ref, bx, by, int_mx, int_my, s, bd):
    """The quarter-pel MC of the P/B pass before ``mc_blocks``: one window
    a block, then per quarter-pel row 7 slices ``torch.cat``-ed into one
    ``mc_batch`` call."""
    nb, margin = ref.shape[0], fast_inter.MARGIN
    win = s + 2 * margin
    w = mc.gather_windows(refs_y, ref,
                          bx + int_mx + (fast_inter.PAD_FULL - margin),
                          by + int_my + (fast_inter.PAD_FULL - margin),
                          win, win)
    preds = torch.empty((nb, 49, s, s), dtype=torch.int16)
    steps = torch.arange(-3, 4)
    fxv = (steps & 3).repeat_interleave(nb)
    for qdy in range(-3, 4):
        iy, fy = jax_fast_inter._qsplit(qdy)
        wy = margin + iy - 3
        subs = []
        for qdx in range(-3, 4):
            wx = margin + jax_fast_inter._qsplit(qdx)[0] - 3
            subs.append(w[:, wy:wy + s + 7, wx:wx + s + 7])
        fyv = torch.full((7 * nb,), fy, dtype=torch.int64)
        row = mc.mc_batch(torch.cat(subs), fxv, fyv, "2d", True, bd, False,
                          s, s)
        k = (qdy + 3) * 7
        preds[:, k:k + 7] = row.reshape(7, nb, s, s).transpose(0, 1)
    return preds


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [8, 16, 64])
def test_qpel_mc_blocks_equals_seven_cat_loop(s, bd):
    rng = np.random.RandomState(s + bd)
    hp, wp, pad = 64, 128, fast_inter.PAD_FULL
    refs_y = torch.from_numpy(rng.randint(
        0, 1 << bd, (2, hp + 2 * pad, wp + 2 * pad)).astype(np.int16))
    nby, nbx = hp // s, wp // s
    nb = nby * nbx
    by, bx = fast_inter._block_grid(s, nby, nbx, "cpu")
    ref = torch.from_numpy(rng.randint(0, 2, nb))
    # integer MVs inside the search range and past the padded plane
    reach = pad + 2 * s
    int_mx = torch.from_numpy(rng.randint(-reach, reach + 1, nb))
    int_my = torch.from_numpy(rng.randint(-reach, reach + 1, nb))
    mc.launches = 0
    got = fast_inter._qpel_preds(refs_y, ref, int_mx, int_my, s, nbx, bd)
    assert mc.launches >= 1
    assert got.shape == (nb, 49, s, s)
    assert torch.equal(got, seven_cat_loop(refs_y, ref, bx, by, int_mx,
                                           int_my, s, bd))
