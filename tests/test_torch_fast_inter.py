"""The port's fast-RD P decision pass against the JAX package's, on the CPU.

Inputs: the first three frames of a 96x80 motion clip
(``tools/make_test_clip.py --style motion --seed 1234``); frame 2 is
the current picture, frames 1 and 0 its L0 references (source planes
stand in for recon).  The JAX functions run under ``jax.jit`` on the
CPU, ``_frame_body_p`` in its accelerator (``unified``) form.  The
integer stages must be equal: the helpers, the exp-Golomb MV bits (for
every |v| up to 2^15), the coarse search's MV prior, its quarter-res
SADs, the MC predictions at equal MVs and the transform RD distortions;
the float32 bit estimates agree within rtol 1e-5.  The coarse winners,
the per-size motion winners and each of the ten P maps agree on at
least 99.9% of blocks or 4x4 units (the counts are printed).
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import REPO
from thevc_tpu.encoder import fast_inter as ref
from thevc_tpu.encoder import fast_intra as ref_intra
from thevc_tpu.ops.jx_mc import mc_batch as jax_mc_batch
from thevc_tpu_torch.encoder import fast_inter as port
from thevc_tpu_torch.encoder import fast_intra as port_intra
from thevc_tpu_torch.ops import mc

W, H, CTU, SEARCH = 96, 80, 64, 64
WP, HP = 128, 128                        # CTU-padded
QP, QP_C = 32, 30
LAM, SQRT_LAM, SQRT_LAM_ME = 57.92, 7.61, 7.61
BITS3, CBITS2 = (1.0, 2.0, 5.5), (0.5, 3.5, 1.1)
MAX_SIG, MIN_TR_LOG2 = 4, 2
BIT_RTOL = 1e-5
AGREE = 0.999
P_MAPS = ("depth", "mode", "nxn", "chroma", "mode2", "mode3", "pred", "ref",
          "mvx", "mvy")


def _frames(path):
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", str(W), "--height", str(H),
                    "--frames", "3", "--seed", "1234", "--style", "motion"],
                   check=True, capture_output=True)
    raw = np.fromfile(path, np.uint8).astype(np.int16)
    size = W * H * 3 // 2
    out = []
    for i in range(3):
        f = raw[i * size:(i + 1) * size]
        out.append((f[:W * H].reshape(H, W),
                    f[W * H:W * H * 5 // 4].reshape(H // 2, W // 2),
                    f[W * H * 5 // 4:].reshape(H // 2, W // 2)))
    return out


def make_inputs(tmp_path_factory):
    """(current frame, L0 refs, L1 refs) as decide_frame_p takes them."""
    clip = tmp_path_factory.mktemp("fast_inter") / "motion_96x80.yuv"
    f = _frames(clip)
    return f[2], [(1, *f[1]), (0, *f[0])], [(0, *f[0]), (1, *f[1])]


def decide_args(cur, refs):
    return (*cur, refs, W, H, QP, QP_C, QP_C, LAM, SQRT_LAM, SQRT_LAM_ME,
            BITS3, CBITS2, MAX_SIG, MIN_TR_LOG2, SEARCH, CTU, 0, 255)


def _pad_ref(p, margin, h, w):
    return np.pad(p, ((margin, margin + h - p.shape[0]),
                      (margin, margin + w - p.shape[1])),
                  mode="edge").astype(np.int16)


def jax_frame_maps(cur, refs, refs1=None):
    """The JAX package's ``_frame_body_p`` (unified form) on the inputs
    ``dispatch_frame_p`` would build, through its collect functions."""
    ppad, cbp, crp = (p.astype(np.int32) for p in port_intra._source_planes(
        *cur, W, H, CTU))
    n_act = len(refs)
    n_act1 = len(refs1) if refs1 is not None else 0
    depth = max(4, n_act, n_act1)

    def stacks(ps):
        ps = list(ps) + [ps[-1]] * (depth - len(ps))
        return (tuple(jnp.asarray(_pad_ref(p[1], ref.PAD_FULL, HP, WP))
                      for p in ps),
                tuple(jnp.asarray(_pad_ref(p[2], ref.PAD_C, HP // 2,
                                           WP // 2)) for p in ps),
                tuple(jnp.asarray(_pad_ref(p[3], ref.PAD_C, HP // 2,
                                           WP // 2)) for p in ps))
    kw = {}
    if refs1 is not None:
        kw["refs1_y"], kw["refs1_cb"], kw["refs1_cr"] = stacks(refs1)
    iscal = np.asarray([QP, QP_C, QP_C, n_act, n_act1], np.int32)
    fscal = np.asarray([LAM, SQRT_LAM, *BITS3, *CBITS2, SQRT_LAM_ME],
                       np.float32)
    fn = jax.jit(functools.partial(
        ref._frame_body_p, wp=WP, hp=HP,
        statics=(W, H, 0, 255, CTU, SEARCH), max_sig=MAX_SIG,
        min_tr_log2=MIN_TR_LOG2, unified=True))
    out = fn(jnp.asarray(ppad), jnp.asarray(cbp), jnp.asarray(crp),
             *stacks(refs), jnp.asarray(iscal), jnp.asarray(fscal), **kw)
    collect = ref.collect_frame_b if refs1 is not None else \
        ref.collect_frame_p
    return collect((out, WP, HP))


def check_maps(names, maps_j, maps_p, what):
    assert len(maps_j) == len(maps_p) == len(names)
    for name, a, b in zip(names, maps_j, maps_p):
        assert b.dtype == a.dtype and b.shape == a.shape, name
        mismatch = int((a != b).sum())
        print(f"{what} {name}: {mismatch} of {a.size} units differ")
        assert mismatch <= (1 - AGREE) * a.size, (name, mismatch)
    assert maps_p[2].flags["C_CONTIGUOUS"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory)


@pytest.fixture(scope="module")
def planes(inputs):
    """Padded current-frame planes and padded L0 reference stacks, as
    numpy (the JAX layout) and torch (the port's)."""
    cur, refs, _ = inputs
    py, pcb, pcr = (p.astype(np.int32) for p in port_intra._source_planes(
        *cur, W, H, CTU))
    ry = np.stack([_pad_ref(p[1], ref.PAD_FULL, HP, WP) for p in refs])
    rcb = np.stack([_pad_ref(p[2], ref.PAD_C, HP // 2, WP // 2)
                    for p in refs])
    rcr = np.stack([_pad_ref(p[3], ref.PAD_C, HP // 2, WP // 2)
                    for p in refs])
    org = py[1:1 + HP, 1:1 + WP]
    org_cb = pcb[1:1 + HP // 2, 1:1 + WP // 2]
    org_cr = pcr[1:1 + HP // 2, 1:1 + WP // 2]
    rng_q = SEARCH // 4
    band = ry[:, ref.PAD_FULL - 4 * rng_q:ref.PAD_FULL + HP + 4 * rng_q,
              ref.PAD_FULL - 4 * rng_q:ref.PAD_FULL + WP + 4 * rng_q]
    refs_q = np.stack([np.array(ref._avgpool(jnp.asarray(b.astype(
        np.int32)), 4)) for b in band])
    return dict(org=org, org_cb=org_cb, org_cr=org_cr, ry=ry, rcb=rcb,
                rcr=rcr, org_q=np.array(ref._avgpool(jnp.asarray(org), 4)),
                refs_q=refs_q, rng_q=rng_q)


def test_helpers_exact():
    rng = np.random.RandomState(1)
    a = rng.randint(-300, 300, (12, 16)).astype(np.int32)
    at = torch.from_numpy(a)
    for k in (2, 4):
        np.testing.assert_array_equal(
            np.asarray(ref._avgpool(jnp.asarray(np.abs(a)), k)),
            port._avgpool(at.abs(), k).numpy())
        np.testing.assert_array_equal(
            np.asarray(ref._block_sum(jnp.asarray(a), k)),
            port._block_sum(at, k).numpy())
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            np.testing.assert_array_equal(
                np.asarray(ref._shift_grid(jnp.asarray(a), dy, dx)),
                port._shift_grid(at, dy, dx).numpy())
    b = rng.randint(-300, 300, (12, 16)).astype(np.int32)
    for x, y in zip(ref._mv_pred_median(jnp.asarray(a), jnp.asarray(b)),
                    port._mv_pred_median(at, torch.from_numpy(b))):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # the quarter-pel split of the 49 candidates, (qdy + 3) * 7 + qdx + 3
    for k, cand in enumerate(mc.QPEL_CAND):
        qdy, qdx = k // 7 - 3, k % 7 - 3
        assert cand == (*ref._qsplit(qdy), *ref._qsplit(qdx))


def test_golomb_bits_exact_up_to_2_15():
    v = np.arange(-(1 << 15), (1 << 15) + 1, dtype=np.int32)
    got = port._golomb_bits(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref._golomb_bits(jnp.asarray(v))),
                                  got.numpy())


@pytest.mark.parametrize("rng_q", [1, 4, 16, 20])
def test_coarse_bits_table_exact(rng_q):
    off = np.abs(np.arange(2 * rng_q + 1) - rng_q)
    mvq = ((off[:, None] + off[None, :]) * 16).astype(np.float32)
    want = 2 * jnp.ceil(jnp.log2(jnp.asarray(mvq) + 2.0))
    np.testing.assert_array_equal(np.asarray(want),
                                  port._coarse_bits(rng_q, torch.device("cpu")).numpy()
                                  .astype(np.float32))


def test_coarse_sads_exact(planes):
    """Every offset's quarter-res SAD, per size class."""
    org_q, rng_q = planes["org_q"], planes["rng_q"]
    hq, wq = org_q.shape
    n_off = 2 * rng_q + 1
    r = planes["refs_q"][0]
    wins = np.lib.stride_tricks.sliding_window_view(r, (hq, wq))
    sizes = [8, 16, 32, 64]
    got = port._coarse_sads(torch.from_numpy(org_q.astype(np.int16)),
                            torch.from_numpy(r.astype(np.int16)), 0, n_off,
                            n_off, sizes)
    for s in sizes:
        want = jax.vmap(jax.vmap(lambda w, s=s: ref._block_sum(
            jnp.abs(jnp.asarray(org_q) - w), s // 4)))(jnp.asarray(wins))
        np.testing.assert_array_equal(np.asarray(want), got[s].numpy())


@pytest.fixture(scope="module")
def coarse_both(planes):
    rng_q = planes["rng_q"]
    hq, wq = planes["org_q"].shape
    fn = jax.jit(ref._coarse_fields, static_argnums=(2, 3, 4, 6))
    cj = fn(jnp.asarray(planes["org_q"]), jnp.asarray(planes["refs_q"]),
            rng_q, hq, wq, jnp.float32(SQRT_LAM_ME), CTU,
            jnp.int32(len(planes["refs_q"])))
    cp = port._coarse_fields(torch.from_numpy(planes["org_q"]),
                             [torch.from_numpy(q.astype(np.int16))
                              for q in planes["refs_q"]],
                             rng_q, hq, wq, torch.tensor(np.float32(
                                 SQRT_LAM_ME)), CTU)
    return cj, cp


def test_coarse_fields_winners_agree(coarse_both):
    cj, cp = coarse_both
    for s in ref.INTER_SIZES:
        same = np.ones(cp[s][0].shape, bool)
        for a, b in zip(cj[s], cp[s]):
            same &= np.asarray(a) == b.numpy()
        print(f"coarse {s}: {int((~same).sum())} of {same.size} differ")
        assert (~same).sum() <= (1 - AGREE) * same.size


@pytest.mark.parametrize("s", ref.INTER_SIZES)
def test_inter_size_pass_agrees(planes, coarse_both, s):
    """The per-size pass from the same coarse field: MV, ref and skip
    winners on >= 99.9% of blocks, RD costs within rtol 1e-5 where
    they agree."""
    cj, _ = coarse_both
    nby, nbx = HP // s, WP // s
    fn = jax.jit(ref._inter_size_pass,
                 static_argnums=(6, 7, 8, 10, 11, 18, 19))
    f32 = np.float32
    out_j = fn(*(jnp.asarray(planes[k]) for k in ("org", "org_cb",
                                                    "org_cr")),
               jnp.asarray(planes["ry"]), jnp.asarray(planes["rcb"]),
               jnp.asarray(planes["rcr"]), s, nby, nbx, cj[s],
               ref.PAD_FULL, ref.PAD_C, jnp.int32(QP), jnp.int32(QP_C),
               jnp.int32(QP_C), f32(LAM), f32(SQRT_LAM_ME), f32(CBITS2[2]),
               0, 255)
    t = torch.from_numpy
    out_p = port._inter_size_pass(
        *(t(planes[k]) for k in ("org", "org_cb", "org_cr")),
        t(planes["ry"]), torch.cat([t(planes["rcb"]), t(planes["rcr"])]), s,
        nby, nbx, tuple(t(np.asarray(c).astype(np.int64)) for c in cj[s]),
        torch.tensor(QP), torch.tensor(QP_C), torch.tensor(QP_C),
        torch.tensor(f32(LAM)), torch.tensor(f32(SQRT_LAM_ME)),
        torch.tensor(f32(CBITS2[2])), 0, 255)
    same = np.ones((nby, nbx), bool)
    for a, b in zip(out_j[1:], out_p[1:]):
        same &= np.asarray(a) == b.numpy()
    print(f"size {s}: {int((~same).sum())} of {same.size} winners differ")
    assert (~same).sum() <= (1 - AGREE) * same.size
    np.testing.assert_allclose(out_p[0].numpy()[same],
                               np.asarray(out_j[0])[same], rtol=BIT_RTOL)


@pytest.mark.parametrize("s", ref.INTER_SIZES)
def test_predictions_at_equal_mvs_exact(planes, s):
    """Luma and chroma MC at random quarter-pel MVs: the reference's
    window gather + ``jx_mc.mc_batch`` against the port's, in the pixel
    domain (``_pred_luma``, ``_pred_chroma``) and the 14-bit one (their
    jobs through ``mc.mc_blocks``)."""
    rng = np.random.RandomState(s)
    nby, nbx = HP // s, WP // s
    nb = nby * nbx
    by = np.repeat(np.arange(nby) * s, nbx).astype(np.int32)
    bx = np.tile(np.arange(nbx) * s, nby).astype(np.int32)
    mvx = rng.randint(-270, 271, nb).astype(np.int32)
    mvy = rng.randint(-270, 271, nb).astype(np.int32)
    r = rng.randint(0, 2, nb).astype(np.int32)
    t = torch.from_numpy
    blk = [t(v).long() for v in (r, mvx, mvy, by, bx)]
    cblk = blk[:3] + [t(by // 2).long(), t(bx // 2).long()]
    chroma = torch.cat([t(planes["rcb"]), t(planes["rcr"])])
    for bi in (False, True):
        wl = ref._gather_windows(jnp.asarray(planes["ry"]), jnp.asarray(r),
                                 jnp.asarray(by + (mvy >> 2) + 77),
                                 jnp.asarray(bx + (mvx >> 2) + 77), s + 7)
        want = jax_mc_batch(wl, jnp.asarray(mvx & 3), jnp.asarray(mvy & 3),
                            case="2d", luma=True, bd=8, bi=bi, out_h=s,
                            out_w=s)
        got = (mc.mc_blocks(t(planes["ry"]), port._luma_jobs(*blk), "2d",
                            True, 8, True, s, s) if bi else
               port._pred_luma(t(planes["ry"]), tuple(blk[:3]), s, nbx, 8))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        cs = s // 2
        # Cb and Cr in one call, over the Cb planes stacked on the Cr ones
        got = (mc.mc_blocks(chroma, port._chroma_jobs(*cblk), "2d", False,
                            8, True, cs, cs, pair=True) if bi else
               port._pred_chroma(chroma, tuple(cblk[:3]), cs, nbx, 8))
        for k, name in enumerate(("rcb", "rcr")):
            wc = ref._gather_windows(jnp.asarray(planes[name]),
                                     jnp.asarray(r),
                                     jnp.asarray(by // 2 + (mvy >> 3) + 43),
                                     jnp.asarray(bx // 2 + (mvx >> 3) + 43),
                                     cs + 4)
            want = jax_mc_batch(wc, jnp.asarray(mvx & 7),
                                jnp.asarray(mvy & 7), case="2d", luma=False,
                                bd=8, bi=bi, out_h=cs, out_w=cs)
            np.testing.assert_array_equal(np.asarray(want), got[k].numpy())


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, -32])
def test_tq_rd_inter_dist_exact_bits_within_rtol(size):
    s = abs(size)
    rng = np.random.RandomState(100 + s)
    n = 300
    org = rng.randint(0, 256, (n, s, s)).astype(np.int32)
    pred = np.clip(org + rng.randint(-40, 41, (n, s, s)), 0, 255).astype(
        np.int32)
    qp = rng.randint(0, 52, n).astype(np.int32)
    d_j, b_j = ref_intra._tq_rd(jnp.asarray(org), jnp.asarray(pred), size,
                                jnp.asarray(qp), 0, 255, is_intra=False)
    d_p, b_p = port_intra._tq_rd(torch.from_numpy(org),
                                 torch.from_numpy(pred), size,
                                 torch.from_numpy(qp), 0, 255,
                                 is_intra=False)
    np.testing.assert_array_equal(np.asarray(d_j), d_p.numpy())
    np.testing.assert_allclose(b_p.numpy(), np.asarray(b_j), rtol=BIT_RTOL,
                               atol=0)
    # the inter form differs from the intra one (4x4: DCT, offset 85)
    d_i, _ = port_intra._tq_rd(torch.from_numpy(org), torch.from_numpy(pred),
                               size, torch.from_numpy(qp), 0, 255)
    assert not torch.equal(d_i, d_p)


def dp_inputs(b_slice: bool, seed: int):
    """Random leaves for the DP at 128x128: res, cres, cres8_nxn, inter."""
    rng = np.random.RandomState(seed)
    res, cres, inter = {}, {}, {}
    for s in (4, 8, 16, 32, 64):
        n = (HP // s, WP // s)
        res[s] = (rng.randint(0, 35, n).astype(np.int32),
                  rng.randint(0, 40 * s * s, n).astype(np.int32),
                  (rng.rand(*n) * 8 * s).astype(np.float32),
                  rng.randint(0, 35, n).astype(np.int32),
                  rng.randint(0, 35, n).astype(np.int32))
        if s >= 8:
            cres[s] = (rng.randint(0, 37, n).astype(np.int32),
                       (rng.rand(*n) * 20 * s * s).astype(np.float32))
            leaf = [(rng.rand(*n) * 60 * s * s).astype(np.float32),
                    rng.randint(-300, 300, n).astype(np.int32),
                    rng.randint(-300, 300, n).astype(np.int32),
                    rng.randint(0, 2, n).astype(np.int32)]
            if b_slice:
                leaf += [rng.randint(1, 4, n).astype(np.int32),
                         rng.randint(-300, 300, n).astype(np.int32),
                         rng.randint(-300, 300, n).astype(np.int32),
                         rng.randint(0, 2, n).astype(np.int32)]
            inter[s] = tuple(leaf)
    cres8 = (rng.randint(0, 37, (HP // 8, WP // 8)).astype(np.int32),
             (rng.rand(HP // 8, WP // 8) * 1280).astype(np.float32))
    return res, cres, cres8, inter


@pytest.mark.parametrize("b_slice", [False, True])
def test_dp_expand_inter_agrees(b_slice):
    res, cres, cres8, inter = dp_inputs(b_slice, 7 + b_slice)

    def jx(d):
        return {k: tuple(jnp.asarray(a) for a in v) for k, v in d.items()}

    def th(d):
        return {k: tuple(torch.from_numpy(a) for a in v)
                for k, v in d.items()}
    lam = np.float32(LAM)
    out_j = np.asarray(jax.jit(functools.partial(
        ref_intra._dp_expand, width=W, height=H, max_sig=MAX_SIG,
        min_tr_log2=MIN_TR_LOG2, ctu_size=CTU, wp=WP, hp=HP,
        intra_pen=ref._INTRA_PEN_BITS))(
        jx(res), jx(cres), tuple(jnp.asarray(a) for a in cres8),
        lam=lam, inter=jx(inter)))
    collect = ref.collect_frame_b if b_slice else ref.collect_frame_p
    maps_j = collect((out_j, WP, HP))
    # the former _dp_expand: the DP of picked chroma classes
    maps_p = port.collect_frame_p((port_intra.dp_expand_plain(
        th(res), th(cres), tuple(torch.from_numpy(a) for a in cres8), W, H,
        torch.tensor(lam), MAX_SIG, MIN_TR_LOG2, CTU, WP, HP,
        inter=th(inter), intra_pen=port._INTRA_PEN_BITS), WP, HP))
    names = P_MAPS + (("dir", "ref1", "mvx1", "mvy1") if b_slice else ())
    check_maps(names, maps_j, maps_p, "dp")
    assert (maps_p[6] == 1).any() and (maps_p[6] == 0).any()


def test_p_frame_maps_agree_with_jax(inputs):
    cur, refs, _ = inputs
    maps_j = jax_frame_maps(cur, refs)
    maps_p = port.decide_frame_p(*decide_args(cur, refs), device="cpu")
    check_maps(P_MAPS, maps_j, maps_p, "P frame")
    assert (maps_p[6] == 1).any()            # some CUs chose inter


def test_search_range_beyond_the_padding_raises(inputs):
    """The reference planes are padded for a search range up to 64 (plus
    the refinement and the taps); a wider one is refused, not clamped."""
    cur, refs, _ = inputs
    args = list(decide_args(cur, refs))
    args[16] = 68
    with pytest.raises(ValueError, match="search range 68"):
        port.decide_frame_p(*args, device="cpu")
