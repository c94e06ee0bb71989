"""The port's in-loop filters against the JAX package's.

Inputs come from numpy with a seed (as in tests/test_device_path.py) and
go through both packages; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from thevc_tpu.ops import jx_filters as jf
from thevc_tpu_torch.ops import filters as tf


def _rand_deblock_inputs(rng, H, W):
    uh, uw = H // 4, W // 4
    flags = rng.rand(uh, uw) < 0.7
    bs = (rng.randint(0, 3, (uh, uw)) * flags).astype(np.uint8)
    qp_p = rng.randint(20, 46, (uh, uw)).astype(np.int32)
    qp_q = rng.randint(20, 46, (uh, uw)).astype(np.int32)
    no_p = (rng.rand(uh, uw) < 0.05)
    no_q = (rng.rand(uh, uw) < 0.05)
    return flags, bs, qp_p, qp_q, no_p, no_q


def _t(a):
    """numpy -> torch with a leading picture axis of 1."""
    return torch.from_numpy(np.ascontiguousarray(a))[None]


def _plane(rng, H, W, bd, content):
    """Uniform noise (the inputs of tests/test_device_path.py), or flat
    8x8 blocks with a little noise, where the luma filter decisions pass
    and samples change."""
    if content == "noise":
        return rng.randint(0, 1 << bd, (H, W)).astype(np.int32)
    scale = 1 << (bd - 8)
    blocks = rng.randint(100, 140, (H // 8, W // 8)) * scale
    flat = np.kron(blocks, np.ones((8, 8), np.int64))
    return (flat + rng.randint(0, 2 * scale, (H, W))).astype(np.int32)


@pytest.mark.parametrize("content", ["noise", "blocky"])
@pytest.mark.parametrize("bd", [8, 10])
def test_luma_dir_matches_jax(bd, content):
    rng = np.random.RandomState(7)
    H, W = 64, 96
    plane = _plane(rng, H, W, bd, content)
    flags, bs, qp_p, qp_q, no_p, no_q = _rand_deblock_inputs(rng, H, W)
    no_p, no_q = no_p.astype(np.uint8), no_q.astype(np.uint8)
    ref = np.asarray(jax.jit(lambda *a: jf._luma_dir(*a, 1, -1, bd))(
        plane, flags, bs, qp_p, qp_q, no_p, no_q))
    if content == "blocky":
        assert not np.array_equal(ref, plane)
    got = tf._luma_dir(_t(plane), _t(flags), _t(bs), _t(qp_p), _t(qp_q),
                       _t(no_p), _t(no_q), 1, -1, bd)[0]
    assert np.array_equal(got.numpy(), ref)
    # the transposed (horizontal-edge) form as _filter_core uses it
    ref_t = np.asarray(jax.jit(lambda *a: jf._luma_dir(*a, 0, 2, bd))(
        plane.T[:, :64], flags.T[:, :16], bs.T[:, :16], qp_p.T[:, :16],
        qp_q.T[:, :16], no_p.T[:, :16], no_q.T[:, :16]))
    got_t = tf._luma_dir(_t(plane).transpose(1, 2)[:, :, :64],
                         *(_t(a).transpose(1, 2)[:, :, :16] for a in
                           (flags, bs, qp_p, qp_q, no_p, no_q)),
                         0, 2, bd)[0]
    assert np.array_equal(got_t.numpy(), ref_t)


@pytest.mark.parametrize("bd", [8, 10])
def test_chroma_dir_matches_jax(bd):
    rng = np.random.RandomState(11)
    H, W = 64, 96
    maxv = (1 << bd) - 1
    cb = rng.randint(0, maxv + 1, (H // 2, W // 2)).astype(np.int32)
    cr = rng.randint(0, maxv + 1, (H // 2, W // 2)).astype(np.int32)
    flags, bs, qp_p, qp_q, no_p, no_q = _rand_deblock_inputs(rng, H, W)
    no_p, no_q = no_p.astype(np.uint8), no_q.astype(np.uint8)
    rcb, rcr = jax.jit(lambda *a: jf._chroma_dir(*a, 2, bd))(
        cb, cr, flags, bs, qp_p, qp_q, no_p, no_q)
    assert not np.array_equal(np.asarray(rcb), cb)
    tcb, tcr = _t(cb), _t(cr)
    ocb, ocr = tf._chroma_dir(tcb, tcr, _t(flags), _t(bs), _t(qp_p),
                              _t(qp_q), _t(no_p), _t(no_q), 2, bd)
    assert np.array_equal(ocb[0].numpy(), np.asarray(rcb))
    assert np.array_equal(ocr[0].numpy(), np.asarray(rcr))
    # inputs are left as they were (the reference is functional)
    assert np.array_equal(tcb[0].numpy(), cb)


@pytest.mark.parametrize("bd", [8, 10])
def test_sao_plane_matches_jax(bd):
    rng = np.random.RandomState(13)
    ctu, ctus_w, ctus_h = 32, 3, 2
    H, W = 60, 92        # non-CTU-multiple picture exercises edge CTUs
    src = rng.randint(0, 1 << bd, (H, W)).astype(np.int32)
    nctu = ctus_w * ctus_h
    sao_type = rng.randint(-1, 5, nctu).astype(np.int8)
    sub_type = rng.randint(0, 32, nctu).astype(np.int32)
    offsets = rng.randint(-7, 8, (nctu, 4)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda s, t, bp, o: jf._sao_plane(
        s, t, bp, o, ctu, ctus_w, ctus_h, bd))(src, sao_type, sub_type,
                                               offsets))
    assert not np.array_equal(ref, src)
    got = tf._sao_plane(_t(src), _t(sao_type), _t(sub_type), _t(offsets),
                        ctu, ctus_w, ctus_h, bd)[0]
    assert np.array_equal(got.numpy(), ref)


def _batch_inputs(rng, n, H, W, ctu, bd, do_sao):
    uh, uw = -(-H // ctu) * ctu // 4, -(-W // ctu) * ctu // 4
    ctus_w, ctus_h = -(-W // ctu), -(-H // ctu)
    nctu = ctus_w * ctus_h
    maxv = (1 << bd) - 1
    y = np.stack([_plane(rng, H, W, bd, "blocky") for _ in range(n)])
    cb = rng.randint(0, maxv + 1, (n, H // 2, W // 2))
    cr = rng.randint(0, maxv + 1, (n, H // 2, W // 2))

    def maps():
        flags = (rng.rand(n, uh, uw) < 0.7).astype(np.uint8)
        bs = (rng.randint(0, 3, (n, uh, uw)) * flags).astype(np.uint8)
        qpp = rng.randint(20, 46, (n, uh, uw)).astype(np.int8)
        qpq = rng.randint(20, 46, (n, uh, uw)).astype(np.int8)
        nop = (rng.rand(n, uh, uw) < 0.05).astype(np.uint8)
        noq = (rng.rand(n, uh, uw) < 0.05).astype(np.uint8)
        return (flags, bs, qpp, qpq, nop, noq)

    dv, dh = maps(), maps()
    types = rng.randint(-1, 5 if do_sao else 0,
                        (n, 3, nctu)).astype(np.int8)
    band_pos = rng.randint(0, 32, (n, 3, nctu)).astype(np.int32)
    offsets = rng.randint(-7, 8, (n, 3, nctu, 4)).astype(np.int32)
    statics = dict(beta_offset=1, tc_offset=-1, bit_depth=bd,
                   ctu_size=ctu, ctus_w=ctus_w, ctus_h=ctus_h,
                   do_deblock=True, do_sao=do_sao, do_sao_chroma=do_sao)
    return (y, cb, cr, dv, dh, types, band_pos, offsets), statics


@pytest.mark.parametrize("do_sao", [True, False])
@pytest.mark.parametrize("out_u8", [True, False])
def test_filter_pictures_matches_jax(do_sao, out_u8):
    bd = 8 if out_u8 else 10
    rng = np.random.RandomState(17 + do_sao + 2 * out_u8)
    arrs, statics = _batch_inputs(rng, 3, 72, 104, 32, bd, do_sao)
    y, cb, cr, dv, dh, types, band_pos, offsets = arrs
    dt = np.uint8 if out_u8 else np.int16
    y, cb, cr = y.astype(dt), cb.astype(dt), cr.astype(dt)
    ref = jf.filter_pictures(y, cb, cr, dv, dh, types, band_pos, offsets,
                             out_u8=out_u8, **statics)
    t = torch.from_numpy
    got = tf.filter_pictures(t(y), t(cb), t(cr),
                             tuple(t(a) for a in dv), tuple(t(a) for a in dh),
                             t(types), t(band_pos), t(offsets),
                             out_u8=out_u8, **statics)
    for g, r in zip(got, ref):
        assert g.dtype == (torch.uint8 if out_u8 else torch.int16)
        assert np.array_equal(g.numpy(), np.asarray(r))
    # one picture through filter_picture equals its slot in the batch
    one = tf.filter_picture(t(y[1]), t(cb[1]), t(cr[1]),
                            tuple(t(a[1]) for a in dv),
                            tuple(t(a[1]) for a in dh),
                            t(types[1]), t(band_pos[1]), t(offsets[1]),
                            **statics)
    ref_one = jf.filter_picture(y[1], cb[1], cr[1],
                                tuple(a[1] for a in dv),
                                tuple(a[1] for a in dh), types[1],
                                band_pos[1], offsets[1], **statics)
    for g, r in zip(one, ref_one):
        assert np.array_equal(g.numpy(), np.asarray(r))
