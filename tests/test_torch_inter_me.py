"""The P/B decision pass's motion-search stages (``encoder/fast_inter.py``:
``coarse_fields_plain``, ``int_refine_plain``, ``merge_model_plain``, the
plain forms of the ``csrc/inter_me.cu`` kernels) against the JAX
package's code of the same stages, on the CPU.

Inputs are seeded numpy: a 128x64 source (CTU 64) of smooth noise, and
two references that are the source shifted by a few samples plus noise,
edge-padded as ``RefCache`` pads them (and as 10-bit planes, samples << 2
with the 10-bit maxima).  The coarse stage runs against
``thevc_tpu.encoder.fast_inter._coarse_fields`` under ``jax.jit`` at
search ranges 16 and 64; the integer refinement and the merge/skip model
against the JAX package's lines of ``_inter_size_pass`` (``:234-262``,
``:367-428``) written out here over its own helpers (``_gather_windows``,
``_golomb_bits``, ``_mv_pred_median``, ``_shift_grid``,
``jx_mc.mc_batch``), jitted.  Integers, the chosen MVs and references are
equal (tolerance 0); the float32 RD costs within rtol 1e-6 (XLA fuses
the JAX sum's multiply-adds, the plain form rounds every op).  Edge
cases: flat planes with a zero lambda, where every candidate ties and
the first minimum wins, and the 10-bit 64x64 SSE that wraps in int32.
The dispatchers run the plain forms on CPU tensors and refuse other
devices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from thevc_tpu.encoder import fast_inter as ref
from thevc_tpu.ops.jx_mc import mc_batch as jax_mc_batch
from thevc_tpu_torch.encoder import fast_inter as port
from tests.test_torch_inter_me_kernel import (coinciding_winners,
                                              periodic_bands)

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

H, W, CTU = 64, 128, 64
N_REFS = 2
SHIFTS = ((3, -5), (-6, 9))             # per reference (rows, columns)
LAM, SQRT_LAM, CW = 57.92, 7.61, 1.1


def _smooth(rng, h, w, top):
    """Smooth seeded noise in 0..top."""
    a = rng.rand(h + 8, w + 8)
    for _ in range(3):
        a = (a[:-2, :-2] + a[1:-1, 1:-1] * 2 + a[2:, 2:]) / 4
    a = (a - a.min()) / (a.max() - a.min())
    return np.rint(a[:h, :w] * top).astype(np.int16)


def _pad(p, margin):
    return np.pad(p, margin, mode="edge").astype(np.int16)


def make_planes(seed: int, bit_inc: int, flat: bool = False) -> dict:
    """The source planes and the padded reference stacks, numpy."""
    rng = np.random.RandomState(seed)
    top = (256 << bit_inc) - 1
    if flat:
        y = np.full((H, W), top // 3, np.int16)
        cb = np.full((H // 2, W // 2), top // 2, np.int16)
        ry = [y.copy() for _ in range(N_REFS)]
        rcb = [cb.copy() for _ in range(N_REFS)]
        rcr = [cb.copy() for _ in range(N_REFS)]
        cr = cb.copy()
    else:
        y = _smooth(rng, H, W, top)
        cb = _smooth(rng, H // 2, W // 2, top)
        cr = _smooth(rng, H // 2, W // 2, top)

        def shifted(p, dy, dx):
            q = np.roll(p, (dy, dx), axis=(0, 1)).astype(np.int32)
            q += rng.randint(-3 << bit_inc, 4 << bit_inc, q.shape)
            return np.clip(q, 0, top).astype(np.int16)
        ry = [shifted(y, dy, dx) for dy, dx in SHIFTS]
        rcb = [shifted(cb, dy // 2, dx // 2) for dy, dx in SHIFTS]
        rcr = [shifted(cr, dy // 2, dx // 2) for dy, dx in SHIFTS]
    return dict(
        org=y, org_cb=cb, org_cr=cr, top=top,
        ry=np.stack([_pad(p, port.PAD_FULL) for p in ry]),
        rcb=np.stack([_pad(p, port.PAD_C) for p in rcb]),
        rcr=np.stack([_pad(p, port.PAD_C) for p in rcr]))


@pytest.fixture(scope="module", params=[0, 2], ids=["8bit", "10bit"])
def planes(request):
    return make_planes(5, request.param) | {"bit_inc": request.param}


@pytest.fixture(scope="module")
def flat():
    return make_planes(0, 0, flat=True) | {"bit_inc": 0}


def quarter_bands(p: dict, rng_q: int) -> tuple:
    """The pooled source and the references' pooled search bands, as
    ``_RefEntry.quarter`` cuts them, numpy int16."""
    org_q = np.asarray(ref._avgpool(jnp.asarray(p["org"].astype(np.int32)),
                                    4)).astype(np.int16)
    pad = port.PAD_FULL
    bands = [np.asarray(ref._avgpool(jnp.asarray(
        r[pad - 4 * rng_q:pad + H + 4 * rng_q,
          pad - 4 * rng_q:pad + W + 4 * rng_q].astype(np.int32)), 4))
        .astype(np.int16) for r in p["ry"]]
    return org_q, bands


def jax_coarse(org_q, bands, rng_q, sqrt_lam):
    fn = jax.jit(ref._coarse_fields, static_argnums=(2, 3, 4, 6))
    out = fn(jnp.asarray(org_q.astype(np.int32)),
             jnp.asarray(np.stack(bands).astype(np.int32)), rng_q,
             org_q.shape[0], org_q.shape[1], jnp.float32(sqrt_lam), CTU,
             jnp.int32(len(bands)))
    return {s: tuple(np.asarray(v) for v in out[s]) for s in out}


def port_coarse(org_q, bands, rng_q, sqrt_lam):
    out = port.coarse_fields_plain(
        torch.from_numpy(org_q), [torch.from_numpy(b) for b in bands], rng_q,
        org_q.shape[0], org_q.shape[1],
        torch.tensor(np.float32(sqrt_lam)), CTU)
    return {s: tuple(v.numpy() for v in out[s]) for s in out}


@pytest.mark.parametrize("search", [16, 64])
def test_coarse_fields_plain_equals_jax(planes, search):
    """Every size class's (dy, dx, ref) winner, tolerance 0."""
    rng_q = search // 4
    org_q, bands = quarter_bands(planes, rng_q)
    want = jax_coarse(org_q, bands, rng_q, SQRT_LAM)
    got = port_coarse(org_q, bands, rng_q, SQRT_LAM)
    assert sorted(got) == sorted(want) == list(port.INTER_SIZES)
    for s in port.INTER_SIZES:
        for a, b in zip(want[s], got[s]):
            assert b.dtype == np.int64
            np.testing.assert_array_equal(a, b, err_msg=f"size {s}")
    # the shifts are found: most 16x16 blocks point within a quarter-res
    # sample of their reference's shift
    dy, dx, r = got[16]
    hits = sum(((abs(dy - sy) <= 4) & (abs(dx - sx) <= 4) & (r == k)).sum()
               for k, (sy, sx) in enumerate(SHIFTS))
    assert hits >= dy.size // 2


def test_coarse_flat_planes_take_the_first_offset(flat):
    """Flat planes and a zero lambda: every offset of every reference
    costs 0, so each block takes code 0: reference 0, (-rng, -rng)."""
    rng_q = 4
    org_q, bands = quarter_bands(flat, rng_q)
    want = jax_coarse(org_q, bands, rng_q, 0.0)
    got = port_coarse(org_q, bands, rng_q, 0.0)
    for s in port.INTER_SIZES:
        for a, b in zip(want[s], got[s]):
            np.testing.assert_array_equal(a, b)
        dy, dx, r = got[s]
        assert (dy == -4 * rng_q).all() and (dx == -4 * rng_q).all()
        assert (r == 0).all()


@pytest.mark.parametrize("sqrt_lam", [0.0, SQRT_LAM])
@pytest.mark.parametrize("planted", [{0: (5, 7), 1: (-5, 7)}, {1: (5, -7)}],
                         ids=["both", "second"])
def test_coarse_fields_plain_equal_costs_take_the_first(sqrt_lam, planted):
    """Offsets of equal cost in one reference and in two (rows and
    columns far apart, as the kernel splits them): the plain form picks
    the JAX package's winner, the first of them in (reference, row,
    column) order: with a zero lambda every SAD-0 offset ties, across
    references too; with a lambda the four at (+-5, +-7) tie on their
    bits and reference 0's bits are cheaper."""
    rng_q = 16
    org_q, bands = periodic_bands(7, H // 4, W // 4, rng_q, N_REFS, planted)
    want = jax_coarse(org_q, bands, rng_q, sqrt_lam)
    got = port_coarse(org_q, bands, rng_q, sqrt_lam)
    for s in port.INTER_SIZES:
        for a, b in zip(want[s], got[s]):
            np.testing.assert_array_equal(a, b, err_msg=f"size {s}")
        dy, dx, r = got[s]
        assert (r == min(planted)).all()
        assert (dx == -28).all()
        assert (dy == (-20 if sqrt_lam else -60)).all()


def _block_coords(s, nby, nbx):
    ys = (np.arange(nby, dtype=np.int32) * s)[:, None]
    xs = (np.arange(nbx, dtype=np.int32) * s)[None, :]
    return (jnp.asarray(np.broadcast_to(ys, (nby, nbx)).reshape(-1)),
            jnp.asarray(np.broadcast_to(xs, (nby, nbx)).reshape(-1)))


def _org_blocks(org, s, nby, nbx):
    o = org[:nby * s, :nbx * s]
    return (o.reshape(nby, s, nbx, s).transpose(0, 2, 1, 3)
            .reshape(nby * nbx, s, s).astype(jnp.int32))


def jax_int_refine(org_full, refs_y, c_dy, c_dx, c_ref, sqrt_lam, s, nby,
                   nbx, bit_inc):
    """``thevc_tpu/encoder/fast_inter.py:226-262``: the integer
    refinement of ``_inter_size_pass``."""
    margin, pad_full = ref.MARGIN, port.PAD_FULL
    by, bx = _block_coords(s, nby, nbx)
    org_b = _org_blocks(org_full, s, nby, nbx)
    mv_px, mv_py = ref._mv_pred_median(c_dx * 4, c_dy * 4)
    pred_x = mv_px.reshape(-1)
    pred_y = mv_py.reshape(-1)
    refv = c_ref.reshape(-1)
    dy0 = c_dy.reshape(-1)
    dx0 = c_dx.reshape(-1)
    win = s + 2 * margin
    y0 = by + dy0 + (pad_full - margin)
    x0 = bx + dx0 + (pad_full - margin)
    wins = ref._gather_windows(refs_y, refv, y0, x0, win).astype(jnp.int32)
    best_cost = best_d = None
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            cand = wins[:, margin + dy:margin + dy + s,
                        margin + dx:margin + dx + s]
            sad = jnp.abs(org_b - cand).sum(axis=(1, 2)) >> bit_inc
            bits = (ref._golomb_bits((dx0 + dx) * 4 - pred_x)
                    + ref._golomb_bits((dy0 + dy) * 4 - pred_y) + 2)
            cost = (sad.astype(jnp.float32)
                    + sqrt_lam * bits.astype(jnp.float32))
            code = (dy + 3) * 7 + (dx + 3)
            if best_cost is None:
                best_cost, best_d = cost, jnp.full_like(refv, code)
            else:
                take = cost < best_cost
                best_cost = jnp.where(take, cost, best_cost)
                best_d = jnp.where(take, code, best_d)
    return dx0 + best_d % 7 - 3, dy0 + best_d // 7 - 3


def random_coarse(rng, s, nby, nbx, rng_full=16):
    """A coarse field (dy, dx full pel, multiples of 4; ref)."""
    c_dy = 4 * rng.randint(-rng_full // 4, rng_full // 4 + 1, (nby, nbx))
    c_dx = 4 * rng.randint(-rng_full // 4, rng_full // 4 + 1, (nby, nbx))
    c_ref = rng.randint(0, N_REFS, (nby, nbx))
    return tuple(v.astype(np.int64) for v in (c_dy, c_dx, c_ref))


def both_int_refine(p, coarse, s, sqrt_lam):
    nby, nbx = H // s, W // s
    fn = jax.jit(jax_int_refine, static_argnums=(6, 7, 8, 9))
    want = fn(jnp.asarray(p["org"].astype(np.int32)), jnp.asarray(p["ry"]),
              *(jnp.asarray(c.astype(np.int32)) for c in coarse),
              jnp.float32(sqrt_lam), s, nby, nbx, p["bit_inc"])
    got = port.int_refine_plain(
        torch.from_numpy(p["org"]), torch.from_numpy(p["ry"]),
        tuple(torch.from_numpy(c) for c in coarse), s, nby, nbx,
        torch.tensor(np.float32(sqrt_lam)), p["bit_inc"])
    return [np.asarray(v) for v in want], [v.numpy() for v in got]


@pytest.mark.parametrize("s", port.INTER_SIZES)
def test_int_refine_plain_equals_jax(planes, s):
    """The integer MV of every block, tolerance 0: from the true coarse
    field and from a random one (windows past the picture's edge)."""
    rng_q = 16
    org_q, bands = quarter_bands(planes, rng_q)
    coarse = port_coarse(org_q, bands, rng_q, SQRT_LAM)[s]
    rng = np.random.RandomState(s)
    for c in (coarse, random_coarse(rng, s, H // s, W // s, 64)):
        want, got = both_int_refine(planes, c, s, SQRT_LAM)
        for a, b in zip(want, got):
            assert b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_int_refine_flat_ties_take_the_first_candidate(flat):
    """Flat planes and a zero lambda: all 49 candidates tie, so every
    block moves by (-3, -3) from its coarse MV."""
    s = 16
    coarse = random_coarse(np.random.RandomState(1), s, H // s, W // s)
    want, got = both_int_refine(flat, coarse, s, 0.0)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], coarse[1].reshape(-1) - 3)
    np.testing.assert_array_equal(got[1], coarse[0].reshape(-1) - 3)


def jax_merge_model(org_full, org_cb, org_cr, refs_y, refs_cb, refs_cr, d_y,
                    b_y, d_cb, b_cb, d_cr, b_cr, mv_qx, mv_qy, refv, lam, cw,
                    s, nby, nbx, bit_inc):
    """``thevc_tpu/encoder/fast_inter.py:367-428``: the AMVP-proxy bits,
    the RD sum and the merge/skip model of ``_inter_size_pass`` (its
    prediction helpers ``pred_luma_at`` and ``pred_chroma_at`` and the
    chroma blocks as there)."""
    pad_full, pad_c = port.PAD_FULL, port.PAD_C
    bd = 8 + bit_inc
    by, bx = _block_coords(s, nby, nbx)
    org_b = _org_blocks(org_full, s, nby, nbx)
    cs = s // 2
    cby, cbx = by // 2, bx // 2
    org_cb_b = _org_blocks(org_cb, cs, nby, nbx)
    org_cr_b = _org_blocks(org_cr, cs, nby, nbx)

    def pred_luma_at(mvq_x, mvq_y, rv, byv=by, bxv=bx):
        yy0 = byv + (mvq_y >> 2) + (pad_full - 3)
        xx0 = bxv + (mvq_x >> 2) + (pad_full - 3)
        wp = ref._gather_windows(refs_y, rv, yy0, xx0,
                                 s + 7).astype(jnp.int16)
        return jax_mc_batch(wp, (mvq_x & 3).astype(jnp.int32),
                            (mvq_y & 3).astype(jnp.int32), case="2d",
                            luma=True, bd=bd, bi=False, out_h=s,
                            out_w=s).astype(jnp.int32)

    def pred_chroma_at(refs_c, mvq_x, mvq_y, rv):
        yy0 = cby + (mvq_y >> 3) + (pad_c - 1)
        xx0 = cbx + (mvq_x >> 3) + (pad_c - 1)
        wc = ref._gather_windows(refs_c, rv, yy0, xx0,
                                 cs + 4).astype(jnp.int16)
        return jax_mc_batch(wc, (mvq_x & 7).astype(jnp.int32),
                            (mvq_y & 7).astype(jnp.int32), case="2d",
                            luma=False, bd=bd, bi=False, out_h=cs,
                            out_w=cs).astype(jnp.int32)

    gx = mv_qx.reshape(nby, nbx)
    gy = mv_qy.reshape(nby, nbx)
    nl = (ref._shift_grid(gx, 0, 1).reshape(-1),
          ref._shift_grid(gy, 0, 1).reshape(-1))
    na = (ref._shift_grid(gx, 1, 0).reshape(-1),
          ref._shift_grid(gy, 1, 0).reshape(-1))
    bits_l = ref._golomb_bits(mv_qx - nl[0]) + ref._golomb_bits(mv_qy - nl[1])
    bits_a = ref._golomb_bits(mv_qx - na[0]) + ref._golomb_bits(mv_qy - na[1])
    mv_bits = jnp.minimum(bits_l, bits_a) + 2 + refv.astype(jnp.int32) + 4
    rd = (d_y.astype(jnp.float32)
          + cw * (d_cb + d_cr).astype(jnp.float32)
          + lam * (b_y + b_cb + b_cr + mv_bits.astype(jnp.float32)))
    rg = refv.reshape(nby, nbx)
    cands = [
        (nl[0], nl[1], ref._shift_grid(rg, 0, 1).reshape(-1)),
        (na[0], na[1], ref._shift_grid(rg, 1, 0).reshape(-1)),
        (jnp.zeros_like(refv), jnp.zeros_like(refv), jnp.zeros_like(refv)),
    ]
    ps3 = pred_luma_at(
        jnp.concatenate([c[0] for c in cands]),
        jnp.concatenate([c[1] for c in cands]),
        jnp.concatenate([c[2] for c in cands]),
        jnp.tile(by, 3), jnp.tile(bx, 3))
    d3 = (((jnp.tile(org_b, (3, 1, 1)) - ps3) ** 2).sum(axis=(1, 2))
          >> (2 * bit_inc)).reshape(3, nby * nbx)
    m_cost = m_idx = None
    for i in range(3):
        c_i = d3[i].astype(jnp.float32) + lam * jnp.float32(2.0 + i)
        if m_cost is None:
            m_cost, m_idx = c_i, jnp.zeros_like(refv)
        else:
            take = c_i < m_cost
            m_cost = jnp.where(take, c_i, m_cost)
            m_idx = jnp.where(take, i, m_idx)
    s_mx, s_my, s_ref = [jnp.where(m_idx == 2, c2,
                                   jnp.where(m_idx == 1, c1, c0))
                         for c0, c1, c2 in zip(*cands)]
    d_scb = ((org_cb_b - pred_chroma_at(refs_cb, s_mx, s_my, s_ref)) ** 2
             ).sum(axis=(1, 2)) >> (2 * bit_inc)
    d_scr = ((org_cr_b - pred_chroma_at(refs_cr, s_mx, s_my, s_ref)) ** 2
             ).sum(axis=(1, 2)) >> (2 * bit_inc)
    skip_rd = m_cost + cw * (d_scb + d_scr).astype(jnp.float32)
    use_skip = skip_rd < rd
    rd = jnp.minimum(rd, skip_rd)
    mv_qx = jnp.where(use_skip, s_mx, mv_qx)
    mv_qy = jnp.where(use_skip, s_my, mv_qy)
    refv = jnp.where(use_skip, s_ref, refv)
    return (rd.reshape(nby, nbx), mv_qx.reshape(nby, nbx),
            mv_qy.reshape(nby, nbx), refv.reshape(nby, nbx))


def random_merge_inputs(rng, p, s, spread: int = 40):
    """A winner field (quarter pel, within +-spread; half the blocks at
    their reference's true shift, so that a neighbour often predicts
    well, and a third sharing their left neighbour's MV) and its
    transform-RD estimates."""
    nby, nbx = H // s, W // s
    nb = nby * nbx
    top = p["top"]
    mvx = rng.randint(-spread, spread + 1, nb).astype(np.int32)
    mvy = rng.randint(-spread, spread + 1, nb).astype(np.int32)
    refv = rng.randint(0, N_REFS, nb).astype(np.int32)
    true = rng.rand(nb) < 0.5
    mvy[true] = 4 * np.array(SHIFTS)[refv[true], 0]
    mvx[true] = 4 * np.array(SHIFTS)[refv[true], 1]
    same = rng.rand(nb) < 1 / 3
    same[::nbx] = False
    for k in np.flatnonzero(same):
        mvx[k], mvy[k] = mvx[k - 1], mvy[k - 1]
    scale = s * s * (top // 4) ** 2 // 16
    rd_terms = (rng.randint(0, scale + 1, nb).astype(np.int32),
                (rng.rand(nb) * 200).astype(np.float32),
                rng.randint(0, scale // 4 + 1, nb).astype(np.int32),
                (rng.rand(nb) * 50).astype(np.float32),
                rng.randint(0, scale // 4 + 1, nb).astype(np.int32),
                (rng.rand(nb) * 50).astype(np.float32))
    return rd_terms, (mvx, mvy, refv)


def both_merge(p, s, rd_terms, winner, lam, cw):
    nby, nbx = H // s, W // s
    fn = jax.jit(jax_merge_model, static_argnums=(17, 18, 19, 20))
    want = fn(*(jnp.asarray(p[k].astype(np.int32))
                for k in ("org", "org_cb", "org_cr")),
              *(jnp.asarray(p[k]) for k in ("ry", "rcb", "rcr")),
              *(jnp.asarray(t) for t in rd_terms),
              *(jnp.asarray(t) for t in winner), jnp.float32(lam),
              jnp.float32(cw), s, nby, nbx, p["bit_inc"])
    t = torch.from_numpy
    got = port.merge_model_plain(
        t(p["org"]), t(p["org_cb"]), t(p["org_cr"]), t(p["ry"]),
        torch.cat([t(p["rcb"]), t(p["rcr"])]), s, nby, nbx,
        tuple(t(v) for v in rd_terms), tuple(t(v) for v in winner),
        torch.tensor(np.float32(lam)), torch.tensor(np.float32(cw)),
        p["bit_inc"])
    return [np.asarray(v) for v in want], [v.numpy() for v in got]


def check_merge(want, got):
    """MVs and references exact; RD costs within rtol 1e-6 (a few float32
    ulps): XLA fuses the JAX sum's two multiply-adds, the plain form (and
    the kernel) rounds each op."""
    assert [v.dtype for v in got] == [np.float32, np.int32, np.int32,
                                      np.int32]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for a, b in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("s", port.INTER_SIZES)
def test_merge_model_plain_equals_jax(planes, s):
    """Winners and references exact, RD costs within rtol 1e-6, with some
    blocks taking skip and some not."""
    rng = np.random.RandomState(100 + s)
    rd_terms, winner = random_merge_inputs(rng, planes, s)
    want, got = both_merge(planes, s, rd_terms, winner, LAM, CW)
    check_merge(want, got)
    moved = (got[1].reshape(-1) != winner[0]) | (got[2].reshape(-1)
                                                 != winner[1])
    print(f"size {s}: {int(moved.sum())} of {moved.size} blocks take skip "
          "with another MV")


@pytest.mark.parametrize("s", port.INTER_SIZES)
def test_merge_model_plain_coinciding_candidates_equal_jax(planes, s):
    """Left, above and zero candidates that coincide (the kernel prices
    each distinct one once): winners and references exact, RD costs
    within rtol 1e-6, as in ``test_merge_model_plain_equals_jax``."""
    rng = np.random.RandomState(300 + s)
    rd_terms, _ = random_merge_inputs(rng, planes, s)
    winner = coinciding_winners(rng, H // s, W // s, N_REFS)
    nbx = W // s
    left = np.concatenate([[False], (winner[0][1:] == winner[0][:-1])
                           & (winner[1][1:] == winner[1][:-1])
                           & (winner[2][1:] == winner[2][:-1])])
    left[::nbx] = False
    assert left.any()
    want, got = both_merge(planes, s, rd_terms, winner, LAM, CW)
    check_merge(want, got)


def test_merge_model_flat_ties_take_the_left_candidate(flat):
    """Flat planes and a zero lambda: the three candidates tie on zero
    SSE, so the left one wins, and skip (strictly cheaper at rd > 0)
    takes its MV."""
    s = 16
    rng = np.random.RandomState(3)
    rd_terms, winner = random_merge_inputs(rng, flat, s)
    want, got = both_merge(flat, s, rd_terms, winner, 0.0, CW)
    check_merge(want, got)
    nbx = W // s
    mvx = winner[0].reshape(H // s, nbx)
    left = np.concatenate([np.zeros((H // s, 1), np.int32), mvx[:, :-1]], 1)
    np.testing.assert_array_equal(got[1], left)


def test_merge_model_10bit_64_sse_wraps():
    """A 64x64 block of 10-bit zeros against references of 1023: the luma
    SSE, 4096 * 1023^2, wraps in int32 before the shift, in both."""
    p = make_planes(0, 2, flat=True) | {"bit_inc": 2}
    p["org"] = np.zeros_like(p["org"])
    p["ry"] = np.full_like(p["ry"], 1023)
    sse = np.int64(64 * 64) * 1023 * 1023
    assert sse > np.iinfo(np.int32).max
    rng = np.random.RandomState(4)
    rd_terms, winner = random_merge_inputs(rng, p, 64)
    want, got = both_merge(p, 64, rd_terms, winner, LAM, CW)
    check_merge(want, got)
    # what the wrapped SSE prices the zero candidate at
    wrapped = np.int64(sse).astype(np.int32) >> 4
    assert wrapped < 0
    plain = port._sse(torch.zeros(1, 64, 64, dtype=torch.int32),
                      torch.full((1, 64, 64), 1023, dtype=torch.int16), 2)
    assert int(plain[0]) == int(wrapped)


def test_dispatchers_run_the_plain_forms_on_the_cpu(planes, monkeypatch):
    """On CPU tensors each stage is its plain form and never enters the
    kernel binding; a device that is neither CPU nor CUDA raises."""
    from thevc_tpu_torch.ops import inter_me_kernel

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel binding ran on the CPU")
    for name in ("coarse_search", "int_refine", "merge_model"):
        monkeypatch.setattr(inter_me_kernel, name, no_kernel)
    s, rng_q = 16, 4
    nby, nbx = H // s, W // s
    org_q, bands = quarter_bands(planes, rng_q)
    sl = torch.tensor(np.float32(SQRT_LAM))
    args = (torch.from_numpy(org_q), [torch.from_numpy(b) for b in bands],
            rng_q, org_q.shape[0], org_q.shape[1], sl, CTU)
    c = port._coarse_fields(*args)
    for k in c:
        for a, b in zip(c[k], port.coarse_fields_plain(*args)[k]):
            assert torch.equal(a, b)
    org, ry = torch.from_numpy(planes["org"]), torch.from_numpy(planes["ry"])
    r = port.int_refine(org, ry, c[s], s, nby, nbx, sl, planes["bit_inc"])
    for a, b in zip(r, port.int_refine_plain(org, ry, c[s], s, nby, nbx, sl,
                                             planes["bit_inc"])):
        assert torch.equal(a, b)
    rd_terms, winner = random_merge_inputs(np.random.RandomState(0), planes,
                                           s)
    t = torch.from_numpy
    margs = (org, t(planes["org_cb"]), t(planes["org_cr"]), ry,
             torch.cat([t(planes["rcb"]), t(planes["rcr"])]), s, nby, nbx,
             tuple(t(v) for v in rd_terms), tuple(t(v) for v in winner),
             torch.tensor(np.float32(LAM)), torch.tensor(np.float32(CW)),
             planes["bit_inc"])
    for a, b in zip(port.merge_model(*margs), port.merge_model_plain(*margs)):
        assert torch.equal(a, b)
    meta = torch.empty(org_q.shape, dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port._coarse_fields(meta, [], rng_q, *org_q.shape, sl, CTU)
    with pytest.raises(ValueError, match="unsupported device"):
        port.int_refine(org.to("meta"), ry, c[s], s, nby, nbx, sl, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        port.merge_model(org.to("meta"), *margs[1:])
