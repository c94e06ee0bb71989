"""The fast-RD intra decision pass's kernel boundaries on the CPU.

The I pass (``encoder.fast_intra``) reaches its per-block math through
three entries: ``intra_sweep`` (the 35-mode prediction and SATD of a
luma size class), ``tu_rd_modes`` (the transform-RD estimate of listed
intra modes, predicted from the source; luma, or Cb and Cr at once) and
``tu_rd`` (of predictions given as tensors, the P/B pass's).  On a CUDA
tensor each launches a kernel of ``csrc/intra_rd.cu``; on a CPU tensor,
as here, its plain form.  So the glue these tests run is the card's.

Seeded numpy frames at 64x64 (CTU 32, 8 bits) and 128x64 (CTU 64, 10
bits, bit increment 2) go through:

- the sweep's plain form against the JAX package's ``_size_pass_impl``
  internals (its unified prediction stack and ``_satd_d``): SATD [N, 35]
  and the first-minimum mode exact;
- each size class's (best, dist, bits, mode2, mode3) (``_luma_passes``:
  the sweeps, one select over every class, the TU-RDs, one pick) and
  each chroma class's (dir, cost) (its candidates, from the ids the luma
  class's pick wrote, picked by ``chroma_pick_plain``), the NxN variant
  included, against the parent's route (a copy of the former
  ``_size_pass_impl`` and ``_chroma_pass_impl`` below: the 35-mode
  stacks, the top-3 gathered from them, ``_tq_rd``): exact, floats bit
  for bit;
- ``_predict_modes`` (the listed modes only) against the 35-mode stack
  gather, luma and chroma, every class and both bit increments: exact;
- ``decide_frame`` against the parent's route (those passes and the
  former ``_dp_expand``, ``dp_expand_plain``; exact) and the JAX
  package's (the six maps on at least 99.9% of the units, as
  ``tests/test_torch_fast_intra.py``);
- the given-prediction entry (inter items, per-item QPs, sizes 4..64 and
  -32) against ``_tq_rd`` (exact) and the JAX package's ``_tq_rd`` (dist
  exact, bits within rtol 1e-5).

The kernels' level-bit table (counts of 2^-23) sums, rounded to float32
once, to the plain form's float64 sum.  The bindings' checks refuse CPU
tensors, dtypes, shapes, sizes, bit increments and a plane too small for
its blocks' reference lines before anything is built.  The kernels
against their plain forms on the card: ``tests/test_torch_kernels.py``
(``-m gpu``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from thevc_tpu.encoder import fast_intra as ref
from thevc_tpu_torch.common.tables import from_reference
from thevc_tpu_torch.encoder import fast_intra as fi
from thevc_tpu_torch.ops import build, intra_rd_kernel
from thevc_tpu_torch.ops.intra import (DC_IDX, HOR_IDX, INTRA_FILTER_THRESH,
                                       PLANAR_IDX, VER_IDX)

# the decision pass encodes on the CPU here: one intra-op thread, so
# that the test workers do not oversubscribe the cores
torch.set_num_threads(1)

SIZES = (4, 8, 16, 32, 64)
BIT_RTOL = 1e-5
AGREE = 0.999


def _content(rng, h: int, w: int, bit_inc: int) -> np.ndarray:
    """Seeded picture content: a ramp, a texture and noise."""
    hi = 256 << bit_inc
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
    noise = rng.randint(0, 24, (h, w))
    return ((base + noise) * (1 << bit_inc) % hi).astype(np.int16)


def _frame(name: str) -> tuple:
    """decide_frame's positional arguments for one test frame."""
    w, h, ctu, bit_inc, seed = {"64x64": (64, 64, 32, 0, 11),
                                "128x64": (128, 64, 64, 2, 12)}[name]
    rng = np.random.RandomState(seed)
    y = _content(rng, h, w, bit_inc)
    cb = _content(rng, h // 2, w // 2, bit_inc)
    cr = _content(rng, h // 2, w // 2, bit_inc)
    qp = 32 + 6 * bit_inc
    max_sig = 3 if ctu == 32 else 4
    return (y, cb, cr, w, h, qp, qp - 2, qp - 1, 57.0, 7.55,
            (1.0, 2.0, 5.5), (0.5, 3.5, 1.1), max_sig, 2, ctu, bit_inc,
            (256 << bit_inc) - 1)


FRAMES = ("64x64", "128x64")


def _planes(args) -> tuple:
    """(py, pcb, pcr) as dispatch_frame uploads them (int16 CPU tensors),
    the CTU-padded size and the frame's scalars."""
    y, cb, cr, w, h = args[:5]
    ctu, bit_inc, max_val = args[14:17]
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    planes = tuple(torch.from_numpy(np.ascontiguousarray(p, np.int16))
                   for p in fi._source_planes(y, cb, cr, w, h, ctu))
    return planes, wp, hp, ctu, bit_inc, max_val


def _classes():
    return [(f, s) for f in FRAMES for s in SIZES
            if s <= _frame(f)[14]]


def _scalars(args):
    """_frame_body's per-frame scalars as 0-d tensors."""
    qp, qp_cb, qp_cr = (torch.tensor(v, dtype=torch.int32)
                        for v in args[5:8])
    f = [torch.tensor(v, dtype=torch.float32)
         for v in (args[8], args[9], *args[10], *args[11])]
    return (qp, qp_cb, qp_cr), ((f[2], f[3], f[4]), f[1], f[0]), \
        ((f[5], f[6]), f[0], f[7])


# -- the parent's route: the former size and chroma passes, unchanged but
# for the module prefix


def _parent_size_pass(ppad, size: int, nby: int, nbx: int, qp_scaled,
                    sqrt_lam_bits3, bit_inc: int, max_val: int,
                    ctu_size: int):
    """One luma size class over the whole frame -> (best mode, dist, bits,
    second mode, third mode), each [nby, nbx] (bits includes the mode
    bits, in whole bits)."""
    s = size
    dev = ppad.device
    ra, rl = fi._gather_lines(ppad, s, nby, nbx)
    nb = nby * nbx
    org = fi._blocks(ppad, s, nby, nbx)
    ra_f = fi._smooth(ra, rl)
    rl_f = fi._smooth(rl, ra)

    log2 = s.bit_length() - 1
    filt_pl = (min(abs(PLANAR_IDX - HOR_IDX), abs(PLANAR_IDX - VER_IDX))
               > INTRA_FILTER_THRESH[log2])
    pred_pl = fi._predict_mode(ra_f if filt_pl else ra,
                            rl_f if filt_pl else rl, s, PLANAR_IDX, max_val)
    pred_dc = fi._predict_mode(ra, rl, s, DC_IDX, max_val)
    pred_ang = fi._predict_all_angular(ra, rl, ra_f, rl_f, s, max_val)
    preds_all = torch.cat([pred_pl[:, None], pred_dc[:, None], pred_ang],
                          dim=1).to(torch.int16)       # [N, 35, s, s]
    satd_all = fi.satd_blocks(org.to(torch.int16), preds_all, bit_inc)

    # open-loop MPM: the neighbours' SATD-best modes
    best_a = satd_all.argmin(dim=1).to(torch.int32).reshape(nby, nbx)
    dc_col = torch.full((nby, 1), DC_IDX, dtype=torch.int32, device=dev)
    dc_row = torch.full((1, nbx), DC_IDX, dtype=torch.int32, device=dev)
    left = torch.cat([dc_col, best_a[:, :-1]], dim=1)
    above = torch.cat([dc_row, best_a[:-1, :]], dim=0)
    # an above PU outside the current CTU row reads as DC
    # (TComDataCU.cpp:1931)
    if s < ctu_size:
        in_ctu = torch.from_numpy(
            (np.arange(nby) * s) % ctu_size != 0).to(dev)
        above = torch.where(in_ctu[:, None], above, DC_IDX)
    else:
        above = torch.full_like(above, DC_IDX)
    m0, m1, m2 = fi._mpm_vec(left.reshape(-1), above.reshape(-1))

    modes = torch.arange(35, dtype=torch.int32, device=dev)[None, :]
    (b0, b12, bo), sqrt_lam, lam = sqrt_lam_bits3
    bits_plain = torch.where(
        modes == m0[:, None], b0,
        torch.where((modes == m1[:, None]) | (modes == m2[:, None]), b12,
                    bo))
    cost = satd_all.to(torch.float32) + bits_plain * sqrt_lam

    # the top-K SATD+bits candidates go on to an RD estimate
    # (TEncSearch.cpp:2560-2590); a stable sort keeps tied candidates in
    # index order, as jax.lax.top_k does
    k = fi._TOP_K
    topk = torch.sort(cost, dim=1, stable=True).indices[:, :k]
    preds_k = preds_all.gather(
        1, topk[:, :, None, None].expand(nb, k, s, s))
    org_k = org[:, None].expand(nb, k, s, s)
    dist_k, cbits_k = fi._tq_rd(org_k.reshape(nb * k, s, s),
                             preds_k.reshape(nb * k, s, s), s, qp_scaled,
                             bit_inc, max_val)
    dist_k = dist_k.reshape(nb, k)
    bits_k = cbits_k.reshape(nb, k) + bits_plain.gather(1, topk)
    rd_k = dist_k.to(torch.float32) + lam * bits_k
    sel = rd_k.argmin(dim=1)
    best = topk.gather(1, sel[:, None])[:, 0]
    dist = dist_k.gather(1, sel[:, None])[:, 0]
    bits = bits_k.gather(1, sel[:, None])[:, 0]
    # runner-up modes, re-evaluated by the apply pass against real
    # reconstructed neighbours
    rows = torch.arange(nb, device=dev)
    rd_masked = rd_k.clone()
    rd_masked[rows, sel] = float("inf")
    sel2 = rd_masked.argmin(dim=1)
    mode2 = topk.gather(1, sel2[:, None])[:, 0]
    rd_masked[rows, sel2] = float("inf")
    sel3 = rd_masked.argmin(dim=1)
    mode3 = topk.gather(1, sel3[:, None])[:, 0]
    return tuple(v.reshape(nby, nbx) for v in (best, dist, bits, mode2,
                                               mode3))


def _parent_chroma_pass(cbpad, crpad, size: int, nby: int, nbx: int,
                      luma_best, dm, qp_cb, qp_cr, lam_w_bits2,
                      bit_inc: int, max_val: int):
    """The 5-candidate chroma mode RD for luma-size-class ``size`` CUs:
    {planar, ver, hor, dc} with the luma-duplicate slot replaced by
    angular 34, plus DM (TEncSearch::estIntraPredChromaQT).  ``dm`` is
    the DM-reference luma mode per block.  Returns (the stored chroma dir
    [nby, nbx], the mode value or 36 for DM; the winner's RD cost
    [nby, nbx] float32).

    The RD estimate treats 4x4 chroma TUs as intra luma ones and uses
    the DST, as the reference does (fast_intra.py:586, ROADMAP R11),
    where HM uses the DCT for chroma."""
    (bits_dm, bits_oth), lam, cw = lam_w_bits2
    c = size // 2                      # chroma block size (>= 4)
    nb = nby * nbx
    dev = cbpad.device
    dm = dm.reshape(-1).long()
    luma_best = luma_best.reshape(-1).to(torch.int32)
    fixed = (PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX)

    def cands_of(ppad):
        ra, rl = fi._gather_lines(ppad, c, nby, nbx)
        # the full 35-mode stack (chroma: unfiltered refs, no DC/edge
        # filters)
        pred_all = torch.cat([
            fi._predict_mode(ra, rl, c, PLANAR_IDX, max_val,
                             luma=False)[:, None],
            fi._predict_mode(ra, rl, c, DC_IDX, max_val,
                             luma=False)[:, None],
            fi._predict_all_angular(ra, rl, ra, rl, c, max_val,
                                    luma=False)],
            dim=1)                                     # [N, 35, c, c]
        p34 = pred_all[:, 34]
        outs = [torch.where((luma_best == fm)[:, None, None], p34,
                            pred_all[:, fm]) for fm in fixed]
        outs.append(pred_all.gather(
            1, dm[:, None, None, None].expand(nb, 1, c, c))[:, 0])
        return torch.stack(outs, dim=1).reshape(nb * 5, c, c)

    def org5(ppad):
        return fi._blocks(ppad, c, nby, nbx)[:, None].expand(
            nb, 5, c, c).reshape(nb * 5, c, c)

    # a 64-CU's chroma transforms at 16 (the luma TU split to 32 is
    # mandatory, so the chroma tree follows): quadrant transforms
    tq_size = -32 if c == 32 else c
    d_cb, b_cb = fi._tq_rd(org5(cbpad), cands_of(cbpad), tq_size,
                        qp_cb.expand(nb * 5), bit_inc, max_val)
    d_cr, b_cr = fi._tq_rd(org5(crpad), cands_of(crpad), tq_size,
                        qp_cr.expand(nb * 5), bit_inc, max_val)
    dist = (d_cb + d_cr).reshape(nb, 5).to(torch.float32)
    cbits = (b_cb + b_cr).reshape(nb, 5)
    mbits = torch.stack([bits_oth, bits_oth, bits_oth, bits_oth,
                         bits_dm])[None, :]
    cost = cw * dist + lam * (cbits + mbits)
    sel = cost.argmin(dim=1)
    best_cost = cost.gather(1, sel[:, None])[:, 0]
    # the stored direction value per candidate slot
    vals = [torch.where(luma_best == fm, 34, fm) for fm in fixed]
    vals.append(torch.full((nb,), fi.DM_CHROMA_IDX, dtype=torch.int32,
                           device=dev))
    vals = torch.stack([v.to(torch.int32) for v in vals], dim=1)
    best_val = vals.gather(1, sel[:, None])[:, 0]
    return best_val.reshape(nby, nbx), best_cost.reshape(nby, nbx)


@pytest.fixture(scope="module")
def frames():
    return {name: _frame(name) for name in FRAMES}


@pytest.fixture(scope="module")
def luma_passes(frames):
    """Each frame's luma classes (``fi._luma_passes``: the sweeps, one
    select over every class, the TU-RDs, one pick), computed once."""
    out = {}
    for name, args in frames.items():
        (py, _, _), wp, hp, ctu, bit_inc, max_val = _planes(args)
        (qp, _, _), bits3, _ = _scalars(args)
        out[name] = fi._luma_passes(py, wp, hp, qp, bits3, bit_inc, max_val,
                                    ctu)
    return out


def test_level_bit_units_are_exact():
    units = fi._level_bits_units_table()
    assert units.dtype == np.int32 and units.shape == (32769,)
    np.testing.assert_array_equal(
        units.astype(np.float64) / float(1 << 23),
        fi._LEVEL_BITS.astype(np.float64))


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_level_bit_units_sum_equals_float64_sum(size):
    # the kernel's sum: int64 counts of 2^-23, rounded to float32 once;
    # the plain form's: the float32 values summed in float64, rounded once
    rng = np.random.RandomState(size)
    levels = (rng.standard_cauchy((500, size, size)) * 40).clip(
        -32768, 32767).astype(np.int64)
    levels[rng.rand(*levels.shape) < 0.5] = 0
    absl = np.minimum(np.abs(levels), 32768)
    units = fi._level_bits_units_table()[absl].astype(np.int64).sum(
        axis=(1, 2))
    got = (units.astype(np.float32) * np.float32(2.0 ** -23)).astype(
        np.float32)
    want = fi._LEVEL_BITS[absl].astype(np.float64).sum(axis=(1, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _jax_satd(ppad: np.ndarray, s: int, nby: int, nbx: int, bit_inc: int,
              max_val: int) -> np.ndarray:
    """The JAX package's size pass up to its SATD: the unified 35-mode
    stack (``_predict_mode``, ``_predict_all_angular``) and ``_satd_d``."""
    filt = min(HOR_IDX, VER_IDX) > INTRA_FILTER_THRESH[s.bit_length() - 1]

    @jax.jit
    def run(p):
        ra, rl = ref._gather_lines(p, s, nby, nbx)
        nb = nby * nbx
        org = (p[1:1 + nby * s, 1:1 + nbx * s].reshape(nby, s, nbx, s)
               .transpose(0, 2, 1, 3).reshape(nb, s, s).astype(jnp.int32))

        def smooth(a, other):
            mid = (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2
            corner = (other[:, 1] + 2 * a[:, 0] + a[:, 1] + 2) >> 2
            return jnp.concatenate([corner[:, None], mid, a[:, -1:]], axis=1)
        ra_f, rl_f = smooth(ra, rl), smooth(rl, ra)
        pl = ref._predict_mode(ra_f if filt else ra, rl_f if filt else rl,
                               s, PLANAR_IDX, max_val)
        dc = ref._predict_mode(ra, rl, s, DC_IDX, max_val)
        ang = ref._predict_all_angular(ra, rl, ra_f, rl_f, s, max_val)
        preds = jnp.concatenate([pl[:, None], dc[:, None], ang],
                                axis=1).astype(jnp.int16)
        diff = org[:, None] - preds.astype(jnp.int32)
        return ref._satd_d(diff.reshape(nb * 35, s, s), s,
                           bit_inc).reshape(nb, 35)
    return np.asarray(run(jnp.asarray(ppad.astype(np.int32))))


@pytest.mark.parametrize("frame,s", _classes())
def test_sweep_equals_jax_satd(frames, frame, s):
    (py, _, _), wp, hp, _, bit_inc, max_val = _planes(frames[frame])
    nby, nbx = hp // s, wp // s
    satd, best = fi.intra_sweep(py, s, nby, nbx, bit_inc, max_val)
    assert satd.dtype == best.dtype == torch.int32
    assert satd.shape == (nby * nbx, 35) and best.shape == (nby * nbx,)
    want = _jax_satd(py.numpy(), s, nby, nbx, bit_inc, max_val)
    np.testing.assert_array_equal(satd.numpy(), want)
    np.testing.assert_array_equal(best.numpy(), want.argmin(axis=1))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    if a.dtype == torch.float32:
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("frame,s", _classes())
def test_size_pass_equals_parent_route(frames, luma_passes, frame, s):
    args = frames[frame]
    (py, _, _), wp, hp, ctu, bit_inc, max_val = _planes(args)
    (qp, _, _), bits3, _ = _scalars(args)
    got = luma_passes[frame][s]
    want = _parent_size_pass(py, s, hp // s, wp // s, qp, bits3, bit_inc,
                             max_val, ctu)
    # the modes are int32 since the pick's kernel (the parent's sort
    # indices were int64); the values are compared exactly
    want = [w.to(torch.int32) if w.dtype == torch.int64 else w
            for w in want]
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("frame,s", [(f, s) for f, s in _classes()
                                     if s >= 8] + [(f, "nxn")
                                                   for f in FRAMES])
def test_chroma_pass_equals_parent_route(frames, luma_passes, frame, s):
    args = frames[frame]
    (py, pcb, pcr), wp, hp, ctu, bit_inc, max_val = _planes(args)
    (qp, qp_cb, qp_cr), bits3, bits2 = _scalars(args)
    if s == "nxn":
        # the NxN variant: DM is the top-left 4x4's mode
        luma = luma_passes[frame][4]
        dm = luma[0][0::2, 0::2]
        s = 8
    else:
        luma = luma_passes[frame][s]
        dm = luma[0]
    # the candidates' ids come from the luma class's pick, the pick of
    # the candidates from the DP's first step
    got = fi.chroma_pick_plain(fi._chroma_pass_impl(
        pcb, pcr, s, hp // s, wp // s, luma.cids, qp_cb, qp_cr, bit_inc,
        max_val), bits2)
    want = _parent_chroma_pass(pcb, pcr, s, hp // s, wp // s, dm, dm, qp_cb,
                               qp_cr, bits2, bit_inc, max_val)
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("luma", [True, False])
def test_predict_modes_equal_stack_gather(luma, s, bit_inc):
    rng = np.random.RandomState(s + 7 * bit_inc + 50 * luma)
    nby, nbx = 2, 3
    plane = torch.from_numpy(_content(rng, nby * s + 2 * s + 1,
                                      nbx * s + 2 * s + 1, bit_inc))
    max_val = (256 << bit_inc) - 1
    ra, rl = fi._gather_lines(plane, s, nby, nbx)
    if luma:
        ra_f, rl_f = fi._smooth(ra, rl), fi._smooth(rl, ra)
        filt = 10 > INTRA_FILTER_THRESH[s.bit_length() - 1]
    else:
        ra_f, rl_f, filt = ra, rl, False
    stack = torch.cat([
        fi._predict_mode(ra_f if filt else ra, rl_f if filt else rl, s,
                         PLANAR_IDX, max_val, luma)[:, None],
        fi._predict_mode(ra, rl, s, DC_IDX, max_val, luma)[:, None],
        fi._predict_all_angular(ra, rl, ra_f, rl_f, s, max_val, luma)],
        dim=1)
    modes = torch.from_numpy(np.stack([rng.permutation(35)[:7]
                                       for _ in range(nby * nbx)]).astype(
        np.int32))
    modes[0, :4] = torch.tensor([HOR_IDX, VER_IDX, PLANAR_IDX, DC_IDX])
    got = fi._predict_modes(plane, s, nby, nbx, modes, max_val, luma)
    want = stack.gather(1, modes.long()[:, :, None, None].expand(
        -1, -1, s, s))
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def _parent_frame_body(py, pcb, pcr, iscal, fscal, wp: int, hp: int,
                       statics, max_sig: int, min_tr_log2: int):
    """The parent's ``_frame_body``: its size and chroma passes (above)
    and its DP (``dp_expand_plain``, the former ``_dp_expand``)."""
    width, height, bit_inc, max_val, ctu_size = statics
    qp_scaled, qp_cb, qp_cr = iscal[0], iscal[1], iscal[2]
    lam, sqrt_lam = fscal[0], fscal[1]
    sqrt_lam_bits3 = ((fscal[2], fscal[3], fscal[4]), sqrt_lam, lam)
    lam_w_bits2 = ((fscal[5], fscal[6]), lam, fscal[7])
    res = {s: _parent_size_pass(py, s, hp // s, wp // s, qp_scaled,
                                sqrt_lam_bits3, bit_inc, max_val, ctu_size)
           for s in SIZES if s <= ctu_size}
    cres = {s: _parent_chroma_pass(pcb, pcr, s, hp // s, wp // s, res[s][0],
                                   res[s][0], qp_cb, qp_cr, lam_w_bits2,
                                   bit_inc, max_val)
            for s in SIZES if 8 <= s <= ctu_size}
    dm_nxn = res[4][0][0::2, 0::2]
    cres8_nxn = _parent_chroma_pass(pcb, pcr, 8, hp // 8, wp // 8, dm_nxn,
                                    dm_nxn, qp_cb, qp_cr, lam_w_bits2,
                                    bit_inc, max_val)
    return fi.dp_expand_plain(res, cres, cres8_nxn, width, height, lam,
                              max_sig, min_tr_log2, ctu_size, wp, hp)


def _decide_with_parent_route(args):
    real = fi._frame_body
    fi._frame_body = _parent_frame_body
    try:
        return fi.decide_frame(*args, device="cpu")
    finally:
        fi._frame_body = real


@pytest.mark.parametrize("frame", FRAMES)
def test_decide_frame_equals_parent_route_and_jax(frames, frame,
                                                  monkeypatch):
    args = frames[frame]
    maps = fi.decide_frame(*args, device="cpu")
    for a, b in zip(maps, _decide_with_parent_route(args)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    monkeypatch.setenv("THEVC_FASTRD_UNIFIED", "1")
    monkeypatch.setenv("THEVC_DEVICE", "0")
    ref._frame_pass_cache.clear()
    try:
        maps_j = ref.decide_frame(*args)
    finally:
        ref._frame_pass_cache.clear()
    names = ("depth", "mode", "nxn", "chroma", "mode2", "mode3")
    for name, a, b in zip(names, maps_j, maps):
        assert b.dtype == a.dtype and b.shape == a.shape
        mismatch = int((a != b).sum())
        print(f"{frame} {name}: {mismatch} of {a.size} units differ")
        assert mismatch <= (1 - AGREE) * a.size, (name, mismatch)


@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, -32])
def test_tu_rd_given_equals_tq_rd_and_jax(size, bit_inc):
    s = abs(size)
    rng = np.random.RandomState(s + bit_inc)
    n = 23
    max_val = (256 << bit_inc) - 1
    org = rng.randint(0, max_val + 1, (n, s, s)).astype(np.int16)
    pred = np.clip(org + rng.randint(-30 << bit_inc, 30 << bit_inc,
                                     (n, s, s)), 0, max_val).astype(np.int16)
    pred[:2] = org[:2]                           # all-zero TUs
    qp = rng.randint(6 * bit_inc, 52 + 6 * bit_inc, n).astype(np.int32)
    t = (torch.from_numpy(org), torch.from_numpy(pred))
    d, b = fi.tu_rd(*t, size, torch.from_numpy(qp), bit_inc, max_val,
                    is_intra=False)
    d0, b0 = fi._tq_rd(*t, size, torch.from_numpy(qp), bit_inc, max_val,
                       is_intra=False)
    _same(d, d0)
    _same(b, b0)
    d_j, b_j = ref._tq_rd(jnp.asarray(org), jnp.asarray(pred), size,
                          jnp.asarray(qp), bit_inc, max_val, is_intra=False)
    np.testing.assert_array_equal(np.asarray(d_j), d.numpy())
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=BIT_RTOL,
                               atol=0)


def test_entries_refuse_other_devices():
    meta = torch.empty((200, 200), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fi.intra_sweep(meta, 8, 2, 2, 0, 255)
    modes = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fi.tu_rd_modes((meta,), 8, 2, 2, modes, (torch.tensor(30),), 0,
                       255, True)
    blocks = torch.empty((4, 8, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fi.tu_rd(blocks, blocks, 8, torch.tensor(30), 0, 255)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything would be compiled or loaded."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "compile_source", refuse)


def _rd_tables(tsize: int) -> tuple:
    return (from_reference("cpu").basis(tsize, False),
            fi._level_bits_units(torch.device("cpu")))


def test_kernel_entries_refuse_cpu_tensors(no_build):
    plane = torch.zeros((200, 200), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        intra_rd_kernel.sweep(plane, 8, 2, 2, 0, 255)
    blocks = torch.zeros((4, 8, 8), dtype=torch.int16)
    qp = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        intra_rd_kernel.tu_rd_given(blocks, blocks, qp, *_rd_tables(8), 8,
                                    False, 0, 255)
    modes = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        intra_rd_kernel.tu_rd_intra((plane,), modes, qp, *_rd_tables(8), 8,
                                    2, 2, True, 0, 255)


def _sweep_refusals():
    ok = dict(plane=torch.zeros((2 * 8 + 8 + 1, 3 * 8 + 8 + 1),
                                dtype=torch.int16), size=8, nby=2, nbx=3,
              bit_increment=0, max_val=255)
    cases = {
        "dtype": (dict(plane=ok["plane"].to(torch.int32)), TypeError),
        "not 2-d": (dict(plane=ok["plane"][None]), ValueError),
        "strided": (dict(plane=torch.zeros((60, 60), dtype=torch.int16)
                         [:, ::2]), ValueError),
        "size": (dict(size=12), ValueError),
        "bit increment": (dict(bit_increment=9), ValueError),
        "max_val": (dict(max_val=0), ValueError),
        "too few rows": (dict(plane=ok["plane"][1:].contiguous()),
                         ValueError),
        "too few columns": (dict(plane=ok["plane"][:, 1:].contiguous()),
                            ValueError),
        "empty grid": (dict(nby=0), ValueError)}
    return ok, cases


@pytest.mark.parametrize("case", sorted(_sweep_refusals()[1]))
def test_check_sweep_refuses(no_build, case):
    ok, cases = _sweep_refusals()
    edit, err = cases[case]
    intra_rd_kernel.check_sweep(**ok)
    with pytest.raises(err):
        intra_rd_kernel.check_sweep(**dict(ok, **edit))


def _given_refusals():
    blocks = torch.zeros((5, 16, 16), dtype=torch.int16)
    basis, lb = _rd_tables(16)
    ok = dict(org=blocks, pred=blocks.clone(),
              qp=torch.zeros(5, dtype=torch.int32), basis=basis,
              level_bits=lb, size=16, bit_increment=0, max_val=255)
    cases = {
        "org dtype": (dict(org=blocks.to(torch.int32)), TypeError),
        "pred dtype": (dict(pred=blocks.to(torch.int32)), TypeError),
        "pred shape": (dict(pred=blocks[:4].clone()), ValueError),
        "qp shape": (dict(qp=torch.zeros(4, dtype=torch.int32)),
                     ValueError),
        "qp dtype": (dict(qp=torch.zeros(5, dtype=torch.int64)), TypeError),
        "size": (dict(size=12), ValueError),
        "size of blocks": (dict(size=8), ValueError),
        "basis of another size": (dict(basis=_rd_tables(8)[0]), ValueError),
        # a 64 block's TUs are 32x32: the 16x16 basis does not fit
        "quadrant basis": (dict(size=64, org=torch.zeros(
            (5, 64, 64), dtype=torch.int16), pred=torch.zeros(
            (5, 64, 64), dtype=torch.int16)), ValueError),
        "level bits": (dict(level_bits=lb[:-1]), ValueError),
        "strided": (dict(org=torch.zeros((5, 16, 32),
                                         dtype=torch.int16)[:, :, ::2]),
                    ValueError),
        "bit increment": (dict(bit_increment=-1), ValueError)}
    return ok, cases


@pytest.mark.parametrize("case", sorted(_given_refusals()[1]))
def test_check_given_refuses(no_build, case):
    ok, cases = _given_refusals()
    edit, err = cases[case]
    intra_rd_kernel.check_given(**ok)
    with pytest.raises(err):
        intra_rd_kernel.check_given(**dict(ok, **edit))


def _intra_refusals():
    plane = torch.zeros((2 * 32 + 32 + 1, 2 * 32 + 32 + 1),
                        dtype=torch.int16)
    basis, lb = _rd_tables(16)
    ok = dict(planes=(plane, plane.clone()),
              modes=torch.zeros((4, 5), dtype=torch.int32),
              qp=torch.zeros(40, dtype=torch.int32), basis=basis,
              level_bits=lb, size=-32, nby=2, nbx=2, bit_increment=2,
              max_val=1023)
    cases = {
        "three planes": (dict(planes=(plane,) * 3), ValueError),
        "planes differ": (dict(planes=(plane, plane[:-1].contiguous())),
                          ValueError),
        "plane too small": (dict(planes=(plane[:-1].contiguous(),
                                         plane[:-1].contiguous())),
                            ValueError),
        "modes dtype": (dict(modes=torch.zeros((4, 5), dtype=torch.int64)),
                        TypeError),
        "modes rows": (dict(modes=torch.zeros((3, 5), dtype=torch.int32)),
                       ValueError),
        "qp of one plane": (dict(qp=torch.zeros(20, dtype=torch.int32)),
                            ValueError),
        "size": (dict(size=-16), ValueError),
        "basis": (dict(basis=_rd_tables(32)[0]), ValueError),
        "bit increment": (dict(bit_increment=12), ValueError)}
    return ok, cases


@pytest.mark.parametrize("case", sorted(_intra_refusals()[1]))
def test_check_intra_refuses(no_build, case):
    ok, cases = _intra_refusals()
    edit, err = cases[case]
    intra_rd_kernel.check_intra(**ok)
    with pytest.raises(err):
        intra_rd_kernel.check_intra(**dict(ok, **edit))


def test_entries_match_the_c_signatures():
    # the argument lists the ctypes binding declares, against the
    # source's extern "C" declarations
    import re
    src = (build.CSRC / "intra_rd.cu").read_text()
    for fn, argtypes in intra_rd_kernel._ENTRIES.items():
        m = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)', src)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), fn
        for p, t in zip(params, argtypes):
            want = "void*" in p and t is intra_rd_kernel._P \
                or p.startswith("long long") and t is intra_rd_kernel._L \
                or p.startswith("int ") and t is intra_rd_kernel._I
            assert want, (fn, p, t)
