"""Fast-RD intra decisions in PyTorch: the decision pass of ``--FastRD=1``.

A port of the device half of ``thevc_tpu/encoder/fast_intra.py``.  For
one frame, open-loop (reference samples come from the source picture):

1. per luma size class 4..64, every block of the frame at once: the
   reference lines, all 35 intra predictions and the Hadamard SATD of
   each against the source (``intra_sweep``), the mode-bit estimate,
   then for the 3 best candidates a forward transform + quant + recon RD
   estimate (``tu_rd_modes``);
2. per size class >= 8, the 5-candidate chroma mode RD (``tu_rd_modes``
   on the Cb and Cr planes at once);
3. a bottom-up quadtree DP, expanded to six int8 maps per 4x4 unit.

The work sits behind entries that dispatch on the device of their
input, as ``ops.satd.satd_blocks`` does: on a CUDA tensor each launches
a hand-written kernel (and raises if it cannot), on a CPU tensor it runs
its plain form, and any other device raises.  ``_luma_passes`` runs
per luma class ``intra_sweep`` (the sweep kernel, ``csrc/intra_rd.cu``),
then over every luma class at once ``intra_select`` (the MPM, mode bits,
costs and the top 3: kernel A of ``csrc/intra_select.cu``, one launch),
per class ``tu_rd_modes`` (the TU-RD kernel of ``csrc/intra_rd.cu``;
``tu_rd`` is its entry for predictions given as tensors, which the P/B
pass calls), then over every class ``intra_pick`` (the RD pick and the
chroma candidates' ids: kernel B, one launch); per chroma class
``tu_rd_modes`` of the five candidates on Cb and Cr; per frame
``_dp_expand`` (the chroma picks, the quadtree DP and the unit maps:
kernel C, one launch).
No kernel writes a prediction, coefficient or reconstruction to device
memory.  The plain forms (``intra_sweep_plain``: the 35-mode stack and
``ops.satd``; ``tu_rd_modes_plain``: the listed modes' predictions and
``_tq_rd``; ``_tq_rd``: ``ops.tq`` with its residual pipeline;
``intra_select_pass_plain`` and ``intra_pick_pass_plain``, which run the
per-class ``intra_select_plain`` and ``intra_pick_plain`` class by
class, and ``intra_dp_plain``: the torch glue they replaced) run on a
CUDA tensor too, the first three through the SATD (K2) and residual (K1)
kernels, when called by name, as ``chip_smoke.py`` does to time the two
routes against each other.

The maps feed the encoder's native apply pass (``nat.set_fd``), which
writes a conformant stream.  The host-only parts of the reference module
(the static prediction plans, ``SIZES``, ``DM_CHROMA_IDX``, and the
mode-bit classes ``chroma_bits2`` and ``mode_bits3`` that
``slice_encoder`` calls) are copied here unchanged.

Only the reference's unified all-modes form of the size pass is ported
(its per-mode form exists for XLA:CPU compile times and gives the same
maps).  The transform RD estimate and the DP carry the inter branches
that the P/B pass (``encoder.fast_inter``) uses.

Float order.  The decisions rank candidates by float32 costs, so the
port fixes its own order of float operations, and its CPU and CUDA forms
decide identically:

- the per-level bit cost is a float32 table evaluated once in numpy and
  indexed by ``|level|`` (no ``log2`` on two backends);
- bit sums accumulate in float64, where they are exact (the table's
  values are multiples of 2^-23 below 2^5), and round to float32 once;
- the per-frame scalars are float32 tensors, and every ``a + b * c`` is
  two separate eager ops (no fused multiply-add);
- the top-3 candidates come from a stable ascending sort, so ties keep
  index order as ``jax.lax.top_k`` does; ``argmin`` takes the first
  minimum on both backends; the kernels keep both orders.

Against the JAX package the integer stages are exact and the float
costs agree to a few float32 ulps (XLA's ``log2``, its sum order and its
fused multiply-adds differ from torch's), so the maps agree on at least
99.9% of units (on every test frame so far, on all of them); see
``tests/test_torch_fast_intra.py``.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..common.tables import from_reference
from ..ops import device as dev_stats
from ..ops import intra_rd_kernel, intra_select_kernel, tq
from ..ops.intra import (ANG_TABLE, INV_ANG_TABLE, INTRA_FILTER_THRESH,
                         DC_IDX, HOR_IDX, PLANAR_IDX, VER_IDX)
from ..ops.satd import satd_blocks

# -- thevc_tpu/encoder/fast_intra.py:58-163, unchanged

SIZES = (4, 8, 16, 32, 64)
DM_CHROMA_IDX = 36


# ---------------------------------------------------------------------------
# static per-(mode,size) index plans for batched angular prediction
# ---------------------------------------------------------------------------

def _angular_plan(size: int, mode: int):
    """Precompute the static gather plan for one angular mode.

    Returns (side_idx, n_main, off, delta_int, delta_frac, mode_hor):
    refmain = concat(side[side_idx], main[:n_main]); prediction row k
    (0-based) reads refmain[off + l + delta_int[k] + 1] lerped by
    delta_frac[k] (xPredIntraAng, TComPrediction.cpp:190).
    """
    mode_hor = mode < 18
    ipa = -(mode - HOR_IDX) if mode_hor else (mode - VER_IDX)
    abs_ang = int(ANG_TABLE[abs(ipa)])
    inv_angle = int(INV_ANG_TABLE[abs(ipa)])
    angle = -abs_ang if ipa < 0 else abs_ang

    if angle < 0:
        ext = (size * angle) >> 5            # negative
        side_idx = []
        inv_sum = 128
        for k in range(-1, ext, -1):
            inv_sum += inv_angle
            side_idx.append(inv_sum >> 8)
        side_idx.reverse()                   # refmain[ext+1..-1]
        n_main = size + 1                    # refmain[0..size]
        # the list holds refMain[ext+1..size] (refMain[ext] is never
        # read: the shallowest delta is one full step), so refMain[m]
        # sits at index m - ext - 1
        off = -ext - 1
    else:
        side_idx = []
        n_main = 2 * size + 1
        off = 0

    k = np.arange(1, size + 1, dtype=np.int64)
    delta = k * angle
    return (np.asarray(side_idx, np.int32), n_main, off,
            (delta >> 5).astype(np.int32), (delta & 31).astype(np.int32),
            mode_hor, angle)


_unified_plan_cache = {}


def _unified_plan(size: int, luma: bool):
    """Static gather plan for ALL 33 angular modes at once.

    The canonical reference array per block is c = concat(rl, ra[1:])
    (length L = 4s+1; index 0 is the shared corner), doubled as
    C = concat(c, c_filtered) so the per-mode [1 2 1]-filter choice
    (TComPrediction.cpp:385, INTRA_FILTER_THRESH) is just an index
    offset (chroma never filters: the caller passes the raw line twice).
    Returns (idx_a, idx_b, frac): three [33, s, s] int32 maps
    so every angular prediction (xPredIntraAng, TComPrediction.cpp:190)
    becomes ONE static gather + lerp — one XLA kernel instead of 33
    separately-compiled graphs (cold 1080p compile: minutes -> seconds).
    Horizontal modes bake the output transpose into the maps.
    """
    plan = _unified_plan_cache.get((size, luma))
    if plan is not None:
        return plan
    s = size
    L = 4 * s + 1
    log2 = s.bit_length() - 1

    def cidx(is_ra: bool, j: int) -> int:
        # index of ra[j]/rl[j] inside c = concat(rl, ra[1:])
        if j == 0:
            return 0
        return 2 * s + j if is_ra else j

    idx_a = np.zeros((33, s, s), np.int64)
    idx_b = np.zeros((33, s, s), np.int64)
    frac = np.zeros((33, s, s), np.int64)
    for mode in range(2, 35):
        side_idx, n_main, off, dint, dfrac, mode_hor, angle = \
            _angular_plan(s, mode)
        main_is_ra = not mode_hor
        refidx = [cidx(not main_is_ra, int(j)) for j in side_idx] + \
                 [cidx(main_is_ra, j) for j in range(n_main)]
        refidx = np.asarray(refidx, np.int64)
        ll = np.arange(s, dtype=np.int64)
        p = off + ll[None, :] + dint[:, None].astype(np.int64) + 1  # [s, s]
        ia = refidx[p]
        # b is only read where frac != 0; p+1 can run one past the end on
        # the frac==0 rows of mode 2/34-style full-stride angles — clamp
        ib = refidx[np.minimum(p + 1, len(refidx) - 1)]
        fr = np.broadcast_to(dfrac[:, None].astype(np.int64), (s, s))
        if mode_hor:
            ia, ib, fr = ia.T, ib.T, fr.T
        diff = min(abs(mode - HOR_IDX), abs(mode - VER_IDX))
        if luma and diff > INTRA_FILTER_THRESH[log2]:
            ia = ia + L
            ib = ib + L
        m = mode - 2
        idx_a[m], idx_b[m], frac[m] = ia, ib, fr
    plan = (idx_a.astype(np.int32), idx_b.astype(np.int32),
            frac.astype(np.int32))
    _unified_plan_cache[(size, luma)] = plan
    return plan



# -- the port's decision pass

# per-CU header-bit constants of the DP (fast_intra.py:608-610)
_CU_BITS = 5.0
_SPLIT_BITS = 1.0
_NXN_BITS = 3.0
_TOP_K = 3


def _level_bits_table() -> np.ndarray:
    """float32 bits of one coefficient level by |level| in 0..32768:
    0 for a zero level, else 1.7 + 2 * log2(|level| + 1), in float32 as
    ``_coeff_bits_est`` (fast_intra.py:326) computes it."""
    k = np.arange(32769, dtype=np.float32)
    bits = np.float32(1.7) + np.float32(2.0) * np.log2(k + np.float32(1.0))
    bits[0] = 0.0
    return bits.astype(np.float32)


_LEVEL_BITS = _level_bits_table()


@functools.lru_cache(maxsize=None)
def _level_bits(device: torch.device) -> torch.Tensor:
    """The level-bit table on ``device``."""
    return torch.from_numpy(_LEVEL_BITS).to(device)


def _level_bits_units_table() -> np.ndarray:
    """The level-bit table as int32 counts of 2^-23 (every value is such
    a multiple below 2^5, so the counts are exact and their int64 sum,
    rounded to float32 once, is the float64 sum of the table's values)."""
    units = _LEVEL_BITS.astype(np.float64) * float(1 << 23)
    out = units.astype(np.int32)
    if not np.array_equal(out.astype(np.float64), units):
        raise AssertionError("a level bit is no multiple of 2^-23")
    return out


@functools.lru_cache(maxsize=None)
def _level_bits_units(device: torch.device) -> torch.Tensor:
    """``_level_bits_units_table`` on ``device`` (the TU-RD kernel's)."""
    return torch.from_numpy(_level_bits_units_table()).to(device)


@functools.lru_cache(maxsize=None)
def _plan_tensors(size: int, luma: bool, device: torch.device):
    """A size class's unified angular plan (idx_a, idx_b, frac) on
    ``device``."""
    idx_a, idx_b, frac = _unified_plan(size, luma)
    return (torch.from_numpy(idx_a).long().to(device),
            torch.from_numpy(idx_b).long().to(device),
            torch.from_numpy(frac).to(device))


def _predict_all_angular(ra, rl, ra_f, rl_f, size: int, max_val: int,
                         luma: bool = True):
    """All 33 angular modes for a block batch in one gather: reference
    lines [N, 2s+1] x4 -> int32 [N, 33, s, s] (modes 2..34).  Chroma
    (``luma=False``) reads unfiltered lines and skips the mode 10/26 edge
    filter."""
    idx_a, idx_b, frac = _plan_tensors(size, luma, ra.device)
    if luma:
        c = torch.cat([rl, ra[:, 1:], rl_f, ra_f[:, 1:]], dim=1)
    else:
        c = torch.cat([rl, ra[:, 1:]], dim=1)
    pred = ((32 - frac) * c[:, idx_a] + frac * c[:, idx_b] + 16) >> 5
    if not luma:
        return pred
    s = size
    # pure-copy modes get the edge boundary filter (xPredIntraAng :268)
    d26 = (rl[:, 1:s + 1] - rl[:, 0:1]) >> 1
    pred[:, 26 - 2, :, 0] = (pred[:, 26 - 2, :, 0] + d26).clamp(0, max_val)
    d10 = (ra[:, 1:s + 1] - ra[:, 0:1]) >> 1
    pred[:, 10 - 2, 0, :] = (pred[:, 10 - 2, 0, :] + d10).clamp(0, max_val)
    return pred


def _predict_mode(ra, rl, size: int, mode: int, max_val: int,
                  luma: bool = True):
    """Planar or DC for a whole block batch: ra/rl [N, 2s+1] -> int32
    [N, s, s] (the angular modes go through ``_predict_all_angular``)."""
    n = ra.shape[0]
    dev = ra.device
    if mode == PLANAR_IDX:
        log2 = size.bit_length() - 1
        top = ra[:, 1:size + 2]
        left = rl[:, 1:size + 2]
        bottom = left[:, size][:, None] - top[:, :size]
        right = top[:, size][:, None] - left[:, :size]
        kk = torch.arange(1, size + 1, dtype=torch.int32, device=dev)
        hor = ((left[:, :size, None] << log2) + size
               + kk[None, None, :] * right[:, :size, None])
        ver = ((top[:, None, :size] << log2)
               + kk[None, :, None] * bottom[:, None, :size])
        return (hor + ver) >> (log2 + 1)
    if mode != DC_IDX:
        raise ValueError(f"mode {mode}: angular modes are predicted by "
                         "_predict_all_angular")
    s_sum = ra[:, 1:size + 1].sum(dim=1) + rl[:, 1:size + 1].sum(dim=1)
    dc = ((s_sum + size) // (2 * size)).to(torch.int32)
    pred = dc[:, None, None].expand(n, size, size).clone()
    if not luma:
        return pred
    # xDCPredFiltering (luma only)
    top = ra[:, 1:size + 1]
    left = rl[:, 1:size + 1]
    c00 = (top[:, 0] + left[:, 0] + 2 * dc + 2) >> 2
    pred[:, 0, :] = (top + 3 * dc[:, None] + 2) >> 2
    pred[:, :, 0] = (left + 3 * dc[:, None] + 2) >> 2
    pred[:, 0, 0] = c00
    return pred


def _mpm_vec(left, above):
    """Vectorised getIntraDirLumaPredictor (TComDataCU.cpp:1928): the
    three most probable modes per block, int32."""
    same = left == above
    big = left > 1
    m0_same = torch.where(big, left, PLANAR_IDX)
    m1_same = torch.where(big, ((left + 29) % 32) + 2, DC_IDX)
    m2_same = torch.where(big, ((left - 1) % 32) + 2, VER_IDX)
    both_nz = (left != 0) & (above != 0)
    third = torch.where(both_nz, PLANAR_IDX,
                        torch.where(left + above < 2, VER_IDX, DC_IDX))
    m0 = torch.where(same, m0_same, left)
    m1 = torch.where(same, m1_same, above)
    m2 = torch.where(same, m2_same, third.to(left.dtype))
    return m0.to(torch.int32), m1.to(torch.int32), m2.to(torch.int32)


def _coeff_bits_est(levels, size: int):
    """Coefficient-bit model in whole bits, float32 [N] for levels
    [N, s, s]: per nonzero level its table cost, 1.5 per coded 4x4
    subblock above 4x4, and 2 * log2(s) + 1 for the last position; 0.5
    for an all-zero TU (fast_intra.py:317)."""
    absl = levels.abs().clamp(max=32768)
    bits = _level_bits(levels.device)[absl.long()].to(torch.float64).sum(
        dim=(-2, -1)).to(torch.float32)
    nz = absl > 0
    if size > 4:
        cg_any = nz.reshape(nz.shape[0], size // 4, 4, size // 4, 4).any(
            dim=4).any(dim=2)
        bits = bits + 1.5 * cg_any.sum(dim=(1, 2)).to(torch.float32)
    log2 = size.bit_length() - 1
    return torch.where(nz.flatten(1).any(dim=1), bits + 2.0 * log2 + 1.0,
                       0.5)


def _quadrants(x, n: int, h: int, t: int):
    """[n, h*t, h*t] -> [n*h*h, t, t], quadrants in raster order per block."""
    return (x.reshape(n, h, t, h, t).permute(0, 1, 3, 2, 4)
            .reshape(h * h * n, t, t))


def _tq_rd(org, pred, size: int, qp_scaled, bit_inc: int, max_val: int,
           is_intra: bool = True):
    """Forward transform + quant + recon RD for one prediction per block:
    [N, s, s] -> (dist int32 [N], bits float32 [N]).  Intra blocks use the
    DST at 4x4 and the intra quant offset (171), inter blocks
    (``is_intra=False``) the DCT and the inter offset (85).
    ``qp_scaled`` is a 0-d tensor or one QP per block.  Size 64 evaluates
    the four 32x32 quadrants (the largest TU is 32); size -32 a 32-sized
    block as 16x16 quadrants (the chroma TUs of a 64 CU)."""
    n = org.shape[0]
    org = org.to(torch.int32)
    pred = pred.to(torch.int32)
    resi = org - pred
    if size in (64, -32):
        s, t = (64, 32) if size == 64 else (32, 16)
        h = s // t
        resi, porg, ppred = (_quadrants(x, n, h, t) for x in (resi, org,
                                                              pred))
        tsize, nq = t, h * h
    else:
        porg, ppred, tsize, nq = org, pred, size, 1
    qp = qp_scaled.to(torch.int32)
    if qp.dim():                      # per-block QP, tiled over quadrants
        qp = qp.repeat_interleave(nq) if nq > 1 else qp
    else:
        qp = qp.expand(resi.shape[0])
    use_dst = tsize == 4 and is_intra
    coeff = tq.forward_transform(resi, use_dst, bit_inc)
    levels, _ = tq.quant(coeff, qp, is_intra, bit_inc)
    bits = _coeff_bits_est(levels, tsize)
    recon = tq.tu_recon_pipeline(ppred, levels, qp, use_dst, bit_inc,
                                 max_val)
    d = (porg - recon).to(torch.int64)
    dist = (d * d).sum(dim=(-2, -1)) >> (2 * bit_inc)
    if nq > 1:
        dist = dist.reshape(n, nq).sum(dim=1)
        bits = bits.reshape(n, nq).to(torch.float64).sum(dim=1).to(
            torch.float32)
    return dist.to(torch.int32), bits


def _gather_lines(ppad, s: int, nby: int, nbx: int):
    """Per-block above/left reference lines from a padded plane (1 row and
    column of edge padding on top/left, >= 2s on bottom/right):
    int32 [nby*nbx, 2s+1] each."""
    dev = ppad.device
    ys = torch.arange(nby, device=dev) * s
    xs = torch.arange(nbx, device=dev) * s
    k = torch.arange(2 * s + 1, device=dev)
    ra = ppad[ys[:, None, None], xs[None, :, None] + k]
    rl = ppad[ys[:, None, None] + k, xs[None, :, None]]
    nb = nby * nbx
    return (ra.reshape(nb, 2 * s + 1).to(torch.int32),
            rl.reshape(nb, 2 * s + 1).to(torch.int32))


def _blocks(ppad, s: int, nby: int, nbx: int):
    """The source blocks of one size class: int32 [nby*nbx, s, s]."""
    o = ppad[1:1 + nby * s, 1:1 + nbx * s]
    return (o.reshape(nby, s, nbx, s).permute(0, 2, 1, 3)
            .reshape(nby * nbx, s, s).to(torch.int32))


def _smooth(a, other):
    """The [1 2 1]-filtered reference line (initAdiPattern,
    TComPattern.cpp:283)."""
    mid = (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2
    corner = (other[:, 1] + 2 * a[:, 0] + a[:, 1] + 2) >> 2
    return torch.cat([corner[:, None], mid, a[:, -1:]], dim=1)


def intra_sweep_plain(ppad, size: int, nby: int, nbx: int, bit_inc: int,
                      max_val: int):
    """The plain form of ``intra_sweep``: every block's reference lines,
    their smoothed twins, all 35 predictions as an int16 stack
    [N, 35, s, s] and ``ops.satd.satd_blocks`` over it."""
    s = size
    ra, rl = _gather_lines(ppad, s, nby, nbx)
    org = _blocks(ppad, s, nby, nbx)
    ra_f = _smooth(ra, rl)
    rl_f = _smooth(rl, ra)

    log2 = s.bit_length() - 1
    filt_pl = (min(abs(PLANAR_IDX - HOR_IDX), abs(PLANAR_IDX - VER_IDX))
               > INTRA_FILTER_THRESH[log2])
    pred_pl = _predict_mode(ra_f if filt_pl else ra,
                            rl_f if filt_pl else rl, s, PLANAR_IDX, max_val)
    pred_dc = _predict_mode(ra, rl, s, DC_IDX, max_val)
    pred_ang = _predict_all_angular(ra, rl, ra_f, rl_f, s, max_val)
    preds_all = torch.cat([pred_pl[:, None], pred_dc[:, None], pred_ang],
                          dim=1).to(torch.int16)       # [N, 35, s, s]
    satd_all = satd_blocks(org.to(torch.int16), preds_all, bit_inc)
    return satd_all, satd_all.argmin(dim=1).to(torch.int32)


def intra_sweep(ppad, size: int, nby: int, nbx: int, bit_inc: int,
                max_val: int):
    """The 35-mode sweep of one luma size class from the padded int16
    plane: (int32 SATD [nby*nbx, 35] in the order planar, DC, 2..34;
    int32 first-minimum mode [nby*nbx]).  On a CUDA tensor the sweep
    kernel (and raises if it cannot launch); on a CPU tensor the plain
    form."""
    if ppad.device.type == "cpu":
        return intra_sweep_plain(ppad, size, nby, nbx, bit_inc, max_val)
    if ppad.device.type != "cuda":
        raise ValueError(f"unsupported device {ppad.device}")
    return intra_rd_kernel.sweep(ppad, size, nby, nbx, bit_inc, max_val)


def _predict_modes(ppad, size: int, nby: int, nbx: int, modes,
                   max_val: int, luma: bool):
    """Each block's prediction in each of its listed modes: int32 mode
    ids [nby*nbx, k] -> int32 [nby*nbx, k, s, s], equal to gathering them
    from the 35-mode stack (luma: ``intra_sweep_plain``'s; chroma:
    unfiltered lines, no DC or edge filters), the angular modes through
    one gather of the unified plan's rows."""
    s = size
    nb, k = (int(v) for v in modes.shape)
    ra, rl = _gather_lines(ppad, s, nby, nbx)
    if luma:
        ra_f, rl_f = _smooth(ra, rl), _smooth(rl, ra)
        log2 = s.bit_length() - 1
        filt_pl = (min(abs(PLANAR_IDX - HOR_IDX), abs(PLANAR_IDX - VER_IDX))
                   > INTRA_FILTER_THRESH[log2])
        c = torch.cat([rl, ra[:, 1:], rl_f, ra_f[:, 1:]], dim=1)
    else:
        ra_f, rl_f, filt_pl = ra, rl, False
        c = torch.cat([rl, ra[:, 1:]], dim=1)
    pred_pl = _predict_mode(ra_f if filt_pl else ra, rl_f if filt_pl else rl,
                            s, PLANAR_IDX, max_val, luma)
    pred_dc = _predict_mode(ra, rl, s, DC_IDX, max_val, luma)
    idx_a, idx_b, frac = _plan_tensors(s, luma, ppad.device)
    m = modes.long()
    am = (m - 2).clamp(0, 32)
    ia, ib, fr = idx_a[am], idx_b[am], frac[am]         # [nb, k, s, s]
    ca = c.gather(1, ia.reshape(nb, -1)).reshape(nb, k, s, s)
    cb = c.gather(1, ib.reshape(nb, -1)).reshape(nb, k, s, s)
    ang = ((32 - fr) * ca + fr * cb + 16) >> 5
    if luma:
        # the pure-copy modes' edge filters (``_predict_all_angular``)
        d26 = ((rl[:, 1:s + 1] - rl[:, 0:1]) >> 1)[:, None, :]
        ang[:, :, :, 0] = torch.where(
            m[:, :, None] == VER_IDX,
            (ang[:, :, :, 0] + d26).clamp(0, max_val), ang[:, :, :, 0])
        d10 = ((ra[:, 1:s + 1] - ra[:, 0:1]) >> 1)[:, None, :]
        ang[:, :, 0, :] = torch.where(
            m[:, :, None] == HOR_IDX,
            (ang[:, :, 0, :] + d10).clamp(0, max_val), ang[:, :, 0, :])
    m4 = m[:, :, None, None]
    return torch.where(m4 == PLANAR_IDX, pred_pl[:, None],
                       torch.where(m4 == DC_IDX, pred_dc[:, None],
                                   ang)).to(torch.int32)


def tu_rd_modes_plain(planes, size: int, nby: int, nbx: int, modes, qps,
                      bit_inc: int, max_val: int, luma: bool):
    """The plain form of ``tu_rd_modes``: per plane the listed modes'
    predictions (``_predict_modes``) and ``_tq_rd`` against the source
    blocks, the planes' results concatenated."""
    s = abs(size)
    nb, k = (int(v) for v in modes.shape)
    dists, bits = [], []
    for plane, qp in zip(planes, qps):
        org = _blocks(plane, s, nby, nbx)[:, None].expand(nb, k, s, s)
        pred = _predict_modes(plane, s, nby, nbx, modes, max_val, luma)
        d, b = _tq_rd(org.reshape(nb * k, s, s), pred.reshape(nb * k, s, s),
                      size, qp, bit_inc, max_val)
        dists.append(d)
        bits.append(b)
    return torch.cat(dists), torch.cat(bits)


def tu_rd_modes(planes, size: int, nby: int, nbx: int, modes, qps,
                bit_inc: int, max_val: int, luma: bool):
    """The transform-RD estimate of intra candidates predicted from the
    source: ``planes`` the padded int16 planes (the luma plane, or the Cb
    and Cr planes), ``modes`` int32 mode ids [nby*nbx, k] of each block
    (the same on every plane), ``qps`` one 0-d scaled QP a plane, ``size``
    as ``_tq_rd``'s (the block size; 64 and -32 are quadrant TUs) ->
    (int32 dist, float32 bits), each [planes * nby*nbx * k] in (plane,
    block, mode) order.  Intra items: the DST at 4x4 and the intra quant
    offset.  On CUDA tensors the TU-RD kernel, one launch for every
    plane (and raises if it cannot launch); on CPU tensors the plain
    form."""
    dev = planes[0].device
    if dev.type == "cpu":
        return tu_rd_modes_plain(planes, size, nby, nbx, modes, qps,
                                 bit_inc, max_val, luma)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    per = int(modes.shape[0]) * int(modes.shape[1])
    qp = torch.stack([q.reshape(()) for q in qps]).to(
        torch.int32).repeat_interleave(per)
    t = intra_rd_kernel.transform_size(size)
    return intra_rd_kernel.tu_rd_intra(
        tuple(planes), modes.to(torch.int32).contiguous(), qp,
        from_reference(dev).basis(t, True), _level_bits_units(dev), size,
        nby, nbx, luma, bit_inc, max_val)


def tu_rd(org, pred, size: int, qp_scaled, bit_inc: int, max_val: int,
          is_intra: bool = True):
    """The transform-RD estimate of given predictions, ``_tq_rd``'s
    arguments and results.  On CUDA tensors the TU-RD kernel (org and
    pred as int16, the QP expanded to one a block; raises if it cannot
    launch); on CPU tensors ``_tq_rd``."""
    if org.device.type == "cpu":
        return _tq_rd(org, pred, size, qp_scaled, bit_inc, max_val,
                      is_intra)
    if org.device.type != "cuda":
        raise ValueError(f"unsupported device {org.device}")
    n = int(org.shape[0])
    qp = qp_scaled.to(torch.int32)
    qp = qp.expand(n).contiguous() if qp.dim() == 0 else qp.contiguous()
    t = intra_rd_kernel.transform_size(size)
    return intra_rd_kernel.tu_rd_given(
        org.to(torch.int16).contiguous(), pred.to(torch.int16).contiguous(),
        qp, from_reference(org.device).basis(t, is_intra),
        _level_bits_units(org.device), size, is_intra, bit_inc, max_val)


class LumaClass(NamedTuple):
    """One luma size class's decision, each field [nby, nbx]: the best
    mode, its dist and bits (the mode bits included, in whole bits), the
    second and third modes; and ``cids``, the chroma candidates' mode ids
    that the pick wrote: [nby, nbx, 5] for s >= 8, the NxN 8x8 variant's
    [nby / 2, nbx / 2, 5] for s == 4."""
    mode: torch.Tensor
    dist: torch.Tensor
    bits: torch.Tensor
    mode2: torch.Tensor
    mode3: torch.Tensor
    cids: torch.Tensor


class ChromaCands(NamedTuple):
    """One chroma class's five candidates, before their pick: the mode ids
    [nby, nbx, 5] (each fixed mode or 34, then DM) and the TU-RD estimates
    of Cb then Cr, int32 dist and float32 bits [2 * nby * nbx * 5]."""
    ids: torch.Tensor
    dist: torch.Tensor
    bits: torch.Tensor


def _mode_cost(satd_all, best_a, size: int, nby: int, nbx: int,
               ctu_size: int, bits3, sqrt_lam):
    """Each block's 35 mode bits (open-loop MPM from the neighbours'
    SATD-best modes) and SATD + bits costs: (cost, bits) float32 [nb, 35]
    (fast_intra.py:467-486)."""
    s = size
    dev = satd_all.device
    best_a = best_a.reshape(nby, nbx)
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
    m0, m1, m2 = _mpm_vec(left.reshape(-1), above.reshape(-1))

    modes = torch.arange(35, dtype=torch.int32, device=dev)[None, :]
    b0, b12, bo = bits3
    bits_plain = torch.where(
        modes == m0[:, None], b0,
        torch.where((modes == m1[:, None]) | (modes == m2[:, None]), b12,
                    bo))
    return satd_all.to(torch.float32) + bits_plain * sqrt_lam, bits_plain


def intra_select_plain(satd_all, best_a, size: int, nby: int, nbx: int,
                       ctu_size: int, bits3, sqrt_lam):
    """One luma class's select, the per-class plain form of
    ``intra_select``: ``_mode_cost`` and a stable ascending sort, whose
    first three are the top 3 (ties in index order, as
    ``jax.lax.top_k``)."""
    cost, bits_plain = _mode_cost(satd_all, best_a, size, nby, nbx, ctu_size,
                                  bits3, sqrt_lam)
    topk = torch.sort(cost, dim=1, stable=True).indices[:, :_TOP_K]
    return topk.to(torch.int32), bits_plain.gather(1, topk)


def intra_select_pass_plain(classes: dict, ctu_size: int, bits3, sqrt_lam):
    """The plain form of ``intra_select``: ``intra_select_plain`` class
    by class."""
    return {s: intra_select_plain(satd, best, s, nby, nbx, ctu_size, bits3,
                                  sqrt_lam)
            for s, (satd, best, nby, nbx) in classes.items()}


def intra_select(classes: dict, ctu_size: int, bits3, sqrt_lam):
    """The top-K SATD + mode-bits candidates of every luma class of a
    decision pass, which go on to an RD estimate (TEncSearch.cpp:
    2560-2590): ``classes[s]`` the sweep's int32 SATD [nb, 35] and
    SATD-best [nb] and the class's grid (nby, nbx), for each s up to the
    CTU size; the mode-bit classes (b0, b12, bo) and sqrt-lambda as 0-d
    float32 tensors -> {s: (int32 modes [nb, 3], ascending cost, ties to
    the lower mode; float32 their bits [nb, 3])}.  On CUDA tensors one
    launch of kernel A of ``csrc/intra_select.cu`` (and raises if it
    cannot launch); on CPU tensors the plain form."""
    dev = next(iter(classes.values()))[0].device
    if dev.type == "cpu":
        return intra_select_pass_plain(classes, ctu_size, bits3, sqrt_lam)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return intra_select_kernel.select(classes, ctu_size, bits3, sqrt_lam)


def _chroma_ids(luma_best):
    """The chroma candidates' mode ids [n, 5] of blocks whose luma best
    (and DM-reference) mode is ``luma_best`` [n]: each fixed mode, 34
    where it is the luma best; then DM (fast_intra.py:580-583)."""
    luma_best = luma_best.to(torch.int32)
    fixed_ids = [torch.where(luma_best == fm, 34, fm).to(torch.int32)
                 for fm in (PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX)]
    return torch.stack(fixed_ids + [luma_best], dim=1)


def intra_pick_plain(topk, mbits, dist_k, cbits_k, lam, size: int, nby: int,
                     nbx: int):
    """One luma class's pick, the per-class plain form of ``intra_pick``:
    (best, dist, bits, mode2, mode3) [nb] and the chroma ids."""
    nb = nby * nbx
    k = _TOP_K
    topk = topk.long()
    dist_k = dist_k.reshape(nb, k)
    bits_k = cbits_k.reshape(nb, k) + mbits
    rd_k = dist_k.to(torch.float32) + lam * bits_k
    sel = rd_k.argmin(dim=1)
    best = topk.gather(1, sel[:, None])[:, 0]
    dist = dist_k.gather(1, sel[:, None])[:, 0]
    bits = bits_k.gather(1, sel[:, None])[:, 0]
    # runner-up modes, re-evaluated by the apply pass against real
    # reconstructed neighbours
    rows = torch.arange(nb, device=topk.device)
    rd_masked = rd_k.clone()
    rd_masked[rows, sel] = float("inf")
    sel2 = rd_masked.argmin(dim=1)
    mode2 = topk.gather(1, sel2[:, None])[:, 0]
    rd_masked[rows, sel2] = float("inf")
    sel3 = rd_masked.argmin(dim=1)
    mode3 = topk.gather(1, sel3[:, None])[:, 0]
    best = best.to(torch.int32)
    # the NxN 8x8 variant's DM is part 0's (the top-left 4x4's) mode
    cids = _chroma_ids(best if size >= 8
                       else best.reshape(nby, nbx)[0::2, 0::2].reshape(-1))
    return (best, dist, bits, mode2.to(torch.int32), mode3.to(torch.int32),
            cids)


def intra_pick_pass_plain(classes: dict, ctu_size: int, lam):
    """The plain form of ``intra_pick``: ``intra_pick_plain`` class by
    class."""
    return {s: intra_pick_plain(topk, mbits, dist_k, cbits_k, lam, s, nby,
                                nbx)
            for s, (topk, mbits, dist_k, cbits_k, nby, nbx)
            in classes.items()}


def intra_pick(classes: dict, ctu_size: int, lam):
    """The RD pick of every luma class's top 3: ``classes[s]``
    ``intra_select``'s modes and bits [nb, 3], the TU-RD estimates of
    those modes (int32 dist and float32 bits [nb * 3]) and the class's
    grid (nby, nbx), for each s up to the CTU size; lambda (0-d float32)
    -> {s: (best mode, dist, bits, second mode, third mode), each [nb]
    (int32, bits float32), and the chroma candidates' ids
    (``LumaClass.cids``, flat: [nb, 5], or for s == 4 the NxN variant's
    [nb / 4, 5])}.  On CUDA tensors one launch of kernel B of
    ``csrc/intra_select.cu`` (and raises if it cannot launch); on CPU
    tensors the plain form."""
    dev = next(iter(classes.values()))[0].device
    if dev.type == "cpu":
        return intra_pick_pass_plain(classes, ctu_size, lam)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return intra_select_kernel.pick(classes, ctu_size, lam)


def _luma_passes(ppad, wp: int, hp: int, qp_scaled, sqrt_lam_bits3,
                 bit_inc: int, max_val: int, ctu_size: int) -> dict:
    """Every luma size class up to the CTU size over the whole frame ->
    {s: ``LumaClass``}.  ``ppad`` is the padded int16 luma plane.  The
    classes do not depend on one another: the sweeps of every class, one
    select over them all, the TU-RD of each class's top 3, one pick."""
    (b0, b12, bo), sqrt_lam, lam = sqrt_lam_bits3
    grids = {s: (hp // s, wp // s) for s in SIZES if s <= ctu_size}
    sweeps = {s: intra_sweep(ppad, s, nby, nbx, bit_inc, max_val)
              for s, (nby, nbx) in grids.items()}
    top = intra_select({s: (*sweeps[s], *g) for s, g in grids.items()},
                       ctu_size, (b0, b12, bo), sqrt_lam)
    rd = {s: tu_rd_modes((ppad,), s, nby, nbx, top[s][0], (qp_scaled,),
                         bit_inc, max_val, luma=True)
          for s, (nby, nbx) in grids.items()}
    picked = intra_pick({s: (*top[s], *rd[s], *g) for s, g in grids.items()},
                        ctu_size, lam)
    res = {}
    for s, (nby, nbx) in grids.items():
        *fields, cids = picked[s]
        cy, cx = (nby, nbx) if s >= 8 else (nby // 2, nbx // 2)
        res[s] = LumaClass(*(v.reshape(nby, nbx) for v in fields),
                           cids.reshape(cy, cx, 5))
    return res


def _chroma_pass_impl(cbpad, crpad, size: int, nby: int, nbx: int, ids,
                      qp_cb, qp_cr, bit_inc: int, max_val: int):
    """The 5-candidate chroma mode RD for luma-size-class ``size`` CUs:
    {planar, ver, hor, dc} with the luma-duplicate slot replaced by
    angular 34, plus DM (TEncSearch::estIntraPredChromaQT); ``ids`` the
    candidates' mode ids [nby, nbx, 5] (``LumaClass.cids``).  Returns the
    candidates' TU-RD estimates on Cb and Cr (``ChromaCands``), which the
    DP's kernel picks from (``chroma_pick_plain`` is the pick).

    The RD estimate treats 4x4 chroma TUs as intra luma ones and uses
    the DST, as the reference does (fast_intra.py:586, ROADMAP R11),
    where HM uses the DCT for chroma."""
    c = size // 2                      # chroma block size (>= 4)
    ids = ids.reshape(nby, nbx, 5)
    # a 64-CU's chroma transforms at 16 (the luma TU split to 32 is
    # mandatory, so the chroma tree follows): quadrant transforms
    tq_size = -32 if c == 32 else c
    d, b = tu_rd_modes((cbpad, crpad), tq_size, nby, nbx,
                       ids.reshape(nby * nbx, 5), (qp_cb, qp_cr), bit_inc,
                       max_val, luma=False)
    return ChromaCands(ids, d, b)


def chroma_pick_plain(cands: ChromaCands, lam_w_bits2):
    """A chroma class's pick, the plain form of the DP kernel's first
    step: cost = cw * dist + lam * (coefficient bits + mode bits) of each
    candidate, with the frame's ``lam_w_bits2`` ((bits_dm, bits_oth),
    lambda, chroma weight), the first minimum -> (the stored chroma dir
    [nby, nbx], the mode value or 36 for DM; the winner's cost [nby, nbx]
    float32)."""
    (bits_dm, bits_oth), lam, cw = lam_w_bits2
    nby, nbx = (int(v) for v in cands.ids.shape[:2])
    nb = nby * nbx
    d_cb, d_cr = cands.dist[:nb * 5], cands.dist[nb * 5:]
    b_cb, b_cr = cands.bits[:nb * 5], cands.bits[nb * 5:]
    dist = (d_cb + d_cr).reshape(nb, 5).to(torch.float32)
    cbits = (b_cb + b_cr).reshape(nb, 5)
    mbits = torch.stack([bits_oth, bits_oth, bits_oth, bits_oth,
                         bits_dm])[None, :]
    cost = cw * dist + lam * (cbits + mbits)
    sel = cost.argmin(dim=1)
    best_cost = cost.gather(1, sel[:, None])[:, 0]
    # the stored direction value per candidate slot
    ids = cands.ids.reshape(nb, 5)
    vals = torch.cat([ids[:, :4], torch.full(
        (nb, 1), DM_CHROMA_IDX, dtype=torch.int32, device=ids.device)], dim=1)
    best_val = vals.gather(1, sel[:, None])[:, 0]
    return best_val.reshape(nby, nbx), best_cost.reshape(nby, nbx)


def dp_expand_plain(res, cres, cres8_nxn, width: int, height: int, lam,
                    max_sig: int, min_tr_log2: int, ctu_size: int, wp: int,
                    hp: int, inter=None, intra_pen: float = 0.0):
    """Bottom-up quadtree DP + expansion to 4x4-unit maps, of picked
    chroma classes (the reference's ``_dp_expand``).

    res[s] = (mode, dist, bits, mode2, mode3) luma per block; cres[s] =
    (cdir, ccost) for s >= 8; cres8_nxn = the NxN-variant chroma decision
    at s = 8.  Without ``inter`` (intra slices) returns int8 maps [6,
    hp//4, wp//4]: depth, mode, NxN, chroma dir, second and third mode.

    P slices pass inter = {s: (rd, mvx, mvy, ref)} and B slices {s: (rd,
    mvx0, mvy0, ref0, dir, mvx1, mvy1, ref1)}: an intra CU then pays
    ``intra_pen`` bits, each leaf takes the cheaper of intra and inter
    (the inter leaf pays 3 bits), and the maps gain the pred flag, ref
    index and quarter-pel MV planes (B: also dir and the L1 ref and MV),
    returned as int16 [10 or 14, hp//4, wp//4]."""
    dev = lam.device
    big = 1e30
    cost = {}
    choice = {}
    pred_inter = {}
    min_cu = ctu_size >> max_sig

    def quad_sum(child):
        return (child[0::2, 0::2] + child[0::2, 1::2]
                + child[1::2, 0::2] + child[1::2, 1::2])

    for s in SIZES:
        if s > ctu_size:
            continue
        dist, bits = res[s][1], res[s][2]
        leaf = dist.to(torch.float32) + lam * (bits + _CU_BITS)
        if s >= 8:
            leaf = leaf + cres[s][1]
        if inter is not None and s >= 8:
            # an intra CU in an inter slice: pred_mode/part-size bits and
            # the optimism of predicting from the source's neighbours
            leaf = leaf + lam * intra_pen
        if inter is not None and s in inter:
            ileaf = inter[s][0] + lam * 3.0
            pred_inter[s] = ileaf < leaf
            leaf = torch.minimum(leaf, ileaf)
        nby, nbx = leaf.shape
        ys = (np.arange(nby) * s)[:, None]
        xs = (np.arange(nbx) * s)[None, :]
        crosses = ((ys < height) & (ys + s > height)) | \
                  ((xs < width) & (xs + s > width))
        outside = (ys >= height) | (xs >= width)
        leaf = torch.where(torch.from_numpy(crosses).to(dev), big, leaf)
        leaf = torch.where(torch.from_numpy(outside).to(dev), 0.0, leaf)
        if s == 4:
            cost[4] = leaf
            continue
        if s == 8:
            # NxN partition (not a CU split): add its chroma cost
            split = quad_sum(cost[4]) + cres8_nxn[1] + lam * _NXN_BITS
            if inter is not None:
                split = split + lam * intra_pen
            can = 8 > (1 << min_tr_log2) and 4 >= min_cu
        else:
            split = quad_sum(cost[s // 2]) + lam * _SPLIT_BITS
            can = s > min_cu
        if can:
            take = split < leaf
            cost[s] = torch.where(take, split, leaf)
            choice[s] = take
        else:
            cost[s] = leaf
            choice[s] = torch.zeros_like(leaf, dtype=torch.bool)

    uw, uh = wp // 4, hp // 4

    def up(a, un):
        return a.repeat_interleave(un, dim=0).repeat_interleave(un, dim=1)

    def i8(a):
        return a.to(torch.int8)

    def full(v):
        return torch.full((uh, uw), v, dtype=torch.int8, device=dev)

    fd_depth, fd_mode, fd_nxn = full(0), full(DC_IDX), full(0)
    fd_chroma, fd_mode2, fd_mode3 = full(DM_CHROMA_IDX), full(DC_IDX), \
        full(DC_IDX)
    is_b = inter is not None and len(next(iter(inter.values()))) == 8
    # inter planes: pred, ref, mvx, mvy (B: then dir, ref1, mvx1, mvy1)
    fd_inter = []
    if inter is not None:
        fd_inter = [full(0), full(0), full(0).to(torch.int32),
                    full(0).to(torch.int32)]
    if is_b:
        fd_inter += [full(1), full(0), full(0).to(torch.int32),
                     full(0).to(torch.int32)]
    top = min(ctu_size, max(SIZES))
    open_ = torch.ones((hp // top, wp // top), dtype=torch.bool, device=dev)
    s = top
    depth = 0
    while s >= 8:
        can_descend = (s > min_cu) or (s == 8 and 8 > (1 << min_tr_log2))
        split_here = (open_ & choice[s]) if can_descend \
            else torch.zeros_like(open_)
        lm = up(open_ & ~split_here, s // 4)
        fd_depth = torch.where(lm, depth, fd_depth)
        fd_mode = torch.where(lm, up(i8(res[s][0]), s // 4), fd_mode)
        fd_mode2 = torch.where(lm, up(i8(res[s][3]), s // 4), fd_mode2)
        fd_mode3 = torch.where(lm, up(i8(res[s][4]), s // 4), fd_mode3)
        fd_chroma = torch.where(lm, up(i8(cres[s][0]), s // 4), fd_chroma)
        if inter is not None and s in inter:
            im = lm & up(pred_inter[s], s // 4)
            iv = inter[s]
            vals = [torch.ones_like(pred_inter[s]), iv[3], iv[1], iv[2]]
            if is_b:
                vals += [iv[4], iv[7], iv[5], iv[6]]
            for k, v in enumerate(vals):
                src = up(v.to(fd_inter[k].dtype), s // 4)
                fd_inter[k] = torch.where(im, src, fd_inter[k])
        if s == 8:
            # a split at 8 is an NxN-PU 8x8 CU, not a CU split: the
            # per-4x4 modes come from the 4x4 pass
            nm = up(split_here, 2)
            fd_depth = torch.where(nm, depth, fd_depth)
            fd_nxn = torch.where(nm, 1, fd_nxn)
            fd_mode = torch.where(nm, i8(res[4][0]), fd_mode)
            fd_mode2 = torch.where(nm, i8(res[4][3]), fd_mode2)
            fd_mode3 = torch.where(nm, i8(res[4][4]), fd_mode3)
            fd_chroma = torch.where(nm, up(i8(cres8_nxn[0]), 2), fd_chroma)
            break
        open_ = up(split_here, 2)
        s //= 2
        depth += 1
    planes = [fd_depth, fd_mode, fd_nxn, fd_chroma, fd_mode2, fd_mode3]
    if inter is None:
        return torch.stack(planes)
    return torch.stack([p.to(torch.int16) for p in planes + fd_inter])


def intra_dp_plain(res, cres, cres8_nxn, width: int, height: int, lam,
                   lam_w_bits2, max_sig: int, min_tr_log2: int,
                   ctu_size: int, wp: int, hp: int, inter=None,
                   intra_pen: float = 0.0):
    """The plain form of the DP kernel: each chroma class's pick
    (``chroma_pick_plain``), then ``dp_expand_plain``."""
    return dp_expand_plain(
        res, {s: chroma_pick_plain(c, lam_w_bits2) for s, c in cres.items()},
        chroma_pick_plain(cres8_nxn, lam_w_bits2), width, height, lam,
        max_sig, min_tr_log2, ctu_size, wp, hp, inter, intra_pen)


def _dp_expand(res, cres, cres8_nxn, width: int, height: int, lam,
               lam_w_bits2, max_sig: int, min_tr_log2: int, ctu_size: int,
               wp: int, hp: int, inter=None, intra_pen: float = 0.0):
    """The chroma picks, the quadtree DP and the unit maps of a frame:
    ``res[s]`` each luma class's ``LumaClass``, ``cres[s]`` each chroma
    class's ``ChromaCands`` (s >= 8), ``cres8_nxn`` the NxN variant's at
    8, ``lam`` a 0-d float32 tensor, ``lam_w_bits2`` the frame's chroma
    scalars ((bits_dm, bits_oth), lambda, chroma weight; 0-d float32),
    ``inter`` (int32 fields but the float32 rd) and ``intra_pen`` as
    ``dp_expand_plain``'s -> its maps.  On CUDA tensors kernel C of
    ``csrc/intra_select.cu``, one launch (and raises if it cannot
    launch); on CPU tensors the plain form (``intra_dp_plain``)."""
    if lam.device.type == "cpu":
        return intra_dp_plain(res, cres, cres8_nxn, width, height, lam,
                              lam_w_bits2, max_sig, min_tr_log2, ctu_size,
                              wp, hp, inter, intra_pen)
    if lam.device.type != "cuda":
        raise ValueError(f"unsupported device {lam.device}")
    return intra_select_kernel.dp(res, cres, cres8_nxn, width, height, lam,
                                  lam_w_bits2, max_sig, min_tr_log2,
                                  ctu_size, wp, hp, inter, intra_pen)


def _frame_body(py, pcb, pcr, iscal, fscal, wp: int, hp: int, statics,
                max_sig: int, min_tr_log2: int):
    """The whole decision problem for one frame: luma size classes,
    chroma candidates, quadtree DP, unit-map expansion -> int8
    [6, hp//4, wp//4].  ``py``, ``pcb``, ``pcr`` are the padded int16
    source planes (``_source_planes``), ``iscal`` holds the scaled QPs
    (luma, Cb, Cr), ``fscal`` the float32 scalars (lambda, sqrt-lambda,
    the three mode-bit classes, the two chroma-bit classes, the chroma
    weight)."""
    width, height, bit_inc, max_val, ctu_size = statics
    qp_scaled, qp_cb, qp_cr = iscal[0], iscal[1], iscal[2]
    lam, sqrt_lam = fscal[0], fscal[1]
    sqrt_lam_bits3 = ((fscal[2], fscal[3], fscal[4]), sqrt_lam, lam)
    lam_w_bits2 = ((fscal[5], fscal[6]), lam, fscal[7])
    res = _luma_passes(py, wp, hp, qp_scaled, sqrt_lam_bits3, bit_inc,
                       max_val, ctu_size)
    cres = {s: _chroma_pass_impl(pcb, pcr, s, hp // s, wp // s,
                                 res[s].cids, qp_cb, qp_cr, bit_inc,
                                 max_val)
            for s in SIZES if 8 <= s <= ctu_size}
    # the NxN 8x8 variant (its ids from the 4x4 class's pick)
    cres8_nxn = _chroma_pass_impl(pcb, pcr, 8, hp // 8, wp // 8,
                                  res[4].cids, qp_cb, qp_cr, bit_inc,
                                  max_val)
    return _dp_expand(res, cres, cres8_nxn, width, height, lam, lam_w_bits2,
                      max_sig, min_tr_log2, ctu_size, wp, hp)


def _source_planes(org_y, org_cb, org_cr, width: int, height: int,
                   ctu_size: int):
    """The source planes, edge-padded for the decision passes: one sample
    on the top and left, to the CTU-padded size plus two CTUs (luma) or
    one CTU (chroma) on the bottom and right."""
    pad = ctu_size * 2
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    wc, hc = width // 2, height // 2
    return (
        np.pad(org_y, ((1, hp - height + pad), (1, wp - width + pad)),
               mode="edge"),
        np.pad(org_cb, ((1, hp // 2 - hc + ctu_size),
                        (1, wp // 2 - wc + ctu_size)), mode="edge"),
        np.pad(org_cr, ((1, hp // 2 - hc + ctu_size),
                        (1, wp // 2 - wc + ctu_size)), mode="edge"))


def dispatch_frame(org_y: np.ndarray, org_cb: np.ndarray,
                   org_cr: np.ndarray, width: int, height: int,
                   qp_scaled: int, qp_cb: int, qp_cr: int, lambda_: float,
                   sqrt_lambda: float, bits3: tuple, cbits2: tuple,
                   max_sig: int, min_tr_log2: int, ctu_size: int = 64,
                   bit_inc: int = 0, max_val: int = 255, *, device):
    """Start the decision pass for one frame on ``device``: pad and
    upload the source planes and queue the work.  Returns a token for
    ``collect_frame``; on a CUDA device the work runs asynchronously."""
    device = torch.device(device)
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    planes = _source_planes(org_y, org_cb, org_cr, width, height, ctu_size)
    iscal = np.asarray([qp_scaled, qp_cb, qp_cr], np.int32)
    fscal = np.asarray([lambda_, sqrt_lambda, bits3[0], bits3[1], bits3[2],
                        cbits2[0], cbits2[1], cbits2[2]], np.float32)
    host = [np.ascontiguousarray(p, np.int16) for p in planes] + [iscal,
                                                                  fscal]
    dev_stats.stat_launch(sum(a.nbytes for a in host))
    py, pcb, pcr, iscal, fscal = (torch.from_numpy(a).to(device)
                                  for a in host)
    statics = (width, height, bit_inc, max_val, ctu_size)
    out = _frame_body(py, pcb, pcr, iscal, fscal, wp, hp, statics, max_sig,
                      min_tr_log2)
    return out, wp, hp


def collect_frame(token):
    """Finish a dispatched decision pass with one device-to-host copy:
    (depth, mode, nxn, chroma, mode2, mode3) int8 [hp/4, wp/4] planes,
    nxn as contiguous uint8, as ``nat.set_fd`` takes them."""
    out, _, _ = token
    packed = out.cpu().numpy()
    dev_stats.stat_d2h(packed.nbytes)
    fd_depth, fd_mode, fd_nxn, fd_chroma, fd_mode2, fd_mode3 = packed
    return (fd_depth, fd_mode, np.ascontiguousarray(fd_nxn, np.uint8),
            fd_chroma, fd_mode2, fd_mode3)


def decide_frame(org_y, org_cb, org_cr, width: int, height: int,
                 qp_scaled: int, qp_cb: int, qp_cr: int,
                 lambda_: float, sqrt_lambda: float, bits3: tuple,
                 cbits2: tuple, max_sig: int, min_tr_log2: int,
                 ctu_size: int = 64, bit_inc: int = 0, max_val: int = 255,
                 *, device, stats=None):
    """Run the decision pass for one frame on ``device`` and return its
    maps (``collect_frame``).  The positional arguments are those of the
    reference's ``decide_frame``: source planes (int16), frame size,
    scaled QPs, lambda and its square root, the intra-dir bit classes
    (mpm0, mpm12, other), the chroma bit classes (dm, other, chroma
    weight), the CU depth and the smallest TU size (log2), the CTU size,
    the bit increment and the largest sample value.  ``stats``
    (``encoder.top.DecisionStats``) gets the wall time, from the call to
    the maps on the host."""
    if device is None:
        raise TypeError("decide_frame needs a device")
    t0 = time.perf_counter()
    maps = collect_frame(dispatch_frame(
        org_y, org_cb, org_cr, width, height, qp_scaled, qp_cb, qp_cr,
        lambda_, sqrt_lambda, bits3, cbits2, max_sig, min_tr_log2,
        ctu_size, bit_inc, max_val, device=device))
    if stats is not None:
        stats.add(time.perf_counter() - t0)
    return maps


# -- thevc_tpu/encoder/fast_intra.py:876-887, 974-986, unchanged


def chroma_bits2(init_ctx, chroma_weight: float) -> tuple:
    """The two intra_chroma_pred_mode bit classes at slice-init context,
    in whole bits: DM (one '0' ctx bin) vs the rest ('1' ctx bin + 2 EP
    bins) (TEncSbac::codeIntraDirChroma)."""
    from ..cabac import contexts as cc
    from ..cabac.tables import ENTROPY_BITS

    st = int(init_ctx[cc.O_CHROMA_PRED])
    b1 = int(ENTROPY_BITS[st ^ 1])
    b0 = int(ENTROPY_BITS[st ^ 0])
    ep = 32768
    return (b0 / 32768.0, (b1 + 2 * ep) / 32768.0, float(chroma_weight))


def mode_bits3(sh, pps, init_ctx) -> tuple:
    """The three xModeBitsIntra bit classes (mpm idx 0 / mpm idx 1-2 /
    non-mpm) at slice-init context, in whole bits."""
    from ..cabac import contexts as cc
    from ..cabac.tables import ENTROPY_BITS

    st = int(init_ctx[cc.O_INTRA_PRED])
    b_flag1 = int(ENTROPY_BITS[st ^ 1])
    b_flag0 = int(ENTROPY_BITS[st ^ 0])
    ep = 32768
    return ((b_flag1 + ep) / 32768.0,
            (b_flag1 + 2 * ep) / 32768.0,
            (b_flag0 + 5 * ep) / 32768.0)
