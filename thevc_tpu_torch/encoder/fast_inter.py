"""Fast-RD inter decisions in PyTorch: the P/B decision pass of ``--FastRD=1``.

A port of ``thevc_tpu/encoder/fast_inter.py``.  For one P or B frame,
open-loop (predictions read the references' reconstructed planes, the
intra leaves the source picture):

1. coarse motion field: a quarter-resolution full search over the whole
   +-search-range window of every reference, for every size class at
   once (``_coarse_fields``: on a CUDA tensor the coarse-search kernel of
   ``csrc/inter_me.cu``, one launch a list);
2. per block of each size class 8..64: a +-3 full-pel refinement around
   the coarse winner (SAD plus an exp-Golomb MV prior; ``int_refine``:
   on a CUDA tensor that source's refinement kernel, one launch a size
   class and list), then the 7x7
   quarter-pel window around the integer winner through the HEVC 8-tap
   interpolation (``ops.mc.mc_qpel_fields``: on a CUDA tensor the
   hand-written kernel's quarter-pel entry in ``csrc/mc.cu``, the 49
   candidates of every block in one launch per size class and list, each
   block's window derived in the kernel from its MV), the Hadamard SATD
   (``ops.satd``: on a CUDA tensor the hand-written kernel in
   ``csrc/satd.cu``, one launch per size class and list) and the MV
   prior, costs and first minimum (``qpel_pick``: on a CUDA tensor
   kernel D of ``csrc/inter_me.cu``, one launch per size class and
   list);
3. RD leaves: transform/quant/recon estimates of luma and both chroma
   planes at the winner (the predictions by ``ops.mc.mc_blocks_fields``,
   jobs derived in the kernel from the MVs; ``fast_intra.tu_rd`` with
   ``is_intra=False``: on a CUDA tensor the TU-RD kernel in
   ``csrc/intra_rd.cu``), a 3-candidate merge/skip model
   (``merge_model``: on a CUDA tensor the merge-model kernel of
   ``csrc/inter_me.cu``, one launch a size class and list), and for B
   slices a bi-prediction stage on the two lists' winners (the averaged
   predictions' TU-RD estimates per class, then ``bi_pick``: on a CUDA
   tensor kernel E of ``csrc/inter_me.cu``, the MV bits, the RD sum and
   the L0/L1/BI direction of every class in one launch);
4. the intra leaves of ``fast_intra._luma_passes`` (on a CUDA tensor
   through its sweep and TU-RD kernels and one select and one pick
   launch over every luma class) and the quadtree DP with its inter
   branch (``fast_intra._dp_expand``: on a CUDA tensor the DP kernel of
   ``csrc/intra_select.cu``, one launch a frame), expanded to per-4x4-unit
   maps.

The maps feed the native apply pass (``nat.set_fd`` and
``nat.set_fd_inter``), which re-ranks each inter CU against the real
merge candidates and writes a conformant stream.

Each kernel stage has a plain form with its kernel's inputs and outputs
(``coarse_fields_plain``, ``int_refine_plain``, ``merge_model_plain``,
``qpel_pick_plain``, ``bi_pick_plain``), which CPU tensors run and the
checks hold the kernels to, bit for bit.  The source blocks of each size
class are cut once a frame (``_source_blocks``) for both lists and the
bi stage.

The reference's TPU- and XLA-specific forms are not carried over: its
8-pixel tile fetch with an 8-way select (a plain index gather here), the
ref stack padded to a fixed depth and masked with ``inf`` (each list
holds its own references), the ``vmap`` over the two lists (two calls)
and the compiled-graph cache.  The coarse search's plain form is one
batched op per chunk of search rows instead of a scan over (reference,
row); the first
minimum in (reference, row, column) order wins, as the scan's strict
``<`` across steps and first minimum within a step decide.

Float order follows ``fast_intra``: every ``a + b * c`` is two eager
float32 ops, the MV-bit priors are integers computed exactly (an integer
bit length, where the reference takes a float32 ``log2``), and ties go
to the first candidate.  Against the JAX package the integer stages are
exact and the maps agree on at least 99.9% of units; see
``tests/test_torch_fast_inter.py`` and ``tests/test_torch_fast_inter_b.py``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops import device as dev_stats
from ..ops import inter_me_kernel, mc
from ..ops.device import stage
from ..ops.satd import satd_blocks
from . import fast_intra as fi

MARGIN = 12          # per-block window margin: 3 int refine + 4 taps + slack
INTER_SIZES = (8, 16, 32, 64)
PAD_FULL = 80        # ref padding: search range 64 + refine 3 + taps + slack
PAD_C = 44

# intra-CU penalty (whole bits) in inter slices: pred_mode + part-size
# signaling plus the open-loop optimism of org-neighbor intra prediction
# (thevc_tpu/encoder/fast_inter.py:46-50; the reference's default)
_INTRA_PEN_BITS = 8.0

# elements of one coarse-search chunk (rows x columns x quarter-res plane)
_COARSE_CHUNK = 1 << 26


def _avgpool(x, k: int):
    """Rounded mean over k x k tiles of a 2-D integer plane."""
    h, w = x.shape
    return (x.reshape(h // k, k, w // k, k).sum(dim=(1, 3))
            + k * k // 2) // (k * k)


def _block_sum(x, s: int):
    """Sums over s x s tiles of the last two dims."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // s, s, w // s, s).sum(dim=(-3, -1))


def _golomb_bits(v):
    """xGetComponentBits: 2 * len(2|v| + 1) - 1, the unary exp-Golomb
    length, as int32.  The bit length is the exponent of an exact
    float64 (the reference takes it from a float32 ``log2``)."""
    code = (2 * v.abs() + 1).to(torch.float64)
    return (2 * torch.frexp(code).exponent - 1).to(torch.int32)


def _coarse_bits(rng_q: int, dev):
    """The coarse search's MV prior ``2 * ceil(log2(mvq + 2))`` per
    (row, column) offset, mvq = (|dy - rng_q| + |dx - rng_q|) * 16, as
    exact int64 on ``dev``: ceil(log2(n)) is the bit length of n - 1, the
    exponent of an exact float64."""
    off = (torch.arange(2 * rng_q + 1, device=dev) - rng_q).abs()
    mvq = (off[:, None] + off[None, :]) * 16
    return 2 * torch.frexp((mvq + 1).to(torch.float64)).exponent.to(
        torch.int64)


def _shift_grid(a, dy: int, dx: int):
    """Neighbour-value grid: out[i, j] = a[i - dy, j - dx], zero-filled at
    the frame edge (so (0, 1) reads the LEFT neighbour, (1, 0) the
    ABOVE)."""
    h, w = a.shape
    out = torch.zeros_like(a)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        a[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return out


def _mv_pred_median(mvx, mvy):
    """Neighbourhood-median MV predictor over a block grid (open-loop
    stand-in for AMVP/merge): median of left, above, above-right."""
    outs = []
    for a in (mvx, mvy):
        left = _shift_grid(a, 0, 1)
        up = _shift_grid(a, 1, 0)
        ur = _shift_grid(a, 1, -1)
        outs.append(torch.maximum(torch.minimum(torch.maximum(left, up), ur),
                                  torch.minimum(left, up)))
    return outs


def _coarse_sads(org, ref, dy0: int, n_dy: int, n_off: int, sizes):
    """Quarter-res SADs of search rows dy0 .. dy0 + n_dy - 1 (every
    column) against one reference, per size class: {s: int64 [n_dy,
    n_off, hq*4//s, wq*4//s]}.  org int16 [hq, wq]; ref int16 [hq + n_off
    - 1, wq + n_off - 1], contiguous."""
    hq, wq = org.shape
    stride = ref.shape[1]
    win = ref.as_strided((n_dy, n_off, hq, wq), (stride, 1, stride, 1),
                         ref.storage_offset() + dy0 * stride)
    sad = _block_sum((org - win).abs(), 2)          # the 8x8 class
    out = {}
    for s in sizes:
        if s > 8:
            sad = _block_sum(sad, 2)
        out[s] = sad
    return out


def coarse_fields_plain(org_q, refs_q, rng_q: int, hq: int, wq: int,
                        sqrt_lam, ctu_size: int):
    """The plain form of ``_coarse_fields``: search rows in chunks of at
    most ``_COARSE_CHUNK`` SAD samples, each chunk's SADs materialised
    (``_coarse_sads``) and ranked at once."""
    dev = org_q.device
    n_off = 2 * rng_q + 1
    sizes = [s for s in INTER_SIZES if s <= ctu_size]
    bits = _coarse_bits(rng_q, dev)
    rows_per = max(1, _COARSE_CHUNK // (n_off * hq * wq))
    org = org_q.to(torch.int16)
    best = {}
    for r, ref in enumerate(refs_q):
        ref = ref.contiguous()
        lam_bits = sqrt_lam * (bits + r).to(torch.float32)   # [dy, dx]
        for dy0 in range(0, n_off, rows_per):
            n_dy = min(rows_per, n_off - dy0)
            for s, sad in _coarse_sads(org, ref, dy0, n_dy, n_off,
                                       sizes).items():
                cost = sad.to(torch.float32) * 4.0
                cost = cost + lam_bits[dy0:dy0 + n_dy, :, None, None]
                cmin, carg = cost.reshape(n_dy * n_off, *cost.shape[2:]).min(
                    dim=0)
                code = (r * n_off + dy0) * n_off + carg
                if s not in best:
                    best[s] = (cmin, code)
                    continue
                bc, bcode = best[s]
                take = cmin < bc
                best[s] = (torch.where(take, cmin, bc),
                           torch.where(take, code, bcode))
    out = {}
    for s, (_c, code) in best.items():
        dx = code % n_off - rng_q
        dy = (code // n_off) % n_off - rng_q
        out[s] = (dy * 4, dx * 4, code // (n_off * n_off))
    return out


def _coarse_fields(org_q, refs_q, rng_q: int, hq: int, wq: int, sqrt_lam,
                   ctu_size: int):
    """Quarter-res full motion search for every size class at once.
    org_q [hq, wq]; refs_q: per reference an edge-padded quarter-res
    int16 plane [hq + 2 rng_q, wq + 2 rng_q]; sqrt_lam a 0-d float32.
    Returns per size s: (dy, dx, ref) full-pel int64 [hq*4//s, wq*4//s];
    the first minimum in (reference, row, column) order wins.  On CUDA
    tensors the coarse-search kernel, one launch for every reference
    (and raises if it cannot launch); on CPU tensors the plain form."""
    dev = org_q.device
    if dev.type == "cpu":
        return coarse_fields_plain(org_q, refs_q, rng_q, hq, wq, sqrt_lam,
                                   ctu_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return inter_me_kernel.coarse_search(
        org_q.to(torch.int16).contiguous(), [r.contiguous() for r in refs_q],
        rng_q, sqrt_lam, tuple(s for s in INTER_SIZES if s <= ctu_size))


def _block_grid(s: int, nby: int, nbx: int, dev):
    """Top-left luma sample (by, bx) of every block, raster order, int32
    (the MC jobs are int32)."""
    by = (torch.arange(nby, device=dev, dtype=torch.int32) * s)[:, None] \
        .expand(nby, nbx)
    bx = (torch.arange(nbx, device=dev, dtype=torch.int32) * s)[None, :] \
        .expand(nby, nbx)
    return by.reshape(-1), bx.reshape(-1)


def _blocks(plane, s: int, nby: int, nbx: int):
    """[nby*s, nbx*s] top-left part of a plane as int32 [nby*nbx, s, s]."""
    return _blocks16(plane, s, nby, nbx).to(torch.int32)


def _blocks16(plane, s: int, nby: int, nbx: int):
    """[nby*s, nbx*s] top-left part of a plane as contiguous [nby*nbx, s,
    s] of its dtype (one copy; int16 for the source planes)."""
    o = plane[:nby * s, :nbx * s]
    return (o.reshape(nby, s, nbx, s).permute(0, 2, 1, 3)
            .reshape(nby * nbx, s, s).contiguous())


def _luma_jobs(ref, mvq_x, mvq_y, by, bx):
    """``mc_blocks`` jobs [N, 5] of each block's luma at a quarter-pel MV
    (the 2-D 8-tap filter; frac-0 phases ride the identity tap row), of
    the inputs' dtype (int32 in the pass: the kernel's own)."""
    return torch.stack([ref, bx + (mvq_x >> 2) + (PAD_FULL - 3),
                        by + (mvq_y >> 2) + (PAD_FULL - 3), mvq_x & 3,
                        mvq_y & 3], dim=1)


def _chroma_jobs(ref, mvq_x, mvq_y, cby, cbx):
    """``mc_blocks`` jobs [N, 5] of each block's chroma at a quarter-pel
    luma MV (the 4-tap filter at eighth-pel chroma phases)."""
    return torch.stack([ref, cbx + (mvq_x >> 3) + (PAD_C - 1),
                        cby + (mvq_y >> 3) + (PAD_C - 1), mvq_x & 7,
                        mvq_y & 7], dim=1)


def _pred_luma(refs_y, winner, s: int, nbx: int, bd: int, bi=False,
               refs1=None, winner1=None):
    """Luma prediction [N, s, s] int16 pixels of each block of a size
    class's grid (nbx blocks a row) at its quarter-pel MV: winner (ref,
    mvx, mvy), int32 [N] each; with ``winner1`` (and ``bi``) list 1's too
    over ``refs1``, the bi average.  One ``mc.mc_blocks_fields`` call: on
    the card the jobs are derived in the kernel."""
    return mc.mc_blocks_fields(refs_y, winner, s, nbx, PAD_FULL, True, bd,
                               bi, planes1=refs1, fields1=winner1)


def _pred_chroma(refs_c, winner, cs: int, nbx: int, bd: int, bi=False,
                 refs1=None, winner1=None):
    """Chroma prediction [2, N, cs, cs] int16 pixels (Cb, then Cr) of each
    block at its quarter-pel luma MV, in one call: refs_c stacks the
    references' Cb planes, then their Cr planes; ``winner1`` as in
    ``_pred_luma``."""
    return mc.mc_blocks_fields(refs_c, winner, cs, nbx, PAD_C, False, bd,
                               bi, pair=True, planes1=refs1,
                               fields1=winner1)


def _qpel_preds(refs_y, ref, int_mx, int_my, s: int, nbx: int, bd: int):
    """The 7x7 quarter-pel candidates around each block's integer MV
    (int_mx, int_my): int16 pixels [nb, 49, s, s], candidate (qdy + 3) *
    7 + qdx + 3 at quarter-pel offset (qdx, qdy), all in one
    ``mc.mc_qpel_fields`` call, each block's window origin (the first tap
    sample of candidate (0, 0)) at (bx + int_mx + PAD_FULL - 3, by +
    int_my + PAD_FULL - 3)."""
    return mc.mc_qpel_fields(refs_y, (ref, int_mx, int_my), s, nbx,
                             PAD_FULL, bd)


def _sse(a, b, bit_inc: int):
    """Per-block sum of squared differences >> 2*bit_inc, as the
    reference's int32 sum (wrapping) computes it."""
    d = (a.to(torch.int64) - b.to(torch.int64))
    return (d * d).sum(dim=(-2, -1)).to(torch.int32) >> (2 * bit_inc)


def _tq_size(cs: int) -> int:
    """The ``_tq_rd`` size of a chroma block: a 32-sized one (of a 64 CU)
    transforms as 16x16 quadrants."""
    return -32 if cs == 32 else cs


def _mv_bits(pred_x, pred_y, mvqx, mvqy):
    """The exp-Golomb MV prior of [nb, 7] x and [nb, 7] y candidates
    (quarter pel) against the predictor -> int [nb, 7 (y), 7 (x)]."""
    gx = _golomb_bits(mvqx - pred_x[:, None])
    gy = _golomb_bits(mvqy - pred_y[:, None])
    return gy[:, :, None] + gx[:, None, :] + 2


def int_refine_plain(org, refs_y, coarse, s: int, nby: int, nbx: int,
                     sqrt_lam, bit_inc: int):
    """The plain form of ``int_refine``: each block's window gathered
    (``mc.gather_windows``), the 49 candidates unfolded and their SADs
    and costs ranked at once."""
    dev = org.device
    nb = nby * nbx
    c_dy, c_dx, c_ref = coarse
    by, bx = _block_grid(s, nby, nbx, dev)
    org16 = _blocks16(org, s, nby, nbx)
    mv_px, mv_py = _mv_pred_median(c_dx * 4, c_dy * 4)
    ref = c_ref.reshape(-1)
    dy0 = c_dy.reshape(-1)
    dx0 = c_dx.reshape(-1)
    steps = torch.arange(-3, 4, device=dev)
    win = s + 2 * MARGIN
    w = mc.gather_windows(refs_y, ref, bx + dx0 + (PAD_FULL - MARGIN),
                          by + dy0 + (PAD_FULL - MARGIN), win, win)
    cands = w.unfold(1, s, 1).unfold(2, s, 1)[
        :, MARGIN - 3:MARGIN + 4, MARGIN - 3:MARGIN + 4]
    sad = ((org16[:, None, None] - cands).abs().sum(
        dim=(-2, -1)) >> bit_inc).reshape(nb, 49)
    bits = _mv_bits(mv_px.reshape(-1), mv_py.reshape(-1),
                    (dx0[:, None] + steps) * 4,
                    (dy0[:, None] + steps) * 4).reshape(nb, 49)
    cost = sad.to(torch.float32) + sqrt_lam * bits.to(torch.float32)
    best_d = cost.argmin(dim=1)
    return dx0 + best_d % 7 - 3, dy0 + best_d // 7 - 3


def int_refine(org, refs_y, coarse, s: int, nby: int, nbx: int, sqrt_lam,
               bit_inc: int):
    """The +-3 full-pel refinement of one size class around its coarse
    field (dy, dx, ref; full pel, int64 [nby, nbx]): per block the 49
    SADs against the source (>> bit_inc) plus sqrt_lam times the
    exp-Golomb bits against the median of the coarse field's left, above
    and above-right MVs; the first minimum in (dy, dx) raster order ->
    (int_mx, int_my) full pel, int64 [nby*nbx].  org: the source plane
    [>= nby*s, >= nbx*s]; refs_y: the references' luma planes [P, ...]
    padded by PAD_FULL.  On CUDA tensors the integer-refinement kernel
    (and raises if it cannot launch); on CPU tensors the plain form."""
    dev = org.device
    if dev.type == "cpu":
        return int_refine_plain(org, refs_y, coarse, s, nby, nbx, sqrt_lam,
                                bit_inc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return inter_me_kernel.int_refine(
        org.to(torch.int16).contiguous(), refs_y.contiguous(),
        tuple(c.contiguous() for c in coarse), s, nby, nbx, sqrt_lam,
        bit_inc, PAD_FULL)


def merge_model_plain(org, org_cb, org_cr, refs_y, refs_c, s: int, nby: int,
                      nbx: int, rd_terms, winner, lam, cw, bit_inc: int):
    """The plain form of ``merge_model``: the neighbour grids by
    ``_shift_grid``, the three candidates' luma predictions in one
    ``mc.mc_blocks`` call and the winner's Cb and Cr in another."""
    dev = org.device
    nb = nby * nbx
    bd = 8 + bit_inc
    cs = s // 2
    d_y, b_y, d_cb, b_cb, d_cr, b_cr = rd_terms
    mv_qx, mv_qy, ref = winner
    by, bx = _block_grid(s, nby, nbx, dev)
    org_b = _blocks(org, s, nby, nbx)
    # AMVP-proxy mvd pricing: the refined winner field's left/above
    # neighbours, best of two (xCheckBestMVP)
    gx = mv_qx.reshape(nby, nbx)
    gy = mv_qy.reshape(nby, nbx)
    nl = (_shift_grid(gx, 0, 1).reshape(-1),
          _shift_grid(gy, 0, 1).reshape(-1))
    na = (_shift_grid(gx, 1, 0).reshape(-1),
          _shift_grid(gy, 1, 0).reshape(-1))
    bits_l = _golomb_bits(mv_qx - nl[0]) + _golomb_bits(mv_qy - nl[1])
    bits_a = _golomb_bits(mv_qx - na[0]) + _golomb_bits(mv_qy - na[1])
    mvb = torch.minimum(bits_l, bits_a) + 2 + ref + 4
    rd = d_y.to(torch.float32) + cw * (d_cb + d_cr).to(torch.float32)
    rd = rd + lam * (b_y + b_cb + b_cr + mvb.to(torch.float32))

    # merge/skip model: the spatial left/above winners and the zero MV
    # compete on no-residual distortion (getInterMergeCandidates
    # analogue), priced at skip_flag + merge_idx bits
    rg = ref.reshape(nby, nbx)
    zero = torch.zeros_like(ref)
    cands = [(nl[0], nl[1], _shift_grid(rg, 0, 1).reshape(-1)),
             (na[0], na[1], _shift_grid(rg, 1, 0).reshape(-1)),
             (zero, zero, zero)]
    ps3 = mc.mc_blocks(refs_y, _luma_jobs(
        torch.cat([c[2] for c in cands]), torch.cat([c[0] for c in cands]),
        torch.cat([c[1] for c in cands]), by.repeat(3), bx.repeat(3)), "2d",
        True, bd, False, s, s)
    d3 = _sse(org_b.repeat(3, 1, 1), ps3, bit_inc).reshape(3, nb)
    idx_bits = torch.arange(2.0, 5.0, device=dev)[:, None]
    c3 = d3.to(torch.float32) + lam * idx_bits.to(torch.float32)
    m_cost, m_idx = c3.min(dim=0)
    s_mx, s_my, s_ref = (torch.stack(c).gather(0, m_idx[None])[0]
                         for c in zip(*cands))
    ps_cb, ps_cr = mc.mc_blocks(refs_c, _chroma_jobs(
        s_ref, s_mx, s_my, by // 2, bx // 2), "2d", False, bd, False, cs, cs,
        pair=True)
    d_scb = _sse(_blocks(org_cb, cs, nby, nbx), ps_cb, bit_inc)
    d_scr = _sse(_blocks(org_cr, cs, nby, nbx), ps_cr, bit_inc)
    skip_rd = m_cost + cw * (d_scb + d_scr).to(torch.float32)
    use_skip = skip_rd < rd
    rd = torch.minimum(rd, skip_rd)
    mv_qx = torch.where(use_skip, s_mx, mv_qx)
    mv_qy = torch.where(use_skip, s_my, mv_qy)
    ref = torch.where(use_skip, s_ref, ref)
    return tuple(v.reshape(nby, nbx) for v in (rd, mv_qx, mv_qy, ref))


def merge_model(org, org_cb, org_cr, refs_y, refs_c, s: int, nby: int,
                nbx: int, rd_terms, winner, lam, cw, bit_inc: int):
    """The RD cost of one size class's motion winner and its merge/skip
    model: the AMVP-proxy MV bits (the cheaper of the left and above
    winners as predictor, zero outside the grid) and ``rd = d_y + cw *
    (d_cb + d_cr) + lam * (b_y + b_cb + b_cr + mv bits)``; the left,
    above and zero-MV candidates priced at their luma SSE plus lam * (2
    + i), the first minimum's Cb and Cr SSE added with cw, and skip taken
    where strictly cheaper.  org, org_cb, org_cr: the source planes;
    refs_y [P, ...] and refs_c (Cb then Cr, [2P, ...]): the references'
    padded planes; rd_terms: (d_y, b_y, d_cb, b_cb, d_cr, b_cr), the
    winner's transform-RD estimates [nby*nbx]; winner: (mvx, mvy (quarter
    pel), ref), int32 [nby*nbx] -> (rd float32, mvx, mvy, ref int32),
    each [nby, nbx].  On CUDA tensors the merge-model kernel (and raises
    if it cannot launch); on CPU tensors the plain form."""
    dev = org.device
    if dev.type == "cpu":
        return merge_model_plain(org, org_cb, org_cr, refs_y, refs_c, s,
                                 nby, nbx, rd_terms, winner, lam, cw,
                                 bit_inc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return inter_me_kernel.merge_model(
        tuple(p.to(torch.int16).contiguous() for p in (org, org_cb, org_cr)),
        refs_y.contiguous(), refs_c.contiguous(), s, nby, nbx,
        tuple(t.to(torch.float32 if k % 2 else torch.int32).contiguous()
              for k, t in enumerate(rd_terms)),
        tuple(t.to(torch.int32).contiguous() for t in winner), lam, cw,
        bit_inc, PAD_FULL, PAD_C)


def qpel_pick_plain(satd, coarse, int_mx, int_my, sqrt_lam):
    """The plain form of ``qpel_pick``: the median predictor's grids by
    ``_shift_grid``, the 49 candidates' bits (``_mv_bits``) and costs at
    once and ``argmin``'s first minimum."""
    dev = satd.device
    nb = satd.shape[0]
    c_dy, c_dx, c_ref = coarse
    steps = torch.arange(-3, 4, device=dev)
    mv_px, mv_py = _mv_pred_median(c_dx * 4, c_dy * 4)
    bits = _mv_bits(mv_px.reshape(-1), mv_py.reshape(-1),
                    int_mx[:, None] * 4 + steps,
                    int_my[:, None] * 4 + steps).reshape(nb, 49)
    cost = satd.to(torch.float32) + sqrt_lam * bits.to(torch.float32)
    best_q = cost.argmin(dim=1)
    return ((int_mx * 4 + best_q % 7 - 3).to(torch.int32),
            (int_my * 4 + best_q // 7 - 3).to(torch.int32),
            c_ref.reshape(-1).to(torch.int32))


def qpel_pick(satd, coarse, int_mx, int_my, sqrt_lam):
    """The quarter-pel winner of one size class: per block the 49
    candidates' SATD (int32 [nb, 49], candidate (qdy + 3) * 7 + qdx + 3
    at quarter-pel offset (qdx, qdy) from the integer winner int_mx,
    int_my (full pel, [nb])) plus sqrt_lam times the exp-Golomb bits
    against the median of the coarse field's (dy, dx, ref; [nby, nbx])
    left, above and above-right MVs; the first minimum -> (mv_qx, mv_qy
    (quarter pel), ref), int32 [nb] each.  On CUDA tensors the quarter-pel
    pick kernel (and raises if it cannot launch); on CPU tensors the
    plain form."""
    dev = satd.device
    if dev.type == "cpu":
        return qpel_pick_plain(satd, coarse, int_mx, int_my, sqrt_lam)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return inter_me_kernel.qpel_pick(satd, coarse, int_mx, int_my, sqrt_lam)


def _bi_cost(leaf0, leaf1, terms, lam, cw):
    """The bi prediction's RD cost of a size class: the MV bits
    golomb(mvx) + golomb(mvy) + 2 + ref of both lists' leaves (rd, mvx,
    mvy, ref; [nby, nbx]) as an integer, and d_y + cw * (d_cb + d_cr) +
    lam * (b_y + b_cb + b_cr + mv bits + 5) over the bi terms ([nby *
    nbx]), each an eager op left to right -> float32 [nby, nbx]."""
    mvbits = None
    for (_rd, mvx, mvy, ref) in (leaf0, leaf1):
        b = _golomb_bits(mvx) + _golomb_bits(mvy) + 2 + ref
        mvbits = b if mvbits is None else mvbits + b
    mvbits = mvbits.reshape(-1).to(torch.float32)
    d_y, b_y, d_cb, b_cb, d_cr, b_cr = terms
    rd = d_y.to(torch.float32) + cw * (d_cb + d_cr).to(torch.float32)
    rd = rd + lam * (b_y + b_cb + b_cr + mvbits + 5.0)
    return rd.reshape(leaf0[1].shape)


def bi_pick_plain(classes, lam, cw, ctu_size: int):
    """The plain form of ``bi_pick``: class by class, the bi RD cost
    (``_bi_cost``) and the direction, each an eager op."""
    out = {}
    for s in sorted(classes):
        leaf0, leaf1, terms = classes[s]
        rd0, rd1 = leaf0[0], leaf1[0]
        rd_bi = _bi_cost(leaf0, leaf1, terms, lam, cw)
        # dir = argmin{L0, L1, BI} (TEncSearch.cpp:3660-3760); int32, as
        # the other leaf fields
        rd = torch.minimum(torch.minimum(rd0, rd1), rd_bi)
        direc = torch.where(rd == rd_bi, 3, torch.where(
            rd == rd0, 1, torch.full_like(leaf0[3], 2)))
        out[s] = (rd, direc)
    return out


def bi_pick(classes, lam, cw, ctu_size: int):
    """The bi stage's pick of every inter size class up to ``ctu_size``:
    ``classes[s]`` = (leaf0, leaf1, terms), each list's leaf (rd float32,
    mvx, mvy (quarter pel), ref int32; [nby, nbx]) and the bi prediction's
    transform-RD estimates (d_y, b_y, d_cb, b_cb, d_cr, b_cr: int32 dist,
    float32 bits, [nby * nbx]); lam and cw 0-d float32.  The bi cost is
    d_y + cw * (d_cb + d_cr) + lam * (b_y + b_cb + b_cr + mv bits + 5),
    the MV bits golomb(mvx) + golomb(mvy) + 2 + ref of each list ->
    {s: (rd, dir)}, [nby, nbx] each: rd the least of L0, L1 and BI, dir 3
    where it is BI, else 1 where it is L0, else 2.  On CUDA tensors the
    bi pick kernel, one launch for every class (and raises if it cannot
    launch); on CPU tensors the plain form."""
    dev = lam.device
    if dev.type == "cpu":
        return bi_pick_plain(classes, lam, cw, ctu_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return inter_me_kernel.bi_pick(classes, lam, cw, ctu_size)


def _inter_size_pass(org_full, org_cb, org_cr, refs_y, refs_c, s: int,
                     nby: int, nbx: int, coarse, qp_scaled, qp_cb, qp_cr,
                     lam, sqrt_lam, cw, bit_inc: int, max_val: int,
                     blocks=None):
    """One inter size class: refine the coarse field, sub-pel search,
    RD-estimate the winner and a skip model.  org_*: the source planes;
    refs_y: the references' luma planes [P, ...]; refs_c: their Cb
    planes, then their Cr planes [2P, ...]; blocks: the class's source
    blocks (``_source_blocks``), cut here when not given.  Returns (rd
    float32, mvx, mvy (quarter-pel), ref (int32 each)), each [nby,
    nbx]."""
    dev = org_full.device
    bd = 8 + bit_inc
    if blocks is None:
        blocks = _source_blocks(org_full, org_cb, org_cr, s, nby, nbx)
    org_b, org_bcb, org_bcr = blocks

    # ---- integer refinement: +-3 around the coarse winner -------------
    with stage("fast_inter.int_refine", dev):
        int_mx, int_my = int_refine(org_full, refs_y, coarse, s, nby, nbx,
                                    sqrt_lam, bit_inc)

    # ---- quarter-pel refinement: the full 7x7 sub-pel window -----------
    # re-anchored on the integer winner; one MC launch for the 49
    # candidates of every block (candidate (qdy + 3) * 7 + qdx + 3 at
    # quarter-pel offset (qdx, qdy)), one SATD launch, one pick launch
    with stage("fast_inter.qpel_mc_satd", dev):
        preds = _qpel_preds(refs_y, coarse[2].reshape(-1), int_mx, int_my,
                            s, nbx, bd)
        satd = satd_blocks(org_b, preds, bit_inc)
        del preds
        winner = qpel_pick(satd, coarse, int_mx, int_my, sqrt_lam)

    # ---- RD estimate at the winner --------------------------------------
    cs = s // 2
    with stage("fast_inter.tq_rd", dev):
        # the fields are (ref, mvx, mvy)
        field = (winner[2], winner[0], winner[1])
        pred_l = _pred_luma(refs_y, field, s, nbx, bd)
        d_y, b_y = fi.tu_rd(org_b, pred_l, s, qp_scaled, bit_inc, max_val,
                            is_intra=False)
        pred_cb, pred_cr = _pred_chroma(refs_c, field, cs, nbx, bd)
        d_cb, b_cb = fi.tu_rd(org_bcb, pred_cb, _tq_size(cs), qp_cb,
                              bit_inc, max_val, is_intra=False)
        d_cr, b_cr = fi.tu_rd(org_bcr, pred_cr, _tq_size(cs), qp_cr,
                              bit_inc, max_val, is_intra=False)

    with stage("fast_inter.merge_model", dev):
        return merge_model(org_full, org_cb, org_cr, refs_y, refs_c, s, nby,
                           nbx, (d_y, b_y, d_cb, b_cb, d_cr, b_cr), winner,
                           lam, cw, bit_inc)


def _bi_terms(blocks, refs2, uni2, s: int, nbx: int, qp_scaled, qp_cb,
              qp_cr, bit_inc: int, max_val: int):
    """Bi-prediction RD terms for one size class: average the two lists'
    uni winners' predictions (TComYuv::addAvg) and transform/quant the
    residual (the bi stage of xMotionEstimation, TEncSearch.cpp:3419-3520,
    with the iterations collapsed to the uni winners).  blocks: the
    class's source blocks (``_source_blocks``); refs2: per list the
    stacked (luma, chroma) reference planes (``_inter_size_pass``); uni2:
    per list (rd, mvx, mvy, ref).  Both lists' predictions are averaged in
    the MC call: one for luma, one for Cb and Cr.  Returns the bi
    prediction's (d_y, b_y, d_cb, b_cb, d_cr, b_cr), [nby * nbx] each,
    which ``bi_pick`` prices."""
    bd = 8 + bit_inc
    cs = s // 2
    org_b, org_bcb, org_bcr = blocks
    fields = [(ref.reshape(-1), mvx.reshape(-1), mvy.reshape(-1))
              for (_rd, mvx, mvy, ref) in uni2]
    (ry0, rc0), (ry1, rc1) = refs2
    pl = _pred_luma(ry0, fields[0], s, nbx, bd, True, ry1, fields[1])
    pcb, pcr = _pred_chroma(rc0, fields[0], cs, nbx, bd, True, rc1,
                            fields[1])
    d_y, b_y = fi.tu_rd(org_b, pl, s, qp_scaled, bit_inc, max_val,
                        is_intra=False)
    d_cb, b_cb = fi.tu_rd(org_bcb, pcb, _tq_size(cs), qp_cb, bit_inc,
                          max_val, is_intra=False)
    d_cr, b_cr = fi.tu_rd(org_bcr, pcr, _tq_size(cs), qp_cr, bit_inc,
                          max_val, is_intra=False)
    return d_y, b_y, d_cb, b_cb, d_cr, b_cr


def _bi_size_pass(org_full, org_cb, org_cr, refs2, uni2, s: int, nby: int,
                  nbx: int, qp_scaled, qp_cb, qp_cr, lam, cw, bit_inc: int,
                  max_val: int):
    """The bi prediction's RD cost of one size class alone (the JAX
    package's ``_bi_size_pass``): its terms (``_bi_terms``) priced by
    ``_bi_cost`` -> rd [nby, nbx] float32.  The pass prices every class's
    terms in one ``bi_pick``."""
    terms = _bi_terms(_source_blocks(org_full, org_cb, org_cr, s, nby, nbx),
                      refs2, uni2, s, nbx, qp_scaled, qp_cb, qp_cr, bit_inc,
                      max_val)
    return _bi_cost(uni2[0], uni2[1], terms, lam, cw)


def _source_blocks(org_full, org_cb, org_cr, s: int, nby: int, nbx: int):
    """A size class's source blocks as contiguous int16: luma [nb, s, s],
    Cb and Cr [nb, s/2, s/2], made once a frame for both lists and the bi
    stage."""
    cs = s // 2
    return (_blocks16(org_full, s, nby, nbx),
            _blocks16(org_cb, cs, nby, nbx), _blocks16(org_cr, cs, nby, nbx))


def _frame_body_p(py, pcb, pcr, refs, iscal, fscal, wp: int, hp: int,
                  statics, max_sig: int, min_tr_log2: int, refs1=None):
    """The whole P/B-slice decision problem: intra size classes + chroma
    (``fast_intra``), inter motion search per size class (per list for
    B, plus the bi stage on the uni winners), the quadtree DP and the
    unit maps -> int16 [10 (P) or 14 (B), hp//4, wp//4].

    refs / refs1: ``RefCache`` entries of the L0 / L1 references in list
    order; iscal = (qp luma, qp Cb, qp Cr), fscal = (lambda, sqrt-lambda,
    the three mode-bit classes, the two chroma-bit classes, the chroma
    weight, the motion lambda).  py, pcb, pcr: the padded int16 source
    planes (the intra kernels read them as they are)."""
    (width, height, bit_inc, max_val, ctu_size, search_range) = statics
    dev = py.device
    qp_scaled, qp_cb, qp_cr = iscal[0], iscal[1], iscal[2]
    lam, sqrt_lam = fscal[0], fscal[1]
    cw, sqrt_lam_me = fscal[7], fscal[8]

    # ---- intra leaves (the I-slice passes) -----------------------------
    with stage("fast_inter.intra_leaves", dev):
        res = fi._luma_passes(py, wp, hp, qp_scaled,
                              ((fscal[2], fscal[3], fscal[4]), sqrt_lam,
                               lam), bit_inc, max_val, ctu_size)
        lam_w_bits2 = ((fscal[5], fscal[6]), lam, cw)
        cres = {s: fi._chroma_pass_impl(pcb, pcr, s, hp // s, wp // s,
                                        res[s].cids, qp_cb, qp_cr, bit_inc,
                                        max_val)
                for s in fi.SIZES if 8 <= s <= ctu_size}
        cres8_nxn = fi._chroma_pass_impl(pcb, pcr, 8, hp // 8, wp // 8,
                                         res[4].cids, qp_cb, qp_cr, bit_inc,
                                         max_val)

    # ---- inter leaves ----------------------------------------------------
    # the source planes as contiguous int16, as the kernels read them
    org_full = py[1:1 + hp, 1:1 + wp].contiguous()
    org_cb = pcb[1:1 + hp // 2, 1:1 + wp // 2].contiguous()
    org_cr = pcr[1:1 + hp // 2, 1:1 + wp // 2].contiguous()
    rng_q = search_range // 4
    hq, wq = hp // 4, wp // 4
    sizes = [s for s in INTER_SIZES if s <= ctu_size]
    with stage("fast_inter.blocks", dev):
        blocks = {s: _source_blocks(org_full, org_cb, org_cr, s, hp // s,
                                    wp // s) for s in sizes}

    def uni_leaves(entries):
        with stage("fast_inter.coarse", dev):
            coarse = _coarse_fields(_avgpool(org_full, 4),
                                    [e.quarter(rng_q, hp, wp)
                                     for e in entries],
                                    rng_q, hq, wq, sqrt_lam_me, ctu_size)
        # luma [P, ...]; Cb then Cr [2P, ...], whose halves are the Cb and
        # Cr stacks (one MC call predicts both)
        planes = (torch.stack([e.planes[0] for e in entries]),
                  torch.stack([e.planes[c] for c in (1, 2)
                               for e in entries]))
        out = {s: _inter_size_pass(org_full, org_cb, org_cr, *planes, s,
                                   hp // s, wp // s, coarse[s], qp_scaled,
                                   qp_cb, qp_cr, lam, sqrt_lam_me, cw,
                                   bit_inc, max_val, blocks[s])
               for s in sizes}
        return out, planes

    uni0, planes0 = uni_leaves(refs)
    if refs1 is None:
        with stage("fast_inter.dp", dev):
            maps = fi._dp_expand(res, cres, cres8_nxn, width, height, lam,
                                 lam_w_bits2, max_sig, min_tr_log2,
                                 ctu_size, wp, hp, inter=uni0,
                                 intra_pen=_INTRA_PEN_BITS)
        return maps

    uni1, planes1 = uni_leaves(refs1)
    with stage("fast_inter.bi", dev):
        picked = bi_pick(
            {s: (uni0[s], uni1[s], _bi_terms(
                blocks[s], (planes0, planes1), (uni0[s], uni1[s]), s,
                wp // s, qp_scaled, qp_cb, qp_cr, bit_inc, max_val))
             for s in sizes}, lam, cw, ctu_size)
        inter = {s: (picked[s][0], *uni0[s][1:], picked[s][1],
                     *uni1[s][1:]) for s in sizes}
    with stage("fast_inter.dp", dev):
        maps = fi._dp_expand(res, cres, cres8_nxn, width, height, lam,
                             lam_w_bits2, max_sig, min_tr_log2, ctu_size,
                             wp, hp, inter=inter, intra_pen=_INTRA_PEN_BITS)
    return maps


# ---------------------------------------------------------------------------
# reference planes on the device
# ---------------------------------------------------------------------------

class _RefEntry:
    """One reference picture's planes on the device: edge-padded by
    PAD_FULL (luma) and PAD_C (chroma) around the CTU-padded picture, and
    its quarter-res search band, made once."""

    def __init__(self, host, planes):
        self.host = host               # the recon planes (identity key)
        self.planes = planes           # int16 (y, cb, cr), padded
        self._quarter = {}

    def quarter(self, rng_q: int, hp: int, wp: int):
        """The +-4*rng_q band around the picture, 4x4 mean-pooled:
        [hp/4 + 2 rng_q, wp/4 + 2 rng_q] (every coarse offset a slice)."""
        q = self._quarter.get(rng_q)
        if q is None:
            band = self.planes[0][PAD_FULL - 4 * rng_q:
                                  PAD_FULL + hp + 4 * rng_q,
                                  PAD_FULL - 4 * rng_q:
                                  PAD_FULL + wp + 4 * rng_q]
            q = self._quarter[rng_q] = _avgpool(band.to(torch.int32),
                                                4).to(torch.int16)
        return q


def _edge_pad(plane, top: int, bottom: int, left: int, right: int):
    """Edge-replicate padding of a 2-D device plane (np.pad mode edge)."""
    h, w = plane.shape
    dev = plane.device
    rows = torch.arange(-top, h + bottom, device=dev).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=dev).clamp(0, w - 1)
    return plane[rows[:, None], cols[None, :]]


class RefCache:
    """The device planes of an encode's reference pictures, keyed by the
    recon planes (``(poc, rec_y, rec_cb, rec_cr)`` of the reference
    lists): each reference crosses to the device once while it stays in
    the encoder's DPB, and ``retain`` drops it when it leaves."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_key: dict = {}

    def entries(self, pics, hp: int, wp: int, device) -> list:
        """The entries of ``pics`` (lists of (poc, y, cb, cr)), each
        uploaded at its first call."""
        with self._lock:
            out = []
            for group in pics:
                row = []
                for poc, y, cb, cr in group:
                    key = (poc, id(y))
                    e = self._by_key.get(key)
                    if e is None or e.host[0] is not y:
                        e = self._by_key[key] = self._upload(
                            (y, cb, cr), hp, wp, device)
                    row.append(e)
                out.append(row)
            return out

    def retain(self, rec_ys) -> None:
        """Keep only the entries whose luma recon plane is one of
        ``rec_ys`` (the pictures still held for reference)."""
        keep = {id(y) for y in rec_ys}
        with self._lock:
            self._by_key = {k: e for k, e in self._by_key.items()
                            if id(e.host[0]) in keep}

    @staticmethod
    def _upload(host, hp: int, wp: int, device) -> _RefEntry:
        arrs = [np.ascontiguousarray(p, np.int16) for p in host]
        dev_stats.stat_h2d(sum(a.nbytes for a in arrs))
        planes = []
        for a, m, div in zip(arrs, (PAD_FULL, PAD_C, PAD_C), (1, 2, 2)):
            t = torch.from_numpy(a).to(device)
            h, w = a.shape
            planes.append(_edge_pad(t, m, m + hp // div - h, m,
                                    m + wp // div - w))
        return _RefEntry(host, planes)

    def __len__(self) -> int:
        return len(self._by_key)


def dispatch_frame_p(org_y, org_cb, org_cr, ref_pics, width: int,
                     height: int, qp_scaled: int, qp_cb: int, qp_cr: int,
                     lambda_: float, sqrt_lambda: float,
                     sqrt_lambda_me: float, bits3: tuple, cbits2: tuple,
                     max_sig: int, min_tr_log2: int, search_range: int,
                     ctu_size: int = 64, bit_inc: int = 0,
                     max_val: int = 255, ref_pics_l1=None, *, device,
                     ref_cache: RefCache | None = None):
    """Start the P/B-slice decision pass on ``device``: upload the source
    planes (and each reference not yet on the device) and queue the
    work.  ref_pics: (poc, rec_y, rec_cb, rec_cr) of the L0 references in
    list order; ref_pics_l1 likewise for a B slice (None for P).  Returns
    a token for ``collect_frame_p``; on a CUDA device the work runs
    asynchronously."""
    device = torch.device(device)
    if 4 * (search_range // 4) > PAD_FULL - 16:
        raise ValueError(f"search range {search_range} exceeds the "
                         f"reference padding ({PAD_FULL})")
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    cache = ref_cache if ref_cache is not None else RefCache()
    lists = [ref_pics] + ([ref_pics_l1] if ref_pics_l1 is not None else [])
    refs = cache.entries(lists, hp, wp, device)
    iscal = np.asarray([qp_scaled, qp_cb, qp_cr], np.int32)
    fscal = np.asarray([lambda_, sqrt_lambda, bits3[0], bits3[1], bits3[2],
                        cbits2[0], cbits2[1], cbits2[2], sqrt_lambda_me],
                       np.float32)
    host = [np.ascontiguousarray(p, np.int16) for p in fi._source_planes(
        org_y, org_cb, org_cr, width, height, ctu_size)] + [iscal, fscal]
    dev_stats.stat_launch(sum(a.nbytes for a in host))
    py, pcb, pcr, iscal, fscal = (torch.from_numpy(a).to(device)
                                  for a in host)
    statics = (width, height, bit_inc, max_val, ctu_size, search_range)
    out = _frame_body_p(py, pcb, pcr, refs[0], iscal, fscal, wp, hp,
                        statics, max_sig, min_tr_log2,
                        refs1=refs[1] if len(refs) > 1 else None)
    return out, wp, hp


def collect_frame_p(token):
    """Finish a dispatched P or B decision pass with one device-to-host
    copy: (depth, mode, nxn, chroma, mode2, mode3, pred, ref) int8
    [hp/4, wp/4] planes (nxn contiguous uint8) and (mvx, mvy) int16
    quarter-pel; a B slice's add (dir, ref1) int8 and (mvx1, mvy1)
    int16 (the reference's ``collect_frame_p`` / ``collect_frame_b``)."""
    out, _, _ = token
    packed = out.cpu().numpy()
    dev_stats.stat_d2h(packed.nbytes)
    maps = [p.astype(np.int8) for p in packed[:8]]
    maps[2] = np.ascontiguousarray(maps[2], np.uint8)
    maps += [packed[8], packed[9]]
    if len(packed) > 10:
        maps += [packed[10].astype(np.int8), packed[11].astype(np.int8),
                 packed[12], packed[13]]
    return tuple(maps)


def decide_frame_p(org_y, org_cb, org_cr, ref_pics, width: int, height: int,
                   qp_scaled: int, qp_cb: int, qp_cr: int, lambda_: float,
                   sqrt_lambda: float, sqrt_lambda_me: float, bits3: tuple,
                   cbits2: tuple, max_sig: int, min_tr_log2: int,
                   search_range: int, ctu_size: int = 64, bit_inc: int = 0,
                   max_val: int = 255, ref_pics_l1=None, *, device,
                   stats=None, ref_cache: RefCache | None = None):
    """Run the P/B decision pass for one frame on ``device`` and return
    its maps (``collect_frame_p``; 14 with ``ref_pics_l1``, else 10).
    The positional arguments are those of the
    reference's ``dispatch_frame_p``.  ``stats`` (``encoder.top.
    DecisionStats``) gets the wall time, from the call to the maps on the
    host; ``ref_cache`` keeps the references on the device across the
    frames of an encode."""
    if device is None:
        raise TypeError("decide_frame_p needs a device")
    t0 = time.perf_counter()
    maps = collect_frame_p(dispatch_frame_p(
        org_y, org_cb, org_cr, ref_pics, width, height, qp_scaled, qp_cb,
        qp_cr, lambda_, sqrt_lambda, sqrt_lambda_me, bits3, cbits2, max_sig,
        min_tr_log2, search_range, ctu_size, bit_inc, max_val, ref_pics_l1,
        device=device, ref_cache=ref_cache))
    if stats is not None:
        stats.add(time.perf_counter() - t0, inter=True)
    return maps
