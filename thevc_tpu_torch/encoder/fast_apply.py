"""The fast-RD device apply in PyTorch: the closed-loop intra wavefront.

A port of ``thevc_tpu/encoder/fast_apply.py``.  The decision pass
(``encoder.fast_intra``) fixes the quadtree, the luma modes and the
chroma modes open-loop; this module runs the whole apply of an intra
frame on a torch device: prediction from the real reconstructed
neighbours, forward transform, quantisation (RDOQ or plain) with
sign-bit hiding, dequant, inverse transform and reconstruction.  The
host keeps the entropy coding.

1. The native schedule builder (``enc_fd_schedule`` in the port's
   ``native/codec_core.cpp``) walks the fixed tree in decode order and
   gives every TU its reference-line clamp ``[lo, hi]`` (HM's
   unavailable-sample substitution over a contiguous available range)
   and its wave: one more than the latest wave among the units its
   reference line reads.  TUs of one wave are independent.
   ``build_schedule`` buckets the records per size class (luma 4/8/16/32,
   DST at 4; chroma 4/8/16), sorted by wave.
2. On ``cuda`` the frame is one launch of the hand-written kernel
   (``ops.apply_kernel``, ``csrc/apply.cu``).  ``frame_items`` lists the
   frame's items (a record on one plane; Cb and Cr are items of their
   own) wave by wave, then the padding rows that the plain form's
   windows compute; the kernel's CTAs take them by ticket in that order,
   and an item waits only until the units under its available range are
   written (``wait_units``: the wait rule; ``own_units``: what a writer
   flags), not for a wave to end.  ``apply_items`` dispatches an item
   list on the device: the kernel on ``cuda``, the plain version
   (``apply_items_plain``, each item through ``_class_step_plain`` in
   list order) on the CPU.
3. The plain form (``run_device_apply_plain``, and ``run_device_apply``
   on the CPU) runs the wave loop on the host over ``n_waves``.  Each
   class step takes a fixed-size window of its class's records from a
   start offset that it reads from a device counter, gathers the
   reference lines out of the evolving recon plane, predicts,
   transforms, quantises (RDOQ or plain), hides sign bits, dequantises
   and inverse-transforms, adds and clips, and writes recon into the
   plane and levels into flat per-record stacks: ``_class_step_plain``
   for each plane, with ``_predict_batch``, ``ops.tq.forward_transform``
   (float64 and exact), ``_rdoq_batch`` or ``ops.tq.quant``,
   ``_sbh_batch`` and ``ops.tq.residual_pipeline`` (on ``cuda`` the
   residual kernel, K1).  Window entries past the wave recompute
   harmlessly later: a region is never read before its own wave has
   run.  On ``cuda`` each step is captured once per frame as a CUDA
   graph and replayed per wave.  It is the yardstick the tests and
   ``chip_smoke.py`` hold the kernel to.
4. One device-to-host copy brings the recon planes (int16, the planes'
   own type) and the level stacks back; ``assemble_coeff_planes``
   scatters the levels into the frame's coefficient planes, and the
   encoder fills the syntax arrays (``fill_from_fd``) and runs the
   counter pass, SAO and CABAC.

What differs from the reference, on purpose:

- ``device`` is an argument; nothing picks one behind the caller's back.
- The TPU workarounds are gone: the static-scan shuffles and masked
  selects are plain gathers, the windowed ``dynamic_slice`` gathers are
  one index tensor each, ``_bitlen`` is an exact ``frexp``, and recon
  comes back as int16 (the reference's uint8 fetch saved link bytes).
- Float order.  ``_rdoq_batch`` ranks float32 costs, so every float32
  reduction is an explicit elementwise add tree (sums) or Hillis-Steele
  scan (suffix sums), and every ``a + b * c`` is two eager ops: the CPU
  and the card give the same bits, hence the same levels.  Against the
  JAX package (XLA picks its own reduction order) a level can differ in a
  near tie; ``tests/test_torch_fast_apply_jax.py`` counts those.
- The reference's device apply drops the closed-loop top-2 re-rank of
  the host apply (its mode2/mode3 maps are not read here); the port keeps
  the reference's decisions, so byte identity with the host apply holds
  only with ``THEVC_FASTRD_TOP2=0`` and RDOQ off.
- ``THEVC_FASTRD_DEVCHROMA=0`` with the device apply wrote a
  nonconformant stream in the reference (recon used the decided chroma
  modes while the syntax signalled DM); ``encoder.top.Encoder`` refuses
  that combination.
- Any out-of-plane read of a padding record is clamped into the plane
  (XLA clamps ``dynamic_slice`` starts; a torch gather would fault).
  Those records take the DC fill, so the values read do not matter.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time

import numpy as np
import torch

from ..common import rom
from ..common.tables import from_reference
from ..ops import apply_kernel, residual_kernel, tq
from ..ops.intra import (DC_IDX, HOR_IDX, INTRA_FILTER_THRESH, PLANAR_IDX,
                         VER_IDX)
from .fast_intra import _plan_tensors, _predict_mode, _smooth, _unified_plan

# class table: (size, is_luma, use_dst), the kernel's
CLS = apply_kernel.CLASSES
GUARD = 48          # bottom/right guard so edge gathers stay in-bounds


# ---------------------------------------------------------------------------
# schedule build (host, native) -- thevc_tpu/encoder/fast_apply.py:72-149
# ---------------------------------------------------------------------------

class Schedule:
    __slots__ = ("n_waves", "flat", "offs", "caps", "counts")


def build_schedule(fd_depth, fd_mode, fd_nxn, fd_chroma, width, height,
                   ctu_size, max_sig, min_tr_log2):
    """Run the native wavefront schedule builder and bucket the TU records
    per size class sorted by wave.  Returns a Schedule or None when the
    frame needs the host fallback (non-contiguous availability)."""
    from .. import native
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "enc_fd_schedule"):
        return None
    uh, uw = fd_depth.shape
    ctus_w = (uw * 4) // ctu_size
    ctus_h = (uh * 4) // ctu_size
    cap = uh * uw + (uh * uw) // 2 + 64
    xs = np.empty(cap, np.int32)
    ys = np.empty(cap, np.int32)
    lo = np.empty(cap, np.int32)
    hi = np.empty(cap, np.int32)
    wave = np.empty(cap, np.int32)
    cls = np.empty(cap, np.int8)
    mode = np.empty(cap, np.int8)
    scan = np.empty(cap, np.int8)
    nw = ctypes.c_int32(0)
    fd_depth = np.ascontiguousarray(fd_depth, np.int8)
    fd_mode = np.ascontiguousarray(fd_mode, np.int8)
    fd_nxn = np.ascontiguousarray(fd_nxn, np.uint8)
    fd_chroma = np.ascontiguousarray(fd_chroma, np.int8)
    n = lib.enc_fd_schedule(
        uw, uh, width, height, ctu_size, ctus_w, ctus_h, max_sig,
        min_tr_log2, fd_depth.ctypes.data, fd_nxn.ctypes.data,
        fd_mode.ctypes.data, fd_chroma.ctypes.data, xs.ctypes.data,
        ys.ctypes.data, lo.ctypes.data, hi.ctypes.data, wave.ctypes.data,
        cls.ctypes.data, mode.ctypes.data, scan.ctypes.data, cap,
        ctypes.byref(nw))
    if n < 0:
        return None
    s = Schedule()
    s.n_waves = int(nw.value)
    s.flat, s.offs, s.caps, s.counts = [], [], [], []
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    for ci in range(len(CLS)):
        luma = CLS[ci][1]
        sel = np.nonzero(cls[:n] == ci)[0]
        order = sel[np.argsort(wave[sel], kind="stable")]
        w_sorted = wave[order]
        offs = np.searchsorted(w_sorted, np.arange(s.n_waves + 1)
                               ).astype(np.int32)
        occ = np.diff(offs)
        cap_c = int(occ.max()) if occ.size and occ.max() > 0 else 1
        cap_c = max(8, 1 << int(np.ceil(np.log2(cap_c))))
        # pad the flat arrays by the window size so a window at the last
        # offset stays in-bounds; padding records point into the guard
        # region (scatters land there and are cropped away -- a padding
        # record must NEVER alias a real position: an empty class's
        # all-zero record at (0,0) would otherwise overwrite the real
        # top-left TU on every wave)
        dummy_x = (wp if luma else wp // 2) + 2
        dummy_y = (hp if luma else hp // 2) + 2
        pads = {id(xs): dummy_x, id(ys): dummy_y, id(lo): 1, id(hi): 0,
                id(mode): DC_IDX, id(scan): 3}

        def padded(a):
            fill = pads[id(a)]
            v = a[order].astype(np.int32) if order.size else \
                np.zeros((0,), np.int32)
            return np.concatenate(
                [v, np.full(cap_c, fill, np.int32)])
        s.flat.append((padded(xs), padded(ys), padded(lo),
                       padded(hi), padded(mode), padded(scan)))
        s.offs.append(offs)
        s.caps.append(cap_c)
        s.counts.append(int(order.size))
    return s


# ---------------------------------------------------------------------------
# static tables (host) -- thevc_tpu/encoder/fast_apply.py:156-341
# ---------------------------------------------------------------------------

def _scan_tables(size: int) -> np.ndarray:
    """[3, size*size] raster positions for scan_idx 1 (hor-ish), 2
    (ver-ish), 3 (diag) in CG-major coefficient order."""
    return np.stack([np.asarray(rom.sig_last_scan(i, size), np.int32)
                     .reshape(-1) for i in (1, 2, 3)])


_rdoq_tab_cache = {}


def _rdoq_tables(size: int, luma: bool):
    """Static RDOQ constants for one class: per-scan significance-context
    maps (TComTrQuant getSigCtxInc via encoder.rdoq._sig_ctx), CG
    neighbor indices for the pattern/context proxies, and last-position
    group tables."""
    key = (size, luma)
    t = _rdoq_tab_cache.get(key)
    if t is not None:
        return t
    from .rdoq import _sig_ctx
    p = size * size
    ncg = max(1, p // 16)
    log2 = size.bit_length() - 1
    comp = 0 if luma else 1
    sig = np.zeros((3, 4, p), np.int32)
    for si, scan_idx in enumerate((1, 2, 3)):
        scan = np.asarray(rom.sig_last_scan(scan_idx, size)).reshape(-1)
        for pat in range(4):
            pt = -1 if size == 4 else pat
            for sp in range(p):
                blk = int(scan[sp])
                py, px = blk >> log2, blk & (size - 1)
                sig[si, pat, sp] = _sig_ctx(pt, scan_idx, px, py, log2,
                                            comp)
    # CG neighbors in CG-scan-index space (right / lower in raster)
    rgt = np.full((3, ncg), ncg, np.int32)      # ncg = "none" slot
    low = np.full((3, ncg), ncg, np.int32)
    n = size >> 2
    glx = np.zeros((3, p), np.int32)            # GROUP_IDX of last-x
    gly = np.zeros((3, p), np.int32)
    gep = np.zeros((3, p), np.int32)            # EP suffix bits
    for si, scan_idx in enumerate((1, 2, 3)):
        if n:
            cg = np.asarray(rom.cg_scan(scan_idx, size)).reshape(-1)
            inv = np.empty(n * n, np.int32)
            inv[cg] = np.arange(n * n)
            for g in range(n * n):
                blk = int(cg[g])
                cy, cx = blk // n, blk % n
                if cx < n - 1:
                    rgt[si, g] = inv[cy * n + cx + 1]
                if cy < n - 1:
                    low[si, g] = inv[(cy + 1) * n + cx]
        scan = np.asarray(rom.sig_last_scan(scan_idx, size)).reshape(-1)
        for sp in range(p):
            blk = int(scan[sp])
            py, px = blk >> log2, blk & (size - 1)
            if scan_idx == rom.SCAN_VER:
                px, py = py, px
            cx = int(rom.GROUP_IDX[px])
            cy = int(rom.GROUP_IDX[py])
            glx[si, sp] = cx
            gly[si, sp] = cy
            ep = 0
            if cx > 3:
                ep += (cx - 2) >> 1
            if cy > 3:
                ep += (cy - 2) >> 1
            gep[si, sp] = ep << 15
    t = (sig, rgt, low, glx, gly, gep)
    _rdoq_tab_cache[key] = t
    return t


_est_bits_cache = {}


def est_bits_pack(init_ctx: np.ndarray, size: int, luma: bool):
    """EstBits tables for one class at the slice-init context states,
    packed as int32 arrays for the device (frozen-context approximation
    of HM's per-CU estBit snapshots)."""
    key = (init_ctx.tobytes(), size, luma)
    t = _est_bits_cache.get(key)
    if t is not None:
        return t
    from .sbac_writer import build_est_bits
    eb = build_est_bits(init_ctx, size, luma)
    sig = np.asarray(eb.sig_bits, np.int32)
    lastx = np.asarray(eb.last_x_bits, np.int64)
    lasty = np.asarray(eb.last_y_bits, np.int64)
    sigmap, _rgt, _low, glx, gly, gep = _rdoq_tables(size, luma)
    # per-(scan, pattern, position) sig-flag bits and per-(scan,
    # position) last-position rates, combined host-side
    sig0p = sig[sigmap, 0].astype(np.float32)         # [3, 4, P]
    sig1p = sig[sigmap, 1].astype(np.float32)
    rlv = (lastx[glx] + lasty[gly] + gep).astype(np.float32)   # [3, P]
    t = dict(
        sig=sig,
        one=np.asarray(eb.greater_one_bits, np.int32),
        abs_=np.asarray(eb.level_abs_bits, np.int32),
        cg=np.asarray(eb.sig_cg_bits, np.int32),
        cbp=np.asarray(eb.block_cbp_bits, np.int32),
        sig0p=sig0p, sig1p=sig1p, rlv=rlv,
    )
    _est_bits_cache[key] = t
    return t


# ---------------------------------------------------------------------------
# device tables
# ---------------------------------------------------------------------------

# context-indexed bit tables are padded with zeros to this many entries:
# the reference reads them with masked selects (``_take_small``) that give
# 0 past the table's end, and its greater-2 context proxy reaches past the
# end (luma contexts 4-5 of a 4-entry table, chroma 2-3 of 2)
_CTX_PAD = apply_kernel.CTX_PAD


@functools.lru_cache(maxsize=None)
def _scan_tensors(size: int, luma: bool, device: torch.device):
    """One class's index tables on ``device``: the scans [3, P] (coefficient
    order -> raster), their inverses [3, P], and the right and lower CG
    neighbours [3, ncg] (``ncg`` = none)."""
    scan = _scan_tables(size)
    inv = np.empty_like(scan)
    for si in range(3):
        inv[si, scan[si]] = np.arange(scan.shape[1])
    _sig, rgt, low = _rdoq_tables(size, luma)[:3]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
    return dev(scan), dev(inv), dev(rgt), dev(low)


@functools.lru_cache(maxsize=64)
def _est_bits_tensors(init_bytes: bytes, size: int, luma: bool,
                      device: torch.device) -> dict:
    """``est_bits_pack`` of one class on ``device``: the float32 tables
    RDOQ reads, the context-indexed ones split by bin and padded to
    ``_CTX_PAD`` entries; the sigCG bits stay host integers."""
    eb = est_bits_pack(np.frombuffer(init_bytes, np.uint8), size, luma)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    def col(tab, b):
        out = np.zeros(_CTX_PAD, np.float32)
        out[:len(tab)] = tab[:, b]
        return f32(out)
    return dict(sig0p=f32(eb["sig0p"]), sig1p=f32(eb["sig1p"]),
                rlv=f32(eb["rlv"]), one0=col(eb["one"], 0),
                one1=col(eb["one"], 1), abs0=col(eb["abs_"], 0),
                abs1=col(eb["abs_"], 1), cbf0=col(eb["cbp"], 0),
                cbf1=col(eb["cbp"], 1),
                cg=[[int(v) for v in row] for row in eb["cg"]])


def est_bits_tensors(init_ctx: np.ndarray, size: int, luma: bool,
                     device) -> dict:
    """The RDOQ bit tables of one class at the slice-init context states
    ``init_ctx`` on ``device`` (cached)."""
    return _est_bits_tensors(np.ascontiguousarray(init_ctx, np.uint8)
                             .tobytes(), size, luma, torch.device(device))


@functools.lru_cache(maxsize=None)
def kernel_tables(ci: int, device: torch.device) -> dict:
    """The static tables the apply kernel reads for class ``ci``, int32
    on ``device`` (cached): the transform basis [s, s] (DST at 4x4 luma),
    the angular gather plans [3, 33, s*s] (``fast_intra._unified_plan``:
    idx_a, idx_b, frac), the scans [3, s*s] (coefficient order ->
    raster), the right and lower CG neighbours [3, ncg] (``ncg`` = none)
    and the quant and dequant scales [6]."""
    size, luma, use_dst = CLS[ci]
    tab = from_reference(device)
    _sig, rgt, low = _rdoq_tables(size, luma)[:3]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return dict(basis=tab.basis(size, use_dst),
                plan=dev(np.stack(_unified_plan(size, luma))
                         .reshape(3, 33, size * size)),
                scan=dev(_scan_tables(size)), rgt=dev(rgt), low=dev(low),
                quant_scales=tab.quant_scales,
                inv_quant_scales=tab.inv_quant_scales)


# ---------------------------------------------------------------------------
# device math
# ---------------------------------------------------------------------------

def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power-of-two length) as a fixed tree of
    elementwise adds, ``x[..., :h] + x[..., h:]`` until one column is
    left: the same order, so the same float bits, on every device."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums over the last axis, ``out[i] = x[i] + x[i+1]
    + ...``, as Hillis-Steele steps (each adds the partial sum ``d``
    places on, ``d`` doubling): a fixed order on every device."""
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :n - d] + x[..., d:], x[..., n - d:]], dim=-1)
        d *= 2
    return x


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) + 1 for 1 <= x < 2^24, elementwise (int32): the
    binary exponent of x as float32, exact there."""
    return torch.frexp(x.to(torch.float32))[1].to(torch.int32)


def _shl(a: int, b: torch.Tensor) -> torch.Tensor:
    """``a << b`` for an integer ``a`` and an int32 tensor of shifts."""
    return torch.bitwise_left_shift(torch.full_like(b, a), b)


def _predict_batch(ra, rl, size: int, luma: bool, mode, max_val: int):
    """Single-mode intra prediction for a TU batch: ra/rl int32 [N, 2s+1],
    mode [N] -> int32 [N, s, s].  Integer-exact mirror of ops.intra.predict
    (planar :171 / DC + xDCPredFiltering :252 / xPredIntraAng :188 with
    the [1 2 1] smoothing choice baked into the gather plans)."""
    s = size
    nb = ra.shape[0]
    log2 = s.bit_length() - 1
    if luma:
        ra_f, rl_f = _smooth(ra, rl), _smooth(rl, ra)
        c = torch.cat([rl, ra[:, 1:], rl_f, ra_f[:, 1:]], dim=1)
    else:
        ra_f, rl_f = ra, rl
        c = torch.cat([rl, ra[:, 1:]], dim=1)

    # angular 2..34 via the static per-mode gather plans
    idx_a, idx_b, frac = _plan_tensors(s, luma, ra.device)
    m = (mode - 2).clamp(0, 32).long()
    a = c.gather(1, idx_a[m].reshape(nb, -1))
    b = c.gather(1, idx_b[m].reshape(nb, -1))
    fr = frac[m].reshape(nb, -1)
    ang = (((32 - fr) * a + fr * b + 16) >> 5).reshape(nb, s, s)
    if luma:
        # pure-copy edge filters (xPredIntraAng)
        d26 = (rl[:, 1:s + 1] - rl[:, 0:1]) >> 1
        col = (ang[:, :, 0] + d26).clamp(0, max_val)
        ang[:, :, 0] = torch.where((mode == 26)[:, None], col, ang[:, :, 0])
        d10 = (ra[:, 1:s + 1] - ra[:, 0:1]) >> 1
        row = (ang[:, 0, :] + d10).clamp(0, max_val)
        ang[:, 0, :] = torch.where((mode == 10)[:, None], row, ang[:, 0, :])

    # planar (filtered refs when the size filter applies, luma only)
    filt_pl = luma and (min(abs(PLANAR_IDX - HOR_IDX),
                            abs(PLANAR_IDX - VER_IDX))
                        > INTRA_FILTER_THRESH[log2])
    pl = _predict_mode(ra_f if filt_pl else ra, rl_f if filt_pl else rl, s,
                       PLANAR_IDX, max_val)
    dc = _predict_mode(ra, rl, s, DC_IDX, max_val, luma)
    return torch.where((mode == PLANAR_IDX)[:, None, None], pl,
                       torch.where((mode == DC_IDX)[:, None, None], dc, ang))


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 ulps of the larger magnitude, as float64; inf
    where a == b (an exact tie of two costs that one expression computes
    from equal operands, which every backend ties alike)."""
    e = torch.frexp(torch.maximum(a.abs(), b.abs()))[1].to(torch.float64)
    gap = (a.to(torch.float64) - b.to(torch.float64)).abs() \
        / torch.pow(2.0, e - 24)
    return torch.where(gap == 0, np.inf, gap)


def _rdoq_batch(co, lam: float, qp: int, size: int, scan_sel, trd,
                luma: bool, ebt: dict, bit_inc: int, with_gaps: bool = False):
    """Vectorised RDOQ over a TU batch -- xRateDistOptQuant
    (TComTrQuant.cpp:1719) with the sequential per-coefficient context
    chain (c1/c2/goRice/ctxSet) replaced by closed-form proxies computed
    from the pre-quant levels, and estBits frozen at slice-init states
    (``ebt``, from ``est_bits_tensors``).  Level choice, CG zero-out and
    the best-last-position scan follow the reference cost model, line
    for line (``thevc_tpu/encoder/fast_apply.py:370-639``).

    co [N, s, s] int32 signed coefficients; lam a float32 value; qp the
    scaled QP; scan_sel [N] in {0, 1, 2}; trd [N] the cbf-context
    transform depth.  Returns (levels [N, s, s] signed, delta_u [N, s, s]),
    int32; ``with_gaps`` adds, per TU, the smallest distance in float32
    ulps between the two costs of any decision it made (level choice,
    CG zero-out, last position), float64 [N]: the tests read it to show
    that a TU whose levels differ from XLA's is a near tie."""
    f32 = torch.float32
    dev = co.device
    nb = co.shape[0]
    p = size * size
    ncg = p // 16
    log2 = size.bit_length() - 1
    big = 3e38
    scan_t, inv_t, rgt_t, low_t = _scan_tensors(size, luma, dev)

    per, rem = qp // 6, qp % 6
    uiq = int(rom.QUANT_SCALES[rem])
    ts = 15 - (8 + bit_inc) - log2
    qbits = 14 + per + ts
    # the reference's float32 order: ((2^15 * 2^-2ts) / Q) / Q / 2^2bi
    err_scale = float(np.float32(1 << 15) * np.float32(2.0 ** (-2 * ts))
                      / np.float32(uiq) / np.float32(uiq)
                      / np.float32(1 << (2 * bit_inc)))
    lam = float(np.float32(lam))

    pos = scan_t[scan_sel]                              # [N, P] raster pos
    sflat = co.reshape(nb, p).gather(1, pos)
    a_s = sflat.abs()
    sgn = torch.where(sflat < 0, -1, 1)
    ld = a_s * uiq
    maxab = (ld + (1 << (qbits - 1))) >> qbits

    p_idx = torch.arange(p, device=dev)[None, :]
    last = torch.where(maxab > 0, p_idx, -1).amax(dim=1)        # [N]
    has_any = last >= 0
    cg_of_last = last.clamp(min=0) // 16
    in_coded = p_idx <= last[:, None]
    is_last = p_idx == last[:, None]

    # ---- proxy context chain (within-CG reversed cumulative counts) ----
    def above(x):
        x3 = x.reshape(nb, ncg, 16).to(torch.int32)
        inc = x3.flip(-1).cumsum(-1, dtype=torch.int32).flip(-1)
        return (inc - x3).reshape(nb, p)

    def per_pos(g):
        return g[:, :, None].expand(nb, ncg, 16).reshape(nb, p)

    ge1 = maxab >= 1
    ge2 = maxab >= 2
    n1 = above(ge1)
    n2 = above(ge2)
    n3 = above(maxab > 3)
    c1_idx = n1.clamp(max=8)
    c2_idx = n2.clamp(max=1)
    c1 = torch.where(n2 > 0, 0, (1 + (n1 - n2)).clamp(max=3))
    rice = n3.clamp(max=4)

    g_idx = torch.arange(ncg, device=dev)[None, :]
    no_cg = torch.zeros((nb, 1), dtype=torch.bool, device=dev)
    cg_ge2 = ge2.reshape(nb, ncg, 16).any(dim=2)
    prev_ge2 = torch.cat([cg_ge2[:, 1:], no_cg], dim=1)
    prev_valid = (g_idx + 1) <= cg_of_last[:, None]
    ctx_set = ((2 if luma else 0) * (g_idx > 0).to(torch.int32)
               + (prev_ge2 & prev_valid).to(torch.int32))   # [N, ncg]
    ctx_set_p = per_pos(ctx_set)
    ctx_one = 4 * ctx_set_p + c1
    ctx_abs = ctx_set_p + n2.clamp(max=2)

    # significance context from the neighbour-CG pattern proxy
    cg_has = ge1.reshape(nb, ncg, 16).any(dim=2)
    cg_has_pad = torch.cat([cg_has, no_cg], dim=1)
    r_sig = cg_has_pad.gather(1, rgt_t[scan_sel])
    l_sig = cg_has_pad.gather(1, low_t[scan_sel])
    patt_p = per_pos(r_sig.to(torch.int64) + 2 * l_sig.to(torch.int64))
    sel_scan = scan_sel[:, None]
    sig0 = ebt["sig0p"][sel_scan, patt_p, p_idx]
    sig1 = ebt["sig1p"][sel_scan, patt_p, p_idx]

    # ---- level decision (xGetCodedLevel + xGetICRateCost) ----
    base_level = torch.where(c1_idx < 8, 2 + (c2_idx < 1).to(torch.int32), 1)
    one0 = ebt["one0"][ctx_one.long()]
    one1 = ebt["one1"][ctx_one.long()]
    abs0 = ebt["abs0"][ctx_abs.long()]
    abs1 = ebt["abs1"][ctx_abs.long()]
    zero = torch.zeros((), dtype=f32, device=dev)

    def ic_rate(lv):
        sym = lv - base_level
        three_rice = _shl(3, rice)
        small = sym < three_rice
        r_small = (((sym >> rice) + 1 + rice) << 15).to(f32)
        t = (sym - three_rice).clamp(min=0) + _shl(1, rice)
        ln = _bitlen(t) - 1
        r_big = ((3 + ln + 1 - rice + ln) << 15).to(f32)
        r_ge = (torch.where(small, r_small, r_big)
                + torch.where(c1_idx < 8,
                              one1 + torch.where(c2_idx < 1, abs1, zero),
                              zero))
        rate = torch.where(lv >= base_level, r_ge,
                           torch.where(lv == 1, one0,
                                       torch.where(lv == 2, one1 + abs0,
                                                   zero)))
        return rate + float(1 << 15)        # sign bit (IEP_RATE)

    ldf = ld.to(f32)
    cost0 = ldf * ldf * err_scale
    lam_sig0 = lam * sig0
    lam_sig1 = lam * sig1
    sig_term = torch.where(is_last, zero, lam_sig1)

    def lvl_cost(lv):
        err = (ld - (lv << qbits)).to(f32)
        return err * err * err_scale + lam * ic_rate(lv) + sig_term

    m = maxab
    cm = torch.where(m >= 1, lvl_cost(m), big)
    cm1 = torch.where(m >= 2, lvl_cost((m - 1).clamp(min=1)), big)
    czero = torch.where((m < 3) & ~is_last, cost0 + lam_sig0, big)
    # HM order: zero baseline, then m (strict <), then m-1 (strict <)
    lvl = torch.zeros_like(m)
    best = czero
    lvl = torch.where(cm < best, m, lvl)
    gaps = [torch.where(in_coded & (cm < big) & (czero < big),
                        _ulp_gap(cm, czero), np.inf)] if with_gaps else []
    best = torch.minimum(best, cm)
    lvl = torch.where(cm1 < best, m - 1, lvl)
    if with_gaps:
        gaps.append(torch.where(in_coded & (cm1 < big) & (best < big),
                                _ulp_gap(cm1, best), np.inf))
    best = torch.minimum(best, cm1)
    # outside the coded region: uncoded
    lvl = torch.where(in_coded, lvl, 0)
    cost_coeff = torch.where(in_coded, best, cost0)
    cost_sig = torch.where(
        in_coded,
        torch.where(is_last, zero,
                    torch.where(lvl > 0, lam_sig1, lam_sig0)),
        zero)

    # ---- CG zero-out (sigCoeffGroupFlag RD) ----
    lvl3 = lvl.reshape(nb, ncg, 16)
    cc3 = cost_coeff.reshape(nb, ncg, 16)
    cs3 = cost_sig.reshape(nb, ncg, 16)
    c03 = cost0.reshape(nb, ncg, 16)
    nz3 = lvl3 > 0
    dec_sig = nz3.any(dim=2)
    sum_sig = _tree_sum(cs3)
    coded_ld = _tree_sum(torch.where(nz3, cc3 - cs3, zero))
    unc_nz = _tree_sum(torch.where(nz3, c03, zero))
    nnz_b4 = nz3[:, :, 1:].sum(dim=2)
    sig_pos0 = cs3[:, :, 0]

    cg_in = g_idx <= cg_of_last[:, None]
    is_lastcg = g_idx == cg_of_last[:, None]
    is_cg0 = g_idx == 0
    eligible = cg_in & ~is_lastcg & ~is_cg0 & dec_sig
    adj = eligible & (nnz_b4 == 0)
    sum_sig_adj = torch.where(adj, sum_sig - sig_pos0, sum_sig)

    # sigCG context from the decided-neighbour proxy
    dec_pad = torch.cat([dec_sig, no_cg], dim=1)
    cg_ctx = dec_pad.gather(1, rgt_t[scan_sel]) \
        | dec_pad.gather(1, low_t[scan_sel])
    cgb = ebt["cg"]
    cg0b = torch.where(cg_ctx, float(cgb[1][0]), float(cgb[0][0]))
    cg1b = torch.where(cg_ctx, float(cgb[1][1]), float(cgb[0][1]))
    lam_cg0 = lam * cg0b
    lam_cg1 = lam * cg1b

    zero_cost = lam_cg0 + unc_nz - coded_ld - sum_sig_adj
    zeroed = eligible & (zero_cost < lam_cg1)
    if with_gaps:
        gaps.append(torch.where(eligible, _ulp_gap(zero_cost, lam_cg1),
                                np.inf))
    empty = cg_in & ~is_lastcg & ~is_cg0 & ~dec_sig
    drop = zeroed | empty
    lvl3 = torch.where(drop[:, :, None], 0, lvl3)
    cc3 = torch.where(drop[:, :, None], c03, cc3)
    cs3 = torch.where(drop[:, :, None], zero, cs3)
    cost_cg_sig = torch.where(drop, lam_cg0,
                              torch.where(eligible & ~zeroed, lam_cg1, zero))
    cost_cg_sig = torch.where(cg_in, cost_cg_sig, zero)

    lvl = lvl3.reshape(nb, p)
    cost_coeff = cc3.reshape(nb, p)
    cost_sig = cs3.reshape(nb, p)

    # ---- best last position (TComTrQuant.cpp:2096-2177) ----
    cbf_ctx = torch.where(trd == 0, 1, 0) if luma else 5 + trd
    cbf0 = ebt["cbf0"][cbf_ctx.long()]
    cbf1 = ebt["cbf1"][cbf_ctx.long()]
    base_final = (_tree_sum(cost_coeff)
                  - _tree_sum(torch.where(adj, sig_pos0, zero))
                  + _tree_sum(cost_cg_sig) + lam * cbf1)
    best0 = _tree_sum(cost0) + lam * cbf0

    nzp = lvl > 0
    d = torch.where(in_coded, torch.where(nzp, cost_coeff - cost0, cost_sig),
                    zero)
    suf_d = _suffix_sum(d) - d                         # exclusive
    suf_cg = per_pos(_suffix_sum(cost_cg_sig))         # inclusive
    rate_last = ebt["rlv"][scan_sel]
    total = (base_final[:, None] - suf_cg - suf_d + lam * rate_last
             - cost_sig)
    gt1_pos = torch.where(lvl > 1, p_idx, 0).amax(dim=1)
    cand = nzp & in_coded & (p_idx >= gt1_pos[:, None])
    total = torch.where(cand, total, big)
    tmin = total.amin(dim=1)
    # tie-break toward the LARGER scan position (walk order)
    pick = torch.where(total == tmin[:, None], p_idx, -1).amax(dim=1)
    keep_any = (tmin < best0) & has_any
    if with_gaps:
        second = torch.where(p_idx == pick[:, None], big, total).amin(dim=1)
        gaps += [torch.where(has_any, _ulp_gap(tmin, best0), np.inf)[:, None],
                 torch.where(second < big, _ulp_gap(second, tmin),
                             np.inf)[:, None]]
    last_p1 = torch.where(keep_any, pick + 1, 0)
    lvl = torch.where(p_idx < last_p1[:, None], lvl, 0)

    du = torch.where(in_coded, (ld - (lvl << qbits)) >> (qbits - 8), 0)
    inv = inv_t[scan_sel]
    out = (lvl * sgn).gather(1, inv)
    duo = du.gather(1, inv)
    out = (out.reshape(nb, size, size).to(torch.int32),
           duo.reshape(nb, size, size).to(torch.int32))
    if with_gaps:
        out += (torch.cat([g.reshape(nb, -1) for g in gaps], dim=1)
                .amin(dim=1),)
    return out


def _sbh_batch(levels, src, du, scan_sel, size: int):
    """Vectorised signBitHidingHDQ (mirror of codec_core.cpp sbh_hdq_c /
    TComTrQuant.cpp:977) over a TU batch.

    levels/src/du [N, s, s] raster; scan_sel [N] in {0, 1, 2} selecting
    the scan table.  Returns the adjusted levels."""
    # costs are |delta_u| < 2^8 (quant remainder >> (qbits-8)); the
    # sentinel must survive the *16 tie-break key in int32
    inf = 1 << 26
    dev = levels.device
    nb = levels.shape[0]
    p = size * size
    ncg = p // 16
    scan_t, inv_t = _scan_tensors(size, True, dev)[:2]
    pos = scan_t[scan_sel]                            # [N, p]
    lv = levels.reshape(nb, p).gather(1, pos).reshape(nb, ncg, 16)
    sr = src.reshape(nb, p).gather(1, pos).reshape(nb, ncg, 16)
    dd = du.reshape(nb, p).gather(1, pos).reshape(nb, ncg, 16).to(
        torch.int32)

    nz = lv != 0
    any_nz = nz.any(dim=2)                            # [N, ncg]
    n_idx = torch.arange(16, dtype=torch.int32, device=dev)
    first_nz = torch.where(nz, n_idx, 99).amin(dim=2)
    last_nz = torch.where(nz, n_idx, -1).amax(dim=2)
    g_idx = torch.arange(ncg, dtype=torch.int32, device=dev)
    last_cg = torch.where(any_nz, g_idx, -1).amax(dim=1)     # [N]
    start_n = torch.where(g_idx[None, :] == last_cg[:, None], last_nz, 15)

    n3 = n_idx[None, None]
    csum = torch.where((n3 >= first_nz[..., None])
                       & (n3 <= last_nz[..., None]), lv, 0).sum(dim=2)
    fsel = first_nz.clamp(max=15)[..., None] == n3
    lv_first = torch.where(fsel, lv, 0).sum(dim=2)
    signbit = torch.where(lv_first > 0, 0, 1)
    need = (last_nz - first_nz >= 4) & (signbit != (csum & 1))

    # per-position candidate cost + change (sbh_hdq_c rules)
    is_first = n3 == first_nz[..., None]
    abs1 = lv.abs() == 1
    cost_nzpos = torch.where(dd > 0, -dd,
                             torch.where(is_first & abs1, inf, dd))
    chg_nzpos = torch.where(dd > 0, 1,
                            torch.where(is_first & abs1, 0, -1))
    before_first = n3 < first_nz[..., None]
    sign_src = torch.where(sr >= 0, 0, 1)
    bad_sign = before_first & (sign_src != signbit[..., None])
    cost_zpos = torch.where(bad_sign, inf, -dd)
    chg_zpos = torch.where(bad_sign, 0, 1)
    cost = torch.where(lv != 0, cost_nzpos, cost_zpos)
    chg = torch.where(lv != 0, chg_nzpos, chg_zpos)
    cost = torch.where(n3 > start_n[..., None], inf, cost)
    # tie-break: the C scan runs n from start_n DOWN to 0 with a strict
    # compare, keeping the LARGEST n among equal costs (the keys are
    # distinct, so argmin has no tie to break)
    key = cost * 16 + (15 - n3)
    sel = key.argmin(dim=2)                           # [N, ncg]
    ssel = sel[..., None] == n3
    sel_chg = torch.where(ssel, chg, 0).sum(dim=2)
    sel_q = torch.where(ssel, lv, 0).sum(dim=2)
    sel_src = torch.where(ssel, sr, 0).sum(dim=2)
    sel_chg = torch.where((sel_q == 32767) | (sel_q == -32768), -1, sel_chg)
    delta = torch.where(sel_src >= 0, sel_chg, -sel_chg)
    delta = torch.where(need, delta, 0)
    lv = lv + torch.where(ssel, delta[..., None], 0)
    out = lv.reshape(nb, p).gather(1, inv_t[scan_sel])
    return out.reshape(nb, size, size).to(levels.dtype)


def _class_step_plain(rec, lv, org_wins, flat, idx, qp: int, qp_vec,
                      ci: int, lam: float, ebt, bit_inc: int, max_val: int,
                      sign_hide: bool, use_rdoq: bool) -> None:
    """One wave step of one size class and plane, in place, for the window
    records ``idx`` ([cap] int64, a device tensor): gather the reference
    lines out of the evolving recon plane ``rec`` (int16 [H, W], one row
    and column of top/left padding), predict, transform, quantise (RDOQ
    or plain) + SBH, reconstruct through ``tq.residual_pipeline``, scatter
    the recon blocks into ``rec`` (TU regions are disjoint by
    construction; padding records land in the guard) and the levels into
    the per-record stack ``lv``.  ``qp`` is the scaled QP and ``qp_vec``
    it for each window record.  Queues device work only: no host sync."""
    size, luma, use_dst = CLS[ci]
    s = size
    unit = 4 if luma else 2
    length = 4 * s + unit
    dev = rec.device
    hgt, wid = rec.shape
    xs, ys, lo, hi, mode, scan = flat
    x0, y0 = xs[idx], ys[idx]
    lo_, hi_ = lo[idx], hi[idx]
    md, sc = mode[idx], scan[idx]
    owin = org_wins[idx].to(torch.int32)

    # the reference line, raw: the corner and left column, the top row
    plane = rec.view(-1)
    j = torch.arange(2 * s + 1, device=dev)
    col_at = (y0[:, None] + j).clamp(max=hgt - 1) * wid \
        + x0.clamp(max=wid - 1)[:, None]
    colw = plane[col_at].to(torch.int32)              # [N, 2s+1]
    top_at = y0.clamp(max=hgt - 1)[:, None] * wid \
        + (x0[:, None] + 1 + j[:2 * s]).clamp(max=wid - 1)
    topw = plane[top_at].to(torch.int32)              # [N, 2s]
    line = torch.cat([colw[:, 1:].flip(1),
                      colw[:, 0:1].expand(-1, unit), topw], dim=1)
    # HM's unavailable-sample substitution over a contiguous range is
    # boundary replication: samples below lo take line[lo], above hi
    # line[hi]; nothing available takes the DC fill
    i = torch.arange(length, device=dev)[None, :]
    v_lo = line.gather(1, lo_[:, None])
    v_hi = line.gather(1, hi_[:, None])
    line = torch.where(i < lo_[:, None], v_lo, line)
    line = torch.where(i > hi_[:, None], v_hi, line)
    line = torch.where((lo_ > hi_)[:, None], 1 << (7 + bit_inc), line)
    corner = line[:, 2 * s:2 * s + 1]
    ra = torch.cat([corner, line[:, 2 * s + unit:]], dim=1)
    rl = torch.cat([corner, line[:, :2 * s].flip(1)], dim=1)

    pred = _predict_batch(ra, rl, s, luma, md, max_val)
    co = tq.forward_transform(owin - pred, use_dst, bit_inc)
    scan_sel = ((sc & 3) - 1).clamp(0, 2)
    if use_rdoq:
        levels, du = _rdoq_batch(co, lam, qp, s, scan_sel,
                                 sc >> 2, luma, ebt, bit_inc)
    else:
        levels, du = tq.quant(co, qp_vec, True, bit_inc)
    if sign_hide:
        levels = _sbh_batch(levels, co, du, scan_sel, s)
    rres = tq.residual_pipeline(levels.clamp(-32768, 32767).to(torch.int16),
                                qp_vec, use_dst, bit_inc)
    recb = (pred + rres.to(torch.int32)).clamp(0, max_val)

    dy = torch.arange(s, device=dev)
    at = (y0[:, None, None] + 1 + dy[None, :, None]) * wid \
        + (x0[:, None, None] + 1 + dy[None, None, :])
    plane.index_put_((at.reshape(-1),), recb.reshape(-1).to(rec.dtype))
    lv.index_copy_(0, idx, levels.to(lv.dtype))


class ClassStep:
    """One size class's wave step of a frame in the plain form: the class
    ``ci``, its planes (rec, lv, wins, scaled qp, qp for each window
    record, lambda; Cb then Cr for a chroma class), the records on the
    device (``flat``: six int64 fields), the window starts of the waves it
    runs (``starts``), the device counter of the next one (``k``, so that
    a captured step replays wave after wave), the window's rows ([cap]
    int64), the RDOQ bit tables (``ebt``, None without RDOQ) and the
    frame's statics."""
    __slots__ = ("ci", "planes", "flat", "starts", "k", "rows", "ebt",
                 "bit_inc", "max_val", "sign_hide", "use_rdoq")

    def __init__(self, ci, planes, flat, starts, rows, ebt, bit_inc,
                 max_val, sign_hide, use_rdoq):
        device = planes[0][0].device
        self.ci, self.planes, self.flat = ci, planes, flat
        self.starts, self.rows, self.ebt = starts, rows, ebt
        self.k = torch.zeros(1, dtype=torch.int64, device=device)
        self.bit_inc, self.max_val = bit_inc, max_val
        self.sign_hide, self.use_rdoq = sign_hide, use_rdoq


def _step_plain(st: ClassStep) -> None:
    """The plain form of a class step on any device: ``_class_step_plain``
    for each plane, then the counter advanced."""
    idx = st.starts.index_select(0, st.k) + st.rows
    for rec, lv, wins, qp, qp_vec, lam in st.planes:
        _class_step_plain(rec, lv, wins, st.flat, idx, qp, qp_vec, st.ci, lam,
                          st.ebt, st.bit_inc, st.max_val, st.sign_hide,
                          st.use_rdoq)
    st.k.add_(1)


# ---------------------------------------------------------------------------
# the frame's item list and the wait rule (the frame kernel's host side)
# ---------------------------------------------------------------------------

def level_layout(sched: Schedule) -> tuple:
    """The flat level buffer of a frame: ({(class, plane): (element offset,
    rows)}, total elements); the luma and Cb stacks in class order, then
    the Cr stacks of the chroma classes (``collect_device_apply``'s
    order), each stack the class's flat records, padding included."""
    order = [(ci, 0 if luma else 1) for ci, (_s, luma, _) in enumerate(CLS)] \
        + [(ci, 2) for ci, (_s, luma, _) in enumerate(CLS) if not luma]
    out, at = {}, 0
    for ci, plane in order:
        n = len(sched.flat[ci][0])
        out[ci, plane] = (at, n)
        at += n * CLS[ci][0] ** 2
    return out, at


def _planes_of(luma: bool) -> tuple:
    return (0,) if luma else (1, 2)


def frame_items(sched: Schedule, layout: dict) -> np.ndarray:
    """The frame kernel's item list (int32 [n, 8], ``apply_kernel.
    ITEM_FIELDS``): for each wave in order, each class with records in it
    in class order, its real rows in that wave, one item a row on a luma
    plane and one a row and plane on Cb then Cr; then, per class that
    runs, the padding rows that the plain form's windows compute, rows
    ``[counts, offs[last active wave] + cap)``.  ``layout`` is
    ``level_layout``'s."""
    fields, keys = [], []
    pads = []
    for ci, (s, luma, _) in enumerate(CLS):
        n = sched.counts[ci]
        offs = np.asarray(sched.offs[ci])
        active = np.nonzero(np.diff(offs))[0]
        if not active.size:
            continue
        flat = np.stack(sched.flat[ci], axis=1).astype(np.int32)
        wave = np.repeat(np.arange(sched.n_waves), np.diff(offs))
        pad = np.arange(n, int(offs[active[-1]]) + sched.caps[ci])
        for plane in _planes_of(luma):
            off = layout[ci, plane][0]
            for rows, real, sink in ((np.arange(n), 1, fields),
                                     (pad, 0, pads)):
                item = np.empty((len(rows), 8), np.int32)
                item[:, :6] = flat[rows]
                item[:, 6] = apply_kernel.kind(ci, plane, real)
                item[:, 7] = off + rows * s * s
                sink.append(item)
                if real:
                    keys.append(np.stack([wave, np.full(n, ci),
                                          np.full(n, plane), rows]))
    if not fields:
        return np.zeros((0, 8), np.int32)
    real = np.concatenate(fields)
    key = np.concatenate(keys, axis=1)
    order = np.lexsort(key[::-1])
    return np.ascontiguousarray(np.concatenate([real[order], *pads]))


def wait_units(xs, ys, lo, hi, size: int, luma: bool) -> tuple:
    """The wait rule, as the frame kernel applies it: the units (4x4 luma
    or 2x2 chroma, in the luma 4x4 grid) under each record's available
    range ``[lo, hi]`` of its reference line (the left column bottom-up,
    the corner, the top row; unit ``g`` of the line covers samples ``[g *
    unit, (g + 1) * unit)``).  Returns (ux, uy, under), [n, 4 s / unit +
    1] each; ``under`` False past the range, or everywhere for an empty
    one (lo > hi)."""
    unit = 4 if luma else 2
    nu = size // unit
    g = np.arange(4 * nu + 1)[None, :]
    gx = (np.asarray(xs) // unit)[:, None]
    gy = (np.asarray(ys) // unit)[:, None]
    lo, hi = np.asarray(lo)[:, None], np.asarray(hi)[:, None]
    ux = np.where(g <= 2 * nu, gx - 1, gx + g - 2 * nu - 1)
    uy = np.where(g < 2 * nu, gy + 2 * nu - 1 - g, gy - 1)
    under = (g >= lo // unit) & (g <= hi // unit) & (lo <= hi)
    return ux, uy, under


def own_units(xs, ys, size: int, luma: bool) -> tuple:
    """The units each record writes (the writer's side of the wait rule):
    (ux, uy), [n, (s / unit)^2] each."""
    unit = 4 if luma else 2
    nu = size // unit
    k = np.arange(nu * nu)[None, :]
    return ((np.asarray(xs) // unit)[:, None] + k % nu,
            (np.asarray(ys) // unit)[:, None] + k // nu)


def apply_items_plain(items: np.ndarray, recs, orgs, lv, ready, qps, lams,
                      ebts, bit_inc: int, max_val: int,
                      sign_hide: bool) -> None:
    """The plain version of the frame kernel, in place on any device: each
    item of ``items`` in list order through ``_class_step_plain`` as a
    record of its own (its source block cut from its plane of ``orgs``,
    zeros for a padding row), its levels into its row of ``lv``, its own
    units flagged in ``ready``.  The list order must let every item's
    writers come before it (``wait_units``); the kernel runs the same list
    in any order that rule allows."""
    dev = recs[0].device
    idx = torch.zeros(1, dtype=torch.int64, device=dev)
    for x, y, lo, hi, mode, scan, knd, off in items.tolist():
        ci, plane, real = knd & 15, (knd >> 4) & 3, (knd >> 6) & 1
        s, luma, _ = CLS[ci]
        flat = tuple(torch.tensor([v], dtype=torch.int64, device=dev)
                     for v in (x, y, lo, hi, mode, scan))
        win = (orgs[plane][y:y + s, x:x + s].reshape(1, s, s) if real
               else torch.zeros((1, s, s), dtype=torch.int16, device=dev))
        qp = int(qps[plane])
        _class_step_plain(recs[plane], lv[off:off + s * s].view(1, s, s),
                          win, flat, idx, qp,
                          torch.full((1,), qp, dtype=torch.int32, device=dev),
                          ci, lams[plane], None if ebts is None else ebts[ci],
                          bit_inc, max_val, sign_hide, ebts is not None)
        if real:
            unit = 4 if luma else 2
            ready[plane, y // unit:(y + s) // unit,
                  x // unit:(x + s) // unit] = 1


def apply_items(items, recs, orgs, lv, ready, state, qps, lams, ebts,
                bit_inc: int, max_val: int, sign_hide: bool,
                classes=None) -> None:
    """Apply a frame's item list (``frame_items``) in place: on a CUDA
    device one launch of the frame kernel (``ops.apply_kernel.
    apply_frame``; raises if it cannot build or launch), on the CPU the
    plain version (``apply_items_plain``; ``state`` unused); any other
    device raises ``ValueError``.  ``items`` is a host array (checked and
    uploaded by the binding) or, on ``cuda``, a tensor on the card that
    ``apply_kernel.check_items`` passed, with the ``classes`` it holds.
    ``recs`` and ``orgs`` are the Y, Cb and Cr recon (with the guard) and
    source planes, ``lv`` the flat level buffer, ``ready`` the ready maps
    [3, map_h, map_w] (an item waits for the flags of the units under its
    range), ``ebts`` {class: estBits} with RDOQ, else None.  Queues device
    work only: no host sync."""
    device = recs[0].device
    if device.type == "cpu":
        apply_items_plain(np.asarray(items), recs, orgs, lv, ready, qps,
                          lams, ebts, bit_inc, max_val, sign_hide)
        return
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if classes is None:
        classes = np.unique(items[:, 6] & 15).tolist() if len(items) else []
    tables = {ci: kernel_tables(ci, device) for ci in classes
              if 0 <= ci < len(CLS)}
    apply_kernel.apply_frame(
        items, recs, orgs, lv, ready, state, tables,
        None if ebts is None else {ci: ebts[ci] for ci in tables}, qps, lams,
        bit_inc, max_val, sign_hide)


# ---------------------------------------------------------------------------
# the frame: upload, apply, fetch
# ---------------------------------------------------------------------------

class ApplyRun:
    """One frame's queued apply (``run_device_apply``): the flat int16
    device buffer that ``collect_device_apply`` copies back (recon planes,
    then the level stacks), how to split it, the wave count, the class
    steps of the schedule (a chroma class step covers Cb and Cr; the
    plain form's launches of a step), the kernel form's items (``n_items``,
    0 in the plain form) and its state words (``state``: ticket, error,
    items that waited), the host's seconds to upload (and in the plain
    form capture) before the first launch (``setup_s``) and to issue the
    launches (``issue_s``; it waits for the device only when the launch
    queue is full), and on a CUDA device two timing events around the
    launches (``loop_events``; the device's span of the apply is their
    elapsed time once the run is collected).  It holds the plain form's
    CUDA graphs (and so their memory) until the collect has waited for
    them."""
    __slots__ = ("flat", "shapes", "n_waves", "class_steps", "n_items",
                 "state", "setup_s", "issue_s", "loop_events", "graphs")


# one apply at a time: the plain form captures CUDA graphs, and the
# frame-parallel all-intra encoder runs frames in threads
_apply_lock = threading.Lock()


def _capture(step, stream) -> tuple:
    """Warm ``step`` up on ``stream`` (tables, library handles), then
    capture it as a CUDA graph there.  Returns the graph and the residual
    kernel's launches it holds, counted per replay (the capture itself
    launches nothing)."""
    with torch.cuda.stream(stream):
        step()
    graph = torch.cuda.CUDAGraph()
    before = residual_kernel.captured
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()
    return graph, residual_kernel.captured - before


def run_device_apply(org_y, org_cb, org_cr, sched: Schedule, width, height,
                     qp_y, qp_cb, qp_cr, ctu_size, bit_inc, max_val,
                     sign_hide, use_rdoq=False, lam_y=1.0, lam_c=1.0,
                     init_ctx=None, *, device, replay=None,
                     plain=False) -> ApplyRun:
    """Queue the apply of one frame on ``device`` and return its
    ``ApplyRun`` for ``collect_device_apply``.  On a CUDA device it is one
    launch of the frame kernel (``apply_items`` on ``frame_items``).  On the
    CPU, or with ``plain`` (use ``run_device_apply_plain``) on any device,
    it is the plain form: the class steps wave by wave (``_step_plain``),
    each captured as a CUDA graph and replayed per wave with ``replay``
    (default: on a CUDA device); the kernel form refuses ``replay``.  The
    arguments after the schedule are the reference's: frame size, scaled
    QPs, CTU size, bit increment, largest sample value, sign hiding, RDOQ
    with its float32 lambdas and slice-init context states."""
    t0 = time.perf_counter()
    device = torch.device(device)
    if replay is None:
        replay = plain and device.type == "cuda"
    if replay and device.type != "cuda":
        raise ValueError(f"CUDA graph replay needs a CUDA device, not "
                         f"{device}")
    kernel = device.type == "cuda" and not plain
    if replay and kernel:
        raise ValueError("the kernel form is one launch a frame: only the "
                         "plain form replays CUDA graphs")
    if use_rdoq and init_ctx is None:
        raise ValueError("RDOQ needs the slice-init context states")
    wp = -(-width // ctu_size) * ctu_size
    hp = -(-height // ctu_size) * ctu_size
    orgs_np = [np.asarray(o, np.int16) for o in (org_y, org_cb, org_cr)]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # one zeroed int16 buffer: the recon planes (with the guard), then the
    # level stacks
    layout, n_lv = level_layout(sched)
    rec_shapes = [(hp + 1 + GUARD, wp + 1 + GUARD)] \
        + [(hp // 2 + 1 + GUARD, wp // 2 + 1 + GUARD)] * 2
    sizes = [h * w for h, w in rec_shapes]
    buf = torch.zeros(sum(sizes) + n_lv, dtype=torch.int16, device=device)
    recs = [t.view(shape) for t, shape in zip(buf[:sum(sizes)].split(sizes),
                                               rec_shapes)]
    lv = buf[sum(sizes):]

    def stack(ci, plane):
        off, n = layout[ci, plane]
        s = CLS[ci][0]
        return lv[off:off + n * s * s].view(n, s, s)
    lvs = [stack(ci, 0 if luma else 1) for ci, (_s, luma, _) in enumerate(CLS)]
    lvs_cr = [None if luma else stack(ci, 2)
              for ci, (_s, luma, _) in enumerate(CLS)]
    active = [np.nonzero(np.diff(o))[0] for o in sched.offs]
    qps, lams = (qp_y, qp_cb, qp_cr), (lam_y, lam_c, lam_c)
    ebts = ({ci: est_bits_tensors(init_ctx, s, luma, device)
             for ci, (s, luma, _) in enumerate(CLS) if active[ci].size}
            if use_rdoq else None)
    run = ApplyRun()
    run.class_steps = int(sum(a.size for a in active))
    run.n_items, run.state, graphs, per_replay = 0, None, {}, {}
    if kernel:
        # the item list, checked on the host and uploaded with the source
        # planes before the launch
        items = frame_items(sched, layout)
        uh, uw = hp // 4, wp // 4
        classes = [ci for ci in range(len(CLS)) if active[ci].size]
        apply_kernel.check_items(items, [o.shape for o in orgs_np], (uh, uw),
                                 n_lv, classes)
        flat_up = up(np.concatenate([items.view(np.int16).reshape(-1)]
                                    + [o.reshape(-1) for o in orgs_np]))
        parts = flat_up.split([items.size * 2] + [o.size for o in orgs_np])
        items_d = parts[0].view(torch.int32).view(items.shape)
        orgs = [t.view(o.shape) for t, o in zip(parts[1:], orgs_np)]
        ints = torch.zeros(3 * uh * uw + apply_kernel.STATE_WORDS,
                           dtype=torch.int32, device=device)
        ready = ints[:3 * uh * uw].view(3, uh, uw)
        run.state = ints[3 * uh * uw:]
        run.n_items = len(items)
        launch = [functools.partial(
            apply_items, items_d, recs, orgs, lv, ready, run.state, qps, lams,
            ebts, bit_inc, max_val, sign_hide, classes)]
    else:
        steps = {}
        for ci, (s, luma, _) in enumerate(CLS):
            if not active[ci].size:
                continue
            cap = sched.caps[ci]
            flat = tuple(up(a.astype(np.int64)) for a in sched.flat[ci])
            starts = up(sched.offs[ci][active[ci]].astype(np.int64))
            rows = torch.arange(cap, device=device)
            planes = []
            for plane in _planes_of(luma):
                # the records' source windows, cut host-side (padding rows
                # zero)
                xs, ys = sched.flat[ci][0], sched.flat[ci][1]
                n_c = sched.counts[ci]
                wins = np.zeros((len(xs), s, s), np.int16)
                if n_c:
                    dy = np.arange(s)
                    wins[:n_c] = orgs_np[plane][
                        ys[:n_c, None, None] + dy[None, :, None],
                        xs[:n_c, None, None] + dy[None, None, :]]
                planes.append((recs[plane], stack(ci, plane), up(wins),
                               qps[plane], torch.full(
                                   (cap,), qps[plane], dtype=torch.int32,
                                   device=device), lams[plane]))
            st = ClassStep(ci, planes, flat, starts, rows,
                           None if ebts is None else ebts[ci], bit_inc,
                           max_val, sign_hide, use_rdoq)
            steps[ci] = (functools.partial(_step_plain, st), st.k)
        if replay:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            for ci, (step, _k) in steps.items():
                graphs[ci], per_replay[ci] = _capture(step, side)
            # the warm-up steps wrote the state: start it afresh
            torch.cuda.current_stream(device).wait_stream(side)
            buf.zero_()
            for _step, k in steps.values():
                k.zero_()
            run_step = {ci: g.replay for ci, g in graphs.items()}
        else:
            run_step = {ci: step for ci, (step, _k) in steps.items()}
        launch = [run_step[ci] for w in range(sched.n_waves)
                  for ci in run_step if sched.offs[ci][w + 1]
                  > sched.offs[ci][w]]

    loop_events = None
    if device.type == "cuda":
        loop_events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        loop_events[0].record()
    t1 = time.perf_counter()
    for fn in launch:
        fn()
    residual_kernel.replayed(sum(n * active[ci].size
                                 for ci, n in per_replay.items()))
    t2 = time.perf_counter()
    if loop_events is not None:
        loop_events[1].record()

    run.setup_s, run.issue_s = t1 - t0, t2 - t1
    run.loop_events = loop_events
    run.graphs = graphs
    outs = [recs[0][1:1 + hp, 1:1 + wp], recs[1][1:1 + hp // 2, 1:1 + wp // 2],
            recs[2][1:1 + hp // 2, 1:1 + wp // 2]]
    run.shapes = [tuple(t.shape) for t in outs] \
        + [tuple(t.shape) for t in lvs] \
        + [tuple(t.shape) for t in lvs_cr if t is not None]
    run.flat = torch.cat([t.reshape(-1) for t in outs] + [lv])
    run.n_waves = sched.n_waves
    return run


def run_device_apply_plain(*args, **kwargs) -> ApplyRun:
    """``run_device_apply`` with every class step in the plain form, on
    any device: the yardstick of the kernel on ``cuda``."""
    return run_device_apply(*args, **kwargs, plain=True)


def collect_device_apply(run: ApplyRun):
    """Wait for a queued apply and bring it back in one device-to-host
    copy: (rec_y, rec_cb, rec_cr, per-class level stacks, per-class Cr
    level stacks, None for luma), int16 numpy."""
    flat = run.flat.cpu().numpy()
    run.graphs = None
    parts, at = [], 0
    for shape in run.shapes:
        n = int(np.prod(shape))
        parts.append(flat[at:at + n].reshape(shape))
        at += n
    rec_y, rec_cb, rec_cr = parts[:3]
    lvs = tuple(parts[3:3 + len(CLS)])
    chroma = iter(parts[3 + len(CLS):])
    lvs_cr = tuple(None if CLS[ci][1] else next(chroma)
                   for ci in range(len(CLS)))
    return rec_y, rec_cb, rec_cr, lvs, lvs_cr


def assemble_coeff_planes(sched: Schedule, lvs, lvs_cr, f) -> None:
    """Scatter the flat per-record level stacks into the frame-shaped
    coefficient planes (vectorized numpy; record coords are the wave-
    sorted schedule order)."""
    for ci in range(len(CLS)):
        s, luma, _ = CLS[ci]
        n_c = sched.counts[ci]
        if not n_c:
            continue
        xs = sched.flat[ci][0][:n_c]
        ys = sched.flat[ci][1][:n_c]
        dy = np.arange(s)
        yy = ys[:, None, None] + dy[None, :, None]
        xx = xs[:, None, None] + dy[None, None, :]
        if luma:
            f.coeff_y[yy, xx] = lvs[ci][:n_c]
        else:
            f.coeff_cb[yy, xx] = lvs[ci][:n_c]
            f.coeff_cr[yy, xx] = lvs_cr[ci][:n_c]


# wall-clock per stage, summed across frames (read and zeroed by
# stats_reset)
stage_stats = {"sched": 0.0, "launch": 0.0, "fetch": 0.0, "fill": 0.0,
               "counter": 0.0, "cabac": 0.0, "frames": 0}
_stats_lock = threading.Lock()


def add_stage(name: str, seconds: float) -> None:
    with _stats_lock:
        stage_stats[name] += seconds


def stats_reset() -> dict:
    with _stats_lock:
        out = dict(stage_stats)
        for k in stage_stats:
            stage_stats[k] = 0.0 if k != "frames" else 0
    return out


def device_apply_frame(cu, fd, qp_cb_scaled, qp_cr_scaled, nat, *, device,
                       stats=None) -> bool:
    """Full device apply for the current (intra) slice on ``device``:
    schedule, apply, fetch, frame-array fill.  Returns False when the host
    fallback must run instead (the schedule rejected the frame).
    ``stats`` (``encoder.top.DecisionStats``) counts the frame, its waves
    and class steps and its wall, or the fallback."""
    f = cu.f
    sps = cu.sps
    t0 = time.perf_counter()
    sched = build_schedule(
        fd[0], fd[1], fd[2], fd[3], f.width, f.height, f.ctu_size,
        f.max_depth - sps.add_cu_depth, sps.quadtree_tu_log2_min_size)
    if sched is None:
        if stats is not None:
            stats.add_apply_fallback()
        return False
    use_rdoq = bool(cu.cfg.get("RDOQ", 1))
    init_ctx = None
    if use_rdoq:
        from ..cabac import contexts as cc
        from .slice_encoder import enc_init_type
        init_ctx = cc.make_context_states_idx(
            enc_init_type(cu.sh, cu.pps), cu.sh.slice_qp)
    t1 = time.perf_counter()
    with _apply_lock:
        run = run_device_apply(
            cu.org_y, cu.org_cb, cu.org_cr, sched, f.width, f.height,
            cu.sh.slice_qp + sps.qp_bd_offset_y, qp_cb_scaled,
            qp_cr_scaled, f.ctu_size, sps.bit_increment,
            (1 << sps.internal_bit_depth) - 1, bool(cu.pps.sign_hide_flag),
            use_rdoq=use_rdoq, lam_y=cu.lambda_luma, lam_c=cu.lambda_chroma,
            init_ctx=init_ctx, device=device)
        t2 = time.perf_counter()
        rec_y, rec_cb, rec_cr, lvs, lvs_cr = collect_device_apply(run)
    t3 = time.perf_counter()
    h, w = f.height, f.width
    cu.rec_y[:h, :w] = rec_y[:h, :w]
    cu.rec_cb[:h // 2, :w // 2] = rec_cb[:h // 2, :w // 2]
    cu.rec_cr[:h // 2, :w // 2] = rec_cr[:h // 2, :w // 2]
    assemble_coeff_planes(sched, lvs, lvs_cr, f)
    nat.fill_from_fd()
    t4 = time.perf_counter()
    with _stats_lock:
        stage_stats["sched"] += t1 - t0
        stage_stats["launch"] += t2 - t1
        stage_stats["fetch"] += t3 - t2
        stage_stats["fill"] += t4 - t3
        stage_stats["frames"] += 1
    if stats is not None:
        stats.add_apply(t4 - t0, run.n_waves, run.class_steps)
    cu._dev_applied = True
    return True
