"""Binding of the hand-written CUDA kernels of the P/B fast-RD decision
pass's motion search (``csrc/inter_me.cu``).

Three kernels, one entry each, one a stage of ``encoder/fast_inter.py``:

- ``coarse_search`` (``thevc_coarse_search``): the quarter-resolution
  full search of one list, every reference, offset and size class in one
  launch -> per size class (dy, dx, ref), full pel.  It replaces
  ``thevc_tpu/encoder/fast_inter.py:98`` ``_coarse_fields`` (the
  ``lax.scan`` at :116-159).
- ``int_refine`` (``thevc_int_refine``): the +-3 full-pel refinement of
  one size class (SAD and the exp-Golomb prior of the median predictor)
  -> the integer MV, full pel.  It replaces ``fast_inter.py:234-262``.
- ``merge_model`` (``thevc_merge_model``): the AMVP-proxy MV bits, the RD
  sum and the 3-candidate merge/skip model of one size class -> (rd, mvx,
  mvy, ref).  It replaces ``fast_inter.py:367-428``; its interpolation is
  the MC kernel's (``csrc/mc_common.cuh``).
- ``qpel_pick`` (``thevc_qpel_pick``, kernel D): the quarter-pel
  candidates' MV prior, costs and first minimum of one size class, after
  K2's SATD -> the winner's quarter-pel MV and reference.  It replaces
  ``fast_inter.py:280-314``.
- ``bi_pick`` (``thevc_bi_pick``, kernel E): one launch a B frame over
  every inter size class, the bi stage's MV bits and RD sum and the
  L0/L1/BI direction -> (rd, dir) of each class's inter leaves.  It
  replaces ``fast_inter.py:507-526`` and ``:649-651``.

What bounds each on the card and how its design meets it are in the
source's header comment.  Their plain PyTorch forms are
``encoder.fast_inter.coarse_fields_plain``, ``int_refine_plain``,
``merge_model_plain``, ``qpel_pick_plain`` and ``bi_pick_plain``; every
output equals them bit for bit.

The kernels are compiled with ``nvcc`` on first use and bound with
``ctypes`` (``ops.build``).  Every entry checks its inputs and raises
before anything is built (``check_coarse``, ``check_refine``,
``check_merge``, ``check_qpel_pick``, ``check_bi_pick``); nothing here
runs when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import build as _build

NAME = "inter_me"
SIZES = (8, 16, 32, 64)
MAX_REFS = 16
# the quarter-res search range the coarse kernel's shared band holds: a
# search range of 64 full pel
MAX_RNG_Q = 16
MAX_BIT_INC = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "thevc_coarse_search": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _P],
    "thevc_int_refine": [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _I,
                         _I, _P, _P, _P],
    "thevc_merge_model": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P, _P],
    "thevc_qpel_pick": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "thevc_bi_pick": [_P, _P],
}
# the bi stage's inputs a class: each list's leaf (rd, mvx, mvy, ref), then
# the bi prediction's transform-RD estimates; its outputs
BI_LEAF = ("rd", "mvx", "mvy", "ref")
BI_TERMS = ("d_y", "b_y", "d_cb", "b_cb", "d_cr", "b_cr")


class _BiClass(ctypes.Structure):
    _fields_ = ([(f"{n}{k}", _P) for k in (0, 1) for n in BI_LEAF]
                + [(n, _P) for n in BI_TERMS + ("rd", "dir")]
                + [("nb", _I), ("size", _I), ("first", _I)])


class BiArgs(ctypes.Structure):
    """``BiArgs`` of ``csrc/inter_me.cu``: the class table (8 first;
    ``first`` is set by the entry), lambda, the chroma weight and the
    class count."""
    _fields_ = [("cls", _BiClass * 4), ("lam", _P), ("cw", _P),
                ("classes", _I)]

# kernel launches made by each entry; plain integers that a run resets and
# reads to show that its main path went through the kernels
coarse_launches = 0
refine_launches = 0
merge_launches = 0
pick_launches = 0
bi_launches = 0


def build() -> ctypes.CDLL:
    """Compile (if not built yet) and load the kernel library."""
    return _build.load(NAME, _ENTRIES)


def _on(dev: torch.device):
    """A context on ``dev``: none when it is the current device already
    (a device switch costs the host a few microseconds a launch)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _pointers(ts) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the motion-search kernels take CUDA tensors, "
                         f"{name} is on {t.device}")


def _check_scalar(t: torch.Tensor, name: str, device) -> None:
    """A float32 scalar the kernel reads on the device."""
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be one float32 on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_plane(t: torch.Tensor, name: str, rows: int, cols: int,
                 device) -> None:
    """An int16 [H, W] plane, contiguous, of at least rows x cols."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be [H, W], got {tuple(t.shape)}")
    _build.check_tensor(t, name, torch.int16, tuple(t.shape), device)
    if t.shape[0] < rows or t.shape[1] < cols:
        raise ValueError(f"{name} {tuple(t.shape)} is smaller than the "
                         f"blocks' {rows}x{cols}")


def _check_stack(t: torch.Tensor, name: str, device) -> None:
    if t.dim() != 3 or t.shape[0] < 1:
        raise ValueError(f"{name} must be [P, H, W], got {tuple(t.shape)}")
    _build.check_tensor(t, name, torch.int16, tuple(t.shape), device)


def _check_grid(s: int, nby: int, nbx: int, bit_increment: int) -> None:
    if s not in SIZES:
        raise ValueError(f"size {s} not in {SIZES}")
    if nby <= 0 or nbx <= 0:
        raise ValueError(f"block grid {nby}x{nbx} is empty")
    if not 0 <= bit_increment <= MAX_BIT_INC:
        raise ValueError(f"bit increment {bit_increment} out of 0.."
                         f"{MAX_BIT_INC}")


def check_coarse(org_q: torch.Tensor, refs_q: list, rng_q: int,
                 sqrt_lam: torch.Tensor, sizes: tuple) -> None:
    """Raise on any input the coarse search does not take (but a device
    that is not CUDA: the entry refuses that): the pooled source int16
    [hq, wq], each reference's pooled band int16 [hq + 2 rng_q, wq + 2
    rng_q], contiguous, 1..16 of them, rng_q at most 16 (a search range
    of 64), the size classes a prefix of 8, 16, 32, 64 that tiles the
    source."""
    if not 0 <= rng_q <= MAX_RNG_Q:
        raise ValueError(f"search range {4 * rng_q} (quarter-res "
                         f"{rng_q}): the coarse kernel takes at most "
                         f"{4 * MAX_RNG_Q}")
    if not 1 <= len(refs_q) <= MAX_REFS:
        raise ValueError(f"{len(refs_q)} references, 1..{MAX_REFS}")
    sizes = tuple(sizes)
    if not sizes or sizes != SIZES[:len(sizes)]:
        raise ValueError(f"size classes {sizes}: a prefix of {SIZES}")
    if org_q.dim() != 2:
        raise ValueError(f"org_q must be [hq, wq], got {tuple(org_q.shape)}")
    dev = org_q.device
    hq, wq = (int(v) for v in org_q.shape)
    _build.check_tensor(org_q, "org_q", torch.int16, (hq, wq), dev)
    top = sizes[-1] // 4
    if hq % top or wq % top or hq == 0 or wq == 0:
        raise ValueError(f"org_q {hq}x{wq} is not a grid of {sizes[-1]} "
                         "blocks")
    for r, ref in enumerate(refs_q):
        _build.check_tensor(ref, f"refs_q[{r}]", torch.int16,
                            (hq + 2 * rng_q, wq + 2 * rng_q), dev)
    _check_scalar(sqrt_lam, "sqrt_lam", dev)


def coarse_outputs(hq: int, wq: int, sizes: tuple, device) -> dict:
    """The coarse search's outputs: per size s an int64 [3, hq * 4 // s,
    wq * 4 // s] view, class after class in one buffer (the kernel's
    layout)."""
    shapes = [(3, hq * 4 // s, wq * 4 // s) for s in sizes]
    flat = torch.empty(sum(a * b * c for a, b, c in shapes),
                       dtype=torch.int64, device=device)
    out, at = {}, 0
    for s, shape in zip(sizes, shapes):
        n = shape[0] * shape[1] * shape[2]
        out[s] = flat[at:at + n].view(shape)
        at += n
    return out


def coarse_search(org_q: torch.Tensor, refs_q: list, rng_q: int,
                  sqrt_lam: torch.Tensor, sizes: tuple) -> dict:
    """Launch the coarse search of one list: the pooled source int16
    [hq, wq], the references' pooled bands, the motion sqrt-lambda (a
    float32 on the card) -> per size s of ``sizes`` (dy, dx, ref), int64
    [hq * 4 // s, wq * 4 // s] each, dy and dx in full pel."""
    global coarse_launches
    _check_cuda(org_q, "org_q")
    check_coarse(org_q, refs_q, rng_q, sqrt_lam, sizes)
    hq, wq = (int(v) for v in org_q.shape)
    dev = org_q.device
    outs = coarse_outputs(hq, wq, tuple(sizes), dev)
    lib = build()
    with _on(dev):
        rc = lib.thevc_coarse_search(
            org_q.data_ptr(), hq, wq, _pointers(refs_q), len(refs_q), rng_q,
            sqrt_lam.data_ptr(), outs[sizes[0]].data_ptr(), len(outs),
            _build.stream_of(dev))
    _build.check(lib, rc, "coarse search kernel launch")
    coarse_launches += 1
    return {s: tuple(o) for s, o in outs.items()}


def check_refine(org: torch.Tensor, refs_y: torch.Tensor, coarse: tuple,
                 s: int, nby: int, nbx: int, sqrt_lam: torch.Tensor,
                 bit_increment: int) -> None:
    """Raise on any input the integer refinement does not take (but a
    device that is not CUDA): the source plane int16 [>= nby s, >= nbx s],
    the padded reference stack int16 [P, H, W], the coarse field (dy, dx,
    ref) int64 [nby, nbx] each, contiguous."""
    _check_grid(s, nby, nbx, bit_increment)
    dev = org.device
    _check_plane(org, "org", nby * s, nbx * s, dev)
    _check_stack(refs_y, "refs_y", dev)
    if len(coarse) != 3:
        raise ValueError("coarse must be (dy, dx, ref)")
    for name, t in zip(("dy", "dx", "ref"), coarse):
        _build.check_tensor(t, f"coarse {name}", torch.int64, (nby, nbx),
                            dev)
    _check_scalar(sqrt_lam, "sqrt_lam", dev)


def int_refine(org: torch.Tensor, refs_y: torch.Tensor, coarse: tuple,
               s: int, nby: int, nbx: int, sqrt_lam: torch.Tensor,
               bit_increment: int, pad: int) -> tuple:
    """Launch the integer refinement of one size class: the source plane,
    the references' luma planes padded by ``pad``, the coarse field (dy,
    dx, ref) -> (int_mx, int_my), int64 [nby * nbx], full pel."""
    global refine_launches
    _check_cuda(org, "org")
    check_refine(org, refs_y, coarse, s, nby, nbx, sqrt_lam, bit_increment)
    dev = org.device
    nb = nby * nbx
    out = torch.empty((2, nb), dtype=torch.int64, device=dev)
    c_dy, c_dx, c_ref = coarse
    lib = build()
    with _on(dev):
        rc = lib.thevc_int_refine(
            org.data_ptr(), int(org.shape[1]), refs_y.data_ptr(),
            int(refs_y.shape[1]), int(refs_y.shape[2]), c_dy.data_ptr(),
            c_dx.data_ptr(), c_ref.data_ptr(), s, nby, nbx,
            sqrt_lam.data_ptr(), bit_increment, pad, out[0].data_ptr(),
            out[1].data_ptr(), _build.stream_of(dev))
    _build.check(lib, rc, "integer refinement kernel launch")
    refine_launches += 1
    return out[0], out[1]


def check_merge(orgs: tuple, refs_y: torch.Tensor, refs_c: torch.Tensor,
                s: int, nby: int, nbx: int, rd_terms: tuple,
                winner: tuple, lam: torch.Tensor, cw: torch.Tensor,
                bit_increment: int) -> None:
    """Raise on any input the merge model does not take (but a device
    that is not CUDA: the entry refuses that): the source planes (luma
    int16 [>= nby s, >= nbx s], Cb and Cr int16 of one shape [>= nby s/2,
    >= nbx s/2]), the stacks of the references' luma planes [P, H, W] and
    of their Cb then Cr planes [2P, Hc, Wc], the transform-RD estimates
    (d_y, b_y, d_cb, b_cb, d_cr, b_cr: int32 dist, float32 bits, [nb]
    each), the winner (mvx, mvy, ref: int32 [nb] each), contiguous.
    One pass, in this order: the first input that fails raises."""
    _check_grid(s, nby, nbx, bit_increment)
    nb = nby * nbx
    dev = orgs[0].device
    if len(orgs) != 3:
        raise ValueError("orgs must be (luma, Cb, Cr)")
    _check_plane(orgs[0], "org", nby * s, nbx * s, dev)
    for name, t in zip(("org_cb", "org_cr"), orgs[1:]):
        _check_plane(t, name, nby * s // 2, nbx * s // 2, dev)
    if orgs[1].shape != orgs[2].shape:
        raise ValueError("the Cb and Cr source planes differ in shape")
    _check_stack(refs_y, "refs_y", dev)
    _check_stack(refs_c, "refs_c", dev)
    if refs_c.shape[0] != 2 * refs_y.shape[0]:
        raise ValueError(f"refs_c holds {refs_c.shape[0]} planes for "
                         f"{refs_y.shape[0]} references (Cb, then Cr)")
    if len(rd_terms) != 6:
        raise ValueError("rd_terms must be (d_y, b_y, d_cb, b_cb, d_cr, "
                         "b_cr)")
    for k, t in enumerate(rd_terms):
        _build.check_tensor(t, f"rd_terms[{k}]",
                            torch.float32 if k % 2 else torch.int32, (nb,),
                            dev)
    if len(winner) != 3:
        raise ValueError("winner must be (mvx, mvy, ref)")
    for name, t in zip(("mvx", "mvy", "ref"), winner):
        _build.check_tensor(t, name, torch.int32, (nb,), dev)
    _check_scalar(lam, "lam", dev)
    _check_scalar(cw, "cw", dev)


def merge_model(orgs: tuple, refs_y: torch.Tensor, refs_c: torch.Tensor,
                s: int, nby: int, nbx: int, rd_terms: tuple, winner: tuple,
                lam: torch.Tensor, cw: torch.Tensor, bit_increment: int,
                pad_y: int, pad_c: int) -> tuple:
    """Launch the merge/skip model of one size class: the source planes,
    the references' planes padded by ``pad_y`` (luma) and ``pad_c``
    (chroma), the winner's transform-RD estimates and MV (quarter pel)
    and reference, lambda and the chroma weight (float32 on the card) ->
    (rd float32, mvx, mvy, ref int32), each [nby, nbx]: views of one
    int32 [4, nby, nbx] buffer, rd's float32 bits first."""
    global merge_launches
    _check_cuda(orgs[0], "org")
    check_merge(orgs, refs_y, refs_c, s, nby, nbx, rd_terms, winner, lam, cw,
                bit_increment)
    dev = orgs[0].device
    out = torch.empty((4, nby, nbx), dtype=torch.int32, device=dev)
    org_y, org_cb, org_cr = orgs
    d_y, b_y, d_cb, b_cb, d_cr, b_cr = rd_terms
    mvx, mvy, ref = winner
    lib = build()
    with _on(dev):
        rc = lib.thevc_merge_model(
            org_y.data_ptr(), org_cb.data_ptr(), org_cr.data_ptr(),
            org_y.shape[1], org_cb.shape[1], refs_y.data_ptr(),
            refs_y.shape[0], refs_y.shape[1], refs_y.shape[2],
            refs_c.data_ptr(), refs_c.shape[1], refs_c.shape[2],
            d_y.data_ptr(), d_cb.data_ptr(), d_cr.data_ptr(),
            b_y.data_ptr(), b_cb.data_ptr(), b_cr.data_ptr(),
            mvx.data_ptr(), mvy.data_ptr(), ref.data_ptr(), lam.data_ptr(),
            cw.data_ptr(), s, nby, nbx, bit_increment, pad_y, pad_c,
            out.data_ptr(), _build.stream_of(dev))
    _build.check(lib, rc, "merge model kernel launch")
    merge_launches += 1
    return out[0].view(torch.float32), out[1], out[2], out[3]


def check_qpel_pick(satd: torch.Tensor, coarse: tuple,
                    int_mx: torch.Tensor, int_my: torch.Tensor,
                    sqrt_lam: torch.Tensor) -> None:
    """Raise on any input the quarter-pel pick does not take (but a
    device that is not CUDA): K2's SATD int32 [nb, 49], the coarse field
    (dy, dx, ref) int64 [nby, nbx] each, the integer winner int64 [nb]
    each, nb = nby * nbx, contiguous; sqrt-lambda one float32."""
    if len(coarse) != 3:
        raise ValueError("coarse must be (dy, dx, ref)")
    if coarse[0].dim() != 2:
        raise ValueError(f"the coarse field must be [nby, nbx], got "
                         f"{tuple(coarse[0].shape)}")
    nby, nbx = (int(v) for v in coarse[0].shape)
    if nby <= 0 or nbx <= 0:
        raise ValueError(f"block grid {nby}x{nbx} is empty")
    dev = satd.device
    nb = nby * nbx
    _build.check_tensor(satd, "satd", torch.int32, (nb, 49), dev)
    for name, t in zip(("dy", "dx", "ref"), coarse):
        _build.check_tensor(t, f"coarse {name}", torch.int64, (nby, nbx),
                            dev)
    for name, t in (("int_mx", int_mx), ("int_my", int_my)):
        _build.check_tensor(t, name, torch.int64, (nb,), dev)
    _check_scalar(sqrt_lam, "sqrt_lam", dev)


def qpel_pick(satd: torch.Tensor, coarse: tuple, int_mx: torch.Tensor,
              int_my: torch.Tensor, sqrt_lam: torch.Tensor) -> tuple:
    """Launch the quarter-pel pick of one size class: K2's SATD of the 49
    candidates, the class's coarse field (dy, dx, ref; full pel), the
    integer winner (full pel) and the motion sqrt-lambda (a float32 on the
    card) -> (mv_qx, mv_qy (quarter pel), ref), int32 [nb] each: views of
    one int32 [3, nb] buffer."""
    global pick_launches
    _check_cuda(satd, "satd")
    check_qpel_pick(satd, coarse, int_mx, int_my, sqrt_lam)
    nby, nbx = (int(v) for v in coarse[0].shape)
    dev = satd.device
    out = torch.empty((3, nby * nbx), dtype=torch.int32, device=dev)
    c_dy, c_dx, c_ref = coarse
    lib = build()
    with _on(dev):
        rc = lib.thevc_qpel_pick(
            satd.data_ptr(), c_dy.data_ptr(), c_dx.data_ptr(),
            c_ref.data_ptr(), int_mx.data_ptr(), int_my.data_ptr(),
            sqrt_lam.data_ptr(), nby, nbx, out.data_ptr(),
            _build.stream_of(dev))
    _build.check(lib, rc, "quarter-pel pick kernel launch")
    pick_launches += 1
    return out[0], out[1], out[2]


def check_bi_pick(classes: dict, lam: torch.Tensor, cw: torch.Tensor,
                  ctu_size: int) -> None:
    """Raise on any input the bi stage's pick does not take (but a device
    that is not CUDA): ``classes[s]`` for each inter size s of 8..64 up
    to the CTU (and none above it) holds (leaf0, leaf1, terms): each
    list's (rd float32, mvx, mvy, ref int32) [nby, nbx] (the merge
    model's) and the bi prediction's (d_y, b_y, d_cb, b_cb, d_cr, b_cr)
    (int32 dist, float32 bits) [nby * nbx], contiguous; lambda and the
    chroma weight one float32 each."""
    want = [s for s in SIZES if s <= ctu_size]
    if not want or sorted(classes) != want:
        raise ValueError(f"inter classes {sorted(classes)}: expected "
                         f"{want} for a CTU of {ctu_size}")
    dev = lam.device
    for s, (leaf0, leaf1, terms) in classes.items():
        if len(leaf0) != 4 or len(leaf1) != 4 or len(terms) != 6:
            raise ValueError(f"class {s}: each leaf is (rd, mvx, mvy, ref) "
                             "and the terms (d_y, b_y, d_cb, b_cb, d_cr, "
                             "b_cr)")
        if leaf0[0].dim() != 2:
            raise ValueError(f"class {s}: a leaf's rd must be [nby, nbx], "
                             f"got {tuple(leaf0[0].shape)}")
        shape = tuple(int(v) for v in leaf0[0].shape)
        for k, leaf in enumerate((leaf0, leaf1)):
            for name, t in zip(BI_LEAF, leaf):
                _build.check_tensor(t, f"class {s} list {k} {name}",
                                    torch.float32 if name == "rd"
                                    else torch.int32, shape, dev)
        for k, (name, t) in enumerate(zip(BI_TERMS, terms)):
            _build.check_tensor(t, f"class {s} {name}",
                                torch.float32 if k % 2 else torch.int32,
                                (shape[0] * shape[1],), dev)
    _check_scalar(lam, "lam", dev)
    _check_scalar(cw, "cw", dev)


def bi_pick(classes: dict, lam: torch.Tensor, cw: torch.Tensor,
            ctu_size: int) -> dict:
    """Launch the bi stage's pick once over every inter size class
    (``check_bi_pick``'s ``classes``) with lambda and the chroma weight
    (float32 on the card) -> {s: (rd float32, dir int32)}, [nby, nbx]
    each: rd the least of the two lists' and the bi prediction's RD cost,
    dir 3 (bi), else 1 (L0), else 2 (L1), the inter leaves' rd and dir
    that the DP kernel reads; views of one int32 buffer, per class rd's
    float32 bits, then dir."""
    global bi_launches
    _check_cuda(lam, "lam")
    check_bi_pick(classes, lam, cw, ctu_size)
    dev = lam.device
    sizes = sorted(classes)
    shapes = [tuple(classes[s][0][0].shape) for s in sizes]
    nbs = [a * b for a, b in shapes]
    flat = torch.empty(2 * sum(nbs), dtype=torch.int32, device=dev)
    a = BiArgs()
    out, at = {}, 0
    for k, (s, shape, nb) in enumerate(zip(sizes, shapes, nbs)):
        rd = flat[at:at + nb].view(torch.float32).view(shape)
        direc = flat[at + nb:at + 2 * nb].view(shape)
        at += 2 * nb
        out[s] = (rd, direc)
        leaf0, leaf1, terms = classes[s]
        c = a.cls[k]
        for j, leaf in enumerate((leaf0, leaf1)):
            for name, t in zip(BI_LEAF, leaf):
                setattr(c, f"{name}{j}", t.data_ptr())
        for name, t in zip(BI_TERMS, terms):
            setattr(c, name, t.data_ptr())
        c.rd, c.dir = rd.data_ptr(), direc.data_ptr()
        c.nb, c.size = nb, s
    a.lam, a.cw, a.classes = lam.data_ptr(), cw.data_ptr(), len(sizes)
    lib = build()
    with _on(dev):
        rc = lib.thevc_bi_pick(ctypes.addressof(a), _build.stream_of(dev))
    _build.check(lib, rc, "bi pick kernel launch")
    bi_launches += 1
    return out
