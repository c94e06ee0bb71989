"""The hand-written CUDA kernels (residual, dense and CG-packed; SATD;
motion compensation, picture, blocks and quarter-pel entries; the intra
decision pass's sweep and TU-RD kernels, every class and both bit
increments) against their plain versions, also at the shapes of the P/B
fast-RD pass (SATD over 49 quarter-pel candidates, inter TUs), the
fast-RD decision passes (8 and 10 bits), motion
compensation and the P/B decode (weighted prediction and scaling lists
included) on CUDA against the CPU, on a CUDA card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and
skips without one.  Run on the GPU machine with
``python -m pytest tests/test_torch_kernels.py -m gpu``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thevc_tpu.ops import transforms as tops
from thevc_tpu_torch.common.tables import from_reference
from thevc_tpu_torch.decoder.recon import _pack_cgs
from thevc_tpu_torch.encoder import fast_inter, fast_intra
from thevc_tpu_torch.ops import intra_rd_kernel, mc, mc_kernel, \
    residual_kernel, satd, satd_kernel, tq
from thevc_tpu_torch.ops.intra import HOR_IDX, VER_IDX

REPO = Path(__file__).resolve().parents[1]
CASES = [(4, False, 0), (4, True, 0), (8, False, 0), (16, False, 0),
         (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2)]
# luma PU sizes of a stream (square, rectangular, AMP), (rows, columns);
# a chroma job takes half of each
PU_SIZES = [(8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (16, 4),
            (4, 16), (12, 16), (16, 12), (32, 24), (24, 32), (64, 16),
            (16, 64), (48, 64), (64, 48)]
MC_PLANE = (40, 56)          # luma rows and columns of a reference picture


def random_mc_jobs(rng, bd: int, n: int, refs: int = 2, sizes=None,
                   kinds=None):
    """A seeded job table of the MC picture kernel (``mc_kernel``):
    every case, luma and chroma, every kind, windows past every edge of
    the planes, weights and offsets at their extremes, each job writing
    its own region (row stride up to 3 past its width).  Uni and bi jobs
    carry the weights a slice without weighted prediction gives (1, 1,
    0, 0).  ``sizes`` (luma (rows, columns)) and ``kinds`` (names of
    ``mc.KINDS``) narrow the draws (default: ``PU_SIZES``, every kind).
    Returns (jobs int32 [n, JOB_COLS], the int16 planes (y, cb, cr) of
    each reference as CPU tensors, the prediction's size)."""
    sizes = PU_SIZES if sizes is None else sizes
    kinds = mc.KINDS if kinds is None else kinds
    h_l, w_l = MC_PLANE
    planes = []
    for _ in range(refs):
        for rows, cols in ((h_l, w_l), (h_l // 2, w_l // 2),
                           (h_l // 2, w_l // 2)):
            planes.append(torch.from_numpy(rng.randint(
                0, 1 << bd, (rows, cols)).astype(np.int16)))
    jobs = np.zeros((n, mc.JOB_COLS), np.int64)
    size = 0
    for i in range(n):
        luma = rng.rand() < 0.5
        h, w = sizes[rng.randint(len(sizes))]
        comp = 0 if luma else 1 + rng.randint(2)
        if not luma:
            h, w = h // 2, w // 2
        rows, cols = planes[comp].shape
        top, half = (4, 4) if luma else (8, 2)
        kind = mc.KINDS.index(kinds[rng.randint(len(kinds))])
        stride = w + rng.randint(4)
        jobs[i, :mc.J_LIST] = (h, w, luma, kind, size, stride, 1, 1, 0, 0)
        size += h * stride
        for lst in range(1 + (mc.KINDS[kind] in ("bi", "wbi"))):
            fx = rng.randint(top) * (rng.rand() < 0.6)
            fy = rng.randint(top) * (rng.rand() < 0.6)
            x = rng.randint(-w - 12, cols + 12)
            y = rng.randint(-h - 12, rows + 12)
            c = mc.J_LIST + 6 * lst
            jobs[i, c:c + 6] = (3 * rng.randint(refs) + comp,
                                x - (half - 1) * (fx != 0),
                                y - (half - 1) * (fy != 0), fx, fy,
                                (fx != 0) + 2 * (fy != 0))
        if mc.KINDS[kind] in ("wuni", "wbi"):
            w0, w1 = rng.randint(-128, 256, 2)
            io0, io1 = rng.randint(-128, 128, 2)
            bi = mc.KINDS[kind] == "wbi"
            jobs[i, mc.J_W0:mc.J_LIST] = (
                w0, w1 if bi else 1, (io0 + io1 * bi) << (bd - 8),
                rng.randint(8))
    return jobs.astype(np.int32), planes, size


@pytest.fixture
def cuda():
    # decided here, not at import: the test workers must all collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 129, 4099])
@pytest.mark.parametrize("size,use_dst,bit_inc", CASES)
def test_kernel_equals_plain_and_numpy(cuda, size, use_dst, bit_inc, n):
    rng = np.random.RandomState(size + bit_inc + n)
    q = rng.randint(-32768, 32768, (n, size, size)).astype(np.int16)
    qp = rng.randint(0, 64, n).astype(np.int32)
    qd, qpd = torch.from_numpy(q).to(cuda), torch.from_numpy(qp).to(cuda)
    before = residual_kernel.launches
    got = tq.residual_pipeline(qd, qpd, use_dst, bit_inc)
    torch.cuda.synchronize()
    assert residual_kernel.launches == before + 1
    plain = tq.residual_pipeline_plain(qd, qpd, use_dst, bit_inc)
    assert torch.equal(got, plain)
    ref = tops.inverse_transform(tops.dequant(q.astype(np.int32), qp,
                                              bit_inc),
                                 use_dst, bit_inc).astype(np.int16)
    assert np.array_equal(got.cpu().numpy(), ref)


@pytest.mark.gpu
def test_packed_pipeline_on_cuda(cuda):
    rng = np.random.RandomState(5)
    n, size = 300, 16
    q = rng.randint(-900, 900, (n, size, size)).astype(np.int16)
    q[rng.rand(n) < 0.5] = 0
    qp = rng.randint(0, 52, n).astype(np.int32)
    vals, idx = _pack_cgs(q, size, n)
    got = tq.residual_pipeline_packed(
        torch.from_numpy(vals).to(cuda), torch.from_numpy(idx).to(cuda),
        torch.from_numpy(qp).to(cuda), size)
    ref = tq.residual_pipeline_plain(torch.from_numpy(q),
                                     torch.from_numpy(qp))
    assert torch.equal(got.cpu(), ref)


def _packed_case(size, n, bit_inc, density, seed):
    """Full-range int16 coefficients, each 4x4 group coded with
    probability ``density`` and a fifth of the TUs with no coded group,
    CG-packed with the decoder's padding rows; scaled QPs of slice QPs
    0..51."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-32768, 32768, (n, size, size)).astype(np.int16)
    g = size // 4
    keep = rng.rand(n, g, 1, g, 1) < density
    keep[rng.rand(n) < 0.2] = False
    keep = np.broadcast_to(keep, (n, g, 4, g, 4)).reshape(n, size, size)
    q = np.where(keep, q, 0).astype(np.int16)
    qp = rng.randint(0, 52 + 6 * bit_inc, n).astype(np.int32)
    vals, idx = _pack_cgs(q, size, n)
    return q, qp, vals, idx


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 63, 4099])
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("size", [8, 16, 32])
def test_fused_packed_kernel_equals_plain(cuda, size, bit_inc, n, density):
    """The fused kernel (CG unpack + dequant + both passes on the tensor
    cores) against the plain packed version, tolerance 0: full-range
    values exercise the hi/lo split, TUs with no coded group and the
    padding rows the binary search, and N not a multiple of the block's
    tile the ragged last block."""
    q, qp, vals, idx = _packed_case(size, n, bit_inc, density,
                                    size + 7 * n + 3 * bit_inc)
    args = [torch.from_numpy(a).to(cuda) for a in (vals, idx, qp)]
    before = residual_kernel.launches
    got = tq.residual_pipeline_packed(*args, size, False, bit_inc)
    torch.cuda.synchronize()
    assert residual_kernel.launches == before + 1
    assert got.dtype == torch.int16 and tuple(got.shape) == (n, size, size)
    assert torch.equal(got, tq.residual_pipeline_packed_plain(
        *args, size, False, bit_inc))
    ref = tops.inverse_transform(tops.dequant(q.astype(np.int32), qp,
                                              bit_inc),
                                 False, bit_inc).astype(np.int16)
    assert np.array_equal(got.cpu().numpy(), ref)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda):
    basis = from_reference(cuda).dct[8]
    x = torch.zeros((3, 8, 8), dtype=torch.int16, device=cuda)
    qp = torch.ones(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        residual_kernel.residual(x.to(torch.int32), qp, basis, 2, 12)
    with pytest.raises(ValueError):
        residual_kernel.residual(x, qp[:2], basis, 2, 12)
    with pytest.raises(ValueError):
        residual_kernel.residual(x.transpose(1, 2), qp, basis, 2, 12)
    with pytest.raises(ValueError):
        residual_kernel.residual(x.cpu(), qp, basis, 2, 12)
    with pytest.raises(RuntimeError):
        residual_kernel.residual(x, qp, basis, 0, 12)   # bad shift
    vals = torch.zeros((4, 16), dtype=torch.int16, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        residual_kernel.residual_packed(vals, idx, qp, basis, 4, 2, 12)
    with pytest.raises(TypeError):
        residual_kernel.residual_packed(vals, idx.long(), qp, basis, 8, 2,
                                        12)
    with pytest.raises(ValueError):
        residual_kernel.residual_packed(vals[:, :8], idx, qp, basis, 8, 2,
                                        12)
    with pytest.raises(RuntimeError):
        residual_kernel.residual_packed(vals, idx, qp, basis, 8, 0, 12)


SATD_CLASSES = [(4, 0), (8, 0), (16, 0), (32, 0), (64, 0), (8, 2), (64, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 129, 4099])
@pytest.mark.parametrize("size,bit_inc", SATD_CLASSES)
def test_satd_kernel_equals_plain(cuda, size, bit_inc, n):
    from thevc_tpu.encoder.rdcost import calc_had_batched
    rng = np.random.RandomState(size + bit_inc + n)
    hi = 256 << bit_inc
    org = rng.randint(0, hi, (n, size, size)).astype(np.int16)
    preds = rng.randint(0, hi, (n, 35, size, size)).astype(np.int16)
    od, pd = torch.from_numpy(org).to(cuda), torch.from_numpy(preds).to(cuda)
    before = satd_kernel.launches
    got = satd.satd_blocks(od, pd, bit_inc)
    torch.cuda.synchronize()
    assert satd_kernel.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, 35)
    assert torch.equal(got, satd.satd_plain(od, pd, bit_inc))
    ref = calc_had_batched(org[0], preds[0], bit_inc)
    assert np.array_equal(got[0].cpu().numpy(), ref)


@pytest.mark.gpu
def test_satd_kernel_rejects_bad_inputs(cuda):
    org = torch.zeros((3, 8, 8), dtype=torch.int16, device=cuda)
    preds = torch.zeros((3, 35, 8, 8), dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError):
        satd_kernel.satd(org.to(torch.int32), preds, 0)
    with pytest.raises(ValueError):
        satd_kernel.satd(org[:2], preds, 0)                   # N differs
    with pytest.raises(ValueError):
        satd_kernel.satd(org, preds[:, :, :, :4], 0)          # not square
    with pytest.raises(ValueError):
        satd_kernel.satd(org[:, :4, :4], preds[..., :4, :4], 0)  # strided
    with pytest.raises(ValueError):
        satd_kernel.satd(org.cpu(), preds, 0)
    with pytest.raises(ValueError):
        satd_kernel.satd(org, preds, 31)                      # bit_inc
    flat = torch.zeros(3 * 35 * 64 + 1, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        satd_kernel.satd(org, flat[1:].view(3, 35, 8, 8), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("size,use_dst,bit_inc", CASES)
def test_tu_recon_pipeline_on_cuda_equals_plain(cuda, size, use_dst,
                                                bit_inc):
    rng = np.random.RandomState(size + 3 * bit_inc)
    n = 777
    max_val = (256 << bit_inc) - 1
    pred = torch.from_numpy(rng.randint(0, max_val + 1, (n, size, size))
                            .astype(np.int32)).to(cuda)
    levels = torch.from_numpy(rng.randint(-40000, 40000, (n, size, size))
                              .astype(np.int32)).to(cuda)
    qp = torch.from_numpy(rng.randint(0, 52, n).astype(np.int32)).to(cuda)
    before = residual_kernel.launches
    got = tq.tu_recon_pipeline(pred, levels, qp, use_dst, bit_inc, max_val)
    torch.cuda.synchronize()
    assert residual_kernel.launches == before + 1
    assert torch.equal(got, tq.tu_recon_pipeline_plain(
        pred, levels, qp, use_dst, bit_inc, max_val))


@pytest.mark.gpu
def test_decide_frame_cuda_equals_cpu(cuda, tmp_path):
    from thevc_tpu.encoder.rdcost import chroma_weight, slice_lambda_and_qp
    from thevc_tpu.ops.transforms import qp_scaled
    clip = tmp_path / "clip_416x240.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(clip), "--width", "416", "--height", "240",
                    "--frames", "1"], check=True, capture_output=True)
    w, h = 416, 240
    raw = np.fromfile(clip, np.uint8).astype(np.int16)
    y = raw[:w * h].reshape(h, w)
    cb = raw[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
    cr = raw[w * h * 5 // 4:].reshape(h // 2, w // 2)
    # 8 bits at three QPs, and the same content as 10 bits (bit
    # increment 2, QPs scaled by 12)
    for qp, bit_inc in ((27, 0), (32, 0), (37, 0), (32, 2)):
        lam, _ = slice_lambda_and_qp(qp, True, 1, 0.57, 0, True, 0)
        qpc = qp_scaled(qp, False, 0)
        planes = [(p.astype(np.int32) << bit_inc).astype(np.int16)
                  for p in (y, cb, cr)]
        args = (*planes, w, h, qp + 6 * bit_inc, qpc + 6 * bit_inc,
                qpc + 6 * bit_inc, lam, lam ** 0.5, (1.0, 2.0, 5.5),
                (0.5, 3.5, chroma_weight(qp)), 4, 2, 64, bit_inc,
                (256 << bit_inc) - 1)
        before = (satd_kernel.launches, residual_kernel.launches,
                  intra_rd_kernel.sweep_launches,
                  intra_rd_kernel.tu_rd_intra_launches,
                  intra_rd_kernel.tu_rd_given_launches)
        maps_cuda = fast_intra.decide_frame(*args, device=cuda)
        # the I pass runs on the intra decision kernels: one sweep a luma
        # class, one TU-RD launch a luma class and one a chroma class,
        # and neither K2 nor K1
        assert (satd_kernel.launches, residual_kernel.launches) == \
            before[:2]
        assert intra_rd_kernel.sweep_launches == before[2] + 5
        assert intra_rd_kernel.tu_rd_intra_launches == before[3] + 10
        assert intra_rd_kernel.tu_rd_given_launches == before[4]
        maps_cpu = fast_intra.decide_frame(*args, device="cpu")
        for a, b in zip(maps_cuda, maps_cpu):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _intra_plane(rng, rows: int, cols: int, bit_inc: int) -> torch.Tensor:
    """A seeded int16 plane of ramps and noise, values in 0..2^(8+bi)-1."""
    hi = 256 << bit_inc
    yy, xx = np.mgrid[0:rows, 0:cols]
    v = (xx * 5 + yy * 3 + rng.randint(0, 32, (rows, cols))) << bit_inc
    return torch.from_numpy((v % hi).astype(np.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_intra_sweep_kernel_equals_plain(cuda, s, bit_inc):
    rng = np.random.RandomState(s + bit_inc)
    # a ragged grid: 3 x 13 blocks (not a multiple of a CTA's blocks)
    nby, nbx = 3, 13
    plane = _intra_plane(rng, nby * s + 2 * s + 1, nbx * s + 2 * s + 1,
                         bit_inc).to(cuda)
    max_val = (256 << bit_inc) - 1
    before = (intra_rd_kernel.sweep_launches, satd_kernel.launches)
    got, best = fast_intra.intra_sweep(plane, s, nby, nbx, bit_inc, max_val)
    assert intra_rd_kernel.sweep_launches == before[0] + 1
    assert satd_kernel.launches == before[1]
    want, want_best = fast_intra.intra_sweep_plain(plane, s, nby, nbx,
                                                   bit_inc, max_val)
    torch.cuda.synchronize()
    assert got.dtype == best.dtype == torch.int32
    assert torch.equal(got, want) and torch.equal(best, want_best)
    cpu, cpu_best = fast_intra.intra_sweep(plane.cpu(), s, nby, nbx,
                                           bit_inc, max_val)
    assert torch.equal(got.cpu(), cpu) and torch.equal(best.cpu(), cpu_best)


def _same_rd(got, want):
    (d, b), (d0, b0) = got, want
    assert d.dtype == d0.dtype == torch.int32
    assert b.dtype == b0.dtype == torch.float32
    assert torch.equal(d.cpu(), d0.cpu())
    # bit for bit
    assert torch.equal(b.cpu().view(torch.int32), b0.cpu().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("luma,size", [(True, 4), (True, 8), (True, 16),
                                       (True, 32), (True, 64), (False, 4),
                                       (False, 8), (False, 16),
                                       (False, -32)])
def test_tu_rd_intra_kernel_equals_plain(cuda, luma, size, bit_inc):
    s = abs(size)
    rng = np.random.RandomState(s + bit_inc + 100 * luma)
    nby, nbx, k = 3, 5, 3 if luma else 5
    planes = tuple(_intra_plane(rng, nby * s + 2 * s + 1,
                                nbx * s + 2 * s + 1, bit_inc).to(cuda)
                   for _ in range(1 if luma else 2))
    modes = torch.from_numpy(rng.randint(0, 35, (nby * nbx, k)).astype(
        np.int32)).to(cuda)
    modes[0, :2] = torch.tensor([HOR_IDX, VER_IDX])
    qps = tuple(torch.tensor(22 + 6 * bit_inc + 5 * i, device=cuda)
                for i in range(len(planes)))
    max_val = (256 << bit_inc) - 1
    before = (intra_rd_kernel.tu_rd_intra_launches, residual_kernel.launches)
    got = fast_intra.tu_rd_modes(planes, size, nby, nbx, modes, qps, bit_inc,
                                 max_val, luma)
    assert intra_rd_kernel.tu_rd_intra_launches == before[0] + 1
    assert residual_kernel.launches == before[1]
    _same_rd(got, fast_intra.tu_rd_modes_plain(planes, size, nby, nbx, modes,
                                               qps, bit_inc, max_val, luma))
    _same_rd(got, fast_intra.tu_rd_modes(
        tuple(p.cpu() for p in planes), size, nby, nbx, modes.cpu(),
        tuple(q.cpu() for q in qps), bit_inc, max_val, luma))


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("is_intra", [False, True])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, -32])
def test_tu_rd_given_kernel_equals_plain(cuda, size, is_intra, bit_inc):
    s = abs(size)
    rng = np.random.RandomState(s + bit_inc + 10 * is_intra)
    n = 37
    max_val = (256 << bit_inc) - 1
    org = rng.randint(0, max_val + 1, (n, s, s))
    pred = np.clip(org + rng.randint(-40 << bit_inc, 40 << bit_inc,
                                     (n, s, s)), 0, max_val)
    pred[:3] = org[:3]                      # all-zero TUs
    org, pred = (torch.from_numpy(a.astype(np.int16)).to(cuda)
                 for a in (org, pred))
    qp = torch.from_numpy(rng.randint(6 * bit_inc, 52 + 6 * bit_inc,
                                      n).astype(np.int32)).to(cuda)
    before = (intra_rd_kernel.tu_rd_given_launches, residual_kernel.launches)
    got = fast_intra.tu_rd(org, pred, size, qp, bit_inc, max_val, is_intra)
    assert intra_rd_kernel.tu_rd_given_launches == before[0] + 1
    assert residual_kernel.launches == before[1]
    _same_rd(got, fast_intra._tq_rd(org, pred, size, qp, bit_inc, max_val,
                                    is_intra))
    _same_rd(got, fast_intra.tu_rd(org.cpu(), pred.cpu(), size, qp.cpu(),
                                   bit_inc, max_val, is_intra))


# the extremes: bit increments 0, 2, 4 and the largest the wrappers take,
# whose largest sample is that of an int16 plane
EXTREME_BIT_INCS = [0, 2, 4, intra_rd_kernel.MAX_BIT_INC]


def _max_val(bit_inc: int) -> int:
    return intra_rd_kernel.max_val_limit(bit_inc)


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", [0, 1, 2, 4, 5, 7,
                                     intra_rd_kernel.MAX_BIT_INC])
@pytest.mark.parametrize("s", [4, 8, 16, 32, 64])
def test_intra_sweep_kernel_forms_at_the_extremes(cuda, s, bit_inc):
    # every form of the Hadamard (bytes at bit_inc 0, the 16 hi + lo
    # split up to 4, butterflies above) on a ragged grid, samples at 0 and
    # max_val
    rng = np.random.RandomState(3 * s + bit_inc)
    nby, nbx = (3, 13) if s < 32 else (3, 2)
    max_val = _max_val(bit_inc)
    plane = _intra_plane(rng, nby * s + 2 * s + 1, nbx * s + 2 * s + 1,
                         bit_inc).clamp(0, max_val)
    plane[::7] = max_val
    plane[:, 3::11] = 0
    plane = plane.to(cuda)
    got = intra_rd_kernel.sweep(plane, s, nby, nbx, bit_inc, max_val)
    want = fast_intra.intra_sweep_plain(plane, s, nby, nbx, bit_inc, max_val)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", EXTREME_BIT_INCS)
@pytest.mark.parametrize("is_intra", [False, True])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, -32])
def test_tu_rd_given_kernel_at_the_extremes(cuda, size, is_intra, bit_inc):
    # every QP from 0 to 51 + 6 bit_inc, one an item; residuals at
    # +-max_val, checkerboards of both, all-zero TUs
    s = abs(size)
    rng = np.random.RandomState(s + 5 * bit_inc + 50 * is_intra)
    max_val = _max_val(bit_inc)
    qp = np.arange(52 + 6 * bit_inc)
    n = len(qp)
    org = rng.randint(0, max_val + 1, (n, s, s))
    pred = np.clip(org + rng.randint(-40 << bit_inc, 40 << bit_inc,
                                     (n, s, s)), 0, max_val)
    org[0:n:5], pred[0:n:5] = max_val, 0
    org[1:n:5], pred[1:n:5] = 0, max_val
    board = (np.indices((s, s)).sum(axis=0) % 2) * max_val
    org[2:n:5], pred[2:n:5] = board, max_val - board
    pred[3:n:5] = org[3:n:5]                     # all-zero TUs
    org, pred = (torch.from_numpy(a.astype(np.int16)).to(cuda)
                 for a in (org, pred))
    qp = torch.from_numpy(qp.astype(np.int32)).to(cuda)
    got = fast_intra.tu_rd(org, pred, size, qp, bit_inc, max_val, is_intra)
    _same_rd(got, fast_intra._tq_rd(org, pred, size, qp, bit_inc, max_val,
                                    is_intra))


@pytest.mark.gpu
@pytest.mark.parametrize("bit_inc", EXTREME_BIT_INCS)
@pytest.mark.parametrize("luma,size", [(True, 4), (True, 8), (True, 16),
                                       (True, 32), (True, 64), (False, 4),
                                       (False, 8), (False, 16),
                                       (False, -32)])
def test_tu_rd_intra_kernel_every_mode(cuda, luma, size, bit_inc):
    # all 35 modes of every block of a ragged grid, samples at 0 and
    # max_val among the ramps, a low and a high QP
    s = abs(size)
    rng = np.random.RandomState(s + 9 * bit_inc + 200 * luma)
    nby, nbx = 3, 5
    max_val = _max_val(bit_inc)
    planes = []
    for _ in range(1 if luma else 2):
        p = _intra_plane(rng, nby * s + 2 * s + 1, nbx * s + 2 * s + 1,
                         bit_inc).clamp(0, max_val)
        p[::5] = max_val
        p[:, 2::9] = 0
        planes.append(p.to(cuda))
    modes = torch.arange(35, dtype=torch.int32, device=cuda).repeat(
        nby * nbx, 1)
    qps = tuple(torch.tensor(q, device=cuda)
                for q in (4, 40 + 6 * bit_inc)[:len(planes)])
    got = fast_intra.tu_rd_modes(tuple(planes), size, nby, nbx, modes, qps,
                                 bit_inc, max_val, luma)
    _same_rd(got, fast_intra.tu_rd_modes_plain(tuple(planes), size, nby, nbx,
                                               modes, qps, bit_inc, max_val,
                                               luma))


@pytest.mark.gpu
def test_intra_rd_kernels_reject_bad_inputs(cuda):
    plane = torch.zeros((2 * 8 + 9, 2 * 8 + 9), dtype=torch.int16,
                        device=cuda)
    with pytest.raises(ValueError, match="too small"):
        intra_rd_kernel.sweep(plane[:-1].contiguous(), 8, 2, 2, 0, 255)
    with pytest.raises(TypeError):
        intra_rd_kernel.sweep(plane.to(torch.int32), 8, 2, 2, 0, 255)
    blocks = torch.zeros((4, 8, 8), dtype=torch.int16, device=cuda)
    qp = torch.zeros(4, dtype=torch.int32, device=cuda)
    tabs = (from_reference(cuda).basis(8, False),
            fast_intra._level_bits_units(cuda))
    with pytest.raises(ValueError):
        intra_rd_kernel.tu_rd_given(blocks, blocks[:3], qp, *tabs, 8, False,
                                    0, 255)
    with pytest.raises(ValueError):
        intra_rd_kernel.tu_rd_given(blocks, blocks, qp, *tabs, 8, False, 9,
                                    255)
    with pytest.raises(ValueError):
        intra_rd_kernel.tu_rd_intra((plane, plane.cpu()), torch.zeros(
            (4, 5), dtype=torch.int32, device=cuda), torch.zeros(
            40, dtype=torch.int32, device=cuda), *tabs, 8, 2, 2, False, 0,
            255)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("case", mc.CASES)
def test_mc_batch_cuda_equals_cpu(cuda, case, luma, bi, bd):
    rng = np.random.RandomState(mc.CASES.index(case) + 4 * luma + 8 * bi
                                + 16 * bd)
    top = 4 if luma else 8
    sizes = [(8, 8), (16, 16), (64, 64), (4, 16), (16, 4)] if luma \
        else [(4, 2), (2, 4), (32, 32)]
    for h, w in sizes:
        n = 1031
        rows, cols = mc.window_shape(case, luma, h, w)
        win = rng.randint(0, 1 << bd, (n, rows, cols)).astype(np.int16)
        fx = rng.randint(1, top, n) * (case in ("hor", "2d"))
        fy = rng.randint(1, top, n) * (case in ("ver", "2d"))
        args = [torch.from_numpy(a) for a in (win, fx.astype(np.int32),
                                              fy.astype(np.int32))]
        got = mc.mc_batch(*(a.to(cuda) for a in args), case, luma, bd, bi,
                          h, w)
        want = mc.mc_batch(*args, case, luma, bd, bi, h, w)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), (h, w)
        if bi:
            other = mc.mc_batch(*args, case, luma, bd, bi, h, w).flip(0)
            assert torch.equal(
                mc.bi_avg_batch(got, other.to(cuda), bd).cpu(),
                mc.bi_avg_batch(want, other, bd))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bd", [8, 10])
def test_mc_picture_kernel_equals_plain(cuda, bd, seed):
    jobs, planes, size = random_mc_jobs(np.random.RandomState(seed + bd),
                                        bd, 600)
    planes_d = [p.to(cuda) for p in planes]
    before = (mc_kernel.launches, mc.launches)
    got = mc.mc_picture(jobs, planes_d, size, bd)
    torch.cuda.synchronize()
    assert mc_kernel.launches == before[0] + 1 and mc.launches == before[1]
    assert got.device.type == "cuda"
    assert torch.equal(got, mc.mc_picture_plain(jobs, planes_d, size, bd))
    assert torch.equal(got.cpu(), mc.mc_picture_plain(jobs, planes, size,
                                                      bd))


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bi", [False, True])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("case", mc.CASES)
def test_mc_blocks_kernel_equals_plain(cuda, case, luma, bi, bd):
    rng = np.random.RandomState(mc.CASES.index(case) + 4 * luma + 8 * bi
                                + 16 * bd)
    planes = torch.from_numpy(rng.randint(0, 1 << bd, (3, 60, 70))
                              .astype(np.int16)).to(cuda)
    top = 4 if luma else 8
    sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 16),
             (16, 4), (24, 32)] if luma else [(2, 2), (4, 4), (8, 8),
                                              (32, 32), (2, 4), (4, 2)]
    for h, w in sizes:
        for n in (1, 1031):
            jobs = np.stack([rng.randint(0, 3, n),
                             rng.randint(-w - 12, 70 + 12, n),
                             rng.randint(-h - 12, 60 + 12, n),
                             rng.randint(0, top, n), rng.randint(0, top, n)],
                            axis=1).astype(np.int32)
            jobs_d = torch.from_numpy(jobs).to(cuda)
            before = (mc_kernel.blocks_launches, mc.launches)
            got = mc.mc_blocks(planes, jobs_d, case, luma, bd, bi, h, w)
            torch.cuda.synchronize()
            assert mc_kernel.blocks_launches == before[0] + 1
            assert mc.launches == before[1]
            want = mc.mc_blocks_plain(planes, jobs_d, case, luma, bd, bi, h,
                                      w)
            assert torch.equal(got, want), (h, w, n)


# the blocks entry's shapes: its compile-time sizes (luma 8-64, chroma
# 4-32, square) and shapes of its generic path, (rows, columns)
BLOCK_SHAPES = {True: [(8, 8), (16, 16), (32, 32), (64, 64), (4, 16),
                       (24, 32), (64, 8)],
                False: [(4, 4), (8, 8), (16, 16), (32, 32), (2, 4),
                        (6, 8), (12, 2)]}


def block_planes(rng, bd: int, device):
    """Plane stacks of 4 planes for the blocks entry: 16-byte copies
    (columns a multiple of 8), clamped loads only (70 columns), and a
    view whose base is not 16-byte aligned."""
    def t(shape):
        return torch.from_numpy(rng.randint(0, 1 << bd, shape)
                                .astype(np.int16)).to(device)
    return [t((4, 144, 176)), t((4, 60, 70)), t((5, 47, 72))[1:]]


def block_jobs(rng, n: int, planes, h: int, w: int, top: int, device):
    """int32 jobs [n, 5] over the first half of ``planes``, windows past
    every edge."""
    rows, cols = planes.shape[1:]
    return torch.from_numpy(np.stack([
        rng.randint(0, planes.shape[0] // 2, n),
        rng.randint(-w - 12, cols + 12, n),
        rng.randint(-h - 12, rows + 12, n), rng.randint(0, top, n),
        rng.randint(0, top, n)], axis=1).astype(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
def test_mc_blocks_pairs_and_bi_equal_plain(cuda, luma, bd):
    """The blocks entry's two-plane and bi calls (and its one-plane uni
    and 14-bit calls) against their plain forms, at every compile-time
    size and generic shape, every case, n = 1 and large, over aligned,
    unaligned-width and misaligned plane stacks, windows past every
    edge; one launch a call."""
    rng = np.random.RandomState(31 + 2 * bd + luma)
    top = 4 if luma else 8
    stacks = block_planes(rng, bd, cuda)
    calls = 0
    for h, w in BLOCK_SHAPES[luma]:
        for case in mc.CASES:
            for planes in stacks:
                other = planes.flip(0).contiguous()
                for n in ((1, 700) if case == "2d" else (37,)):
                    j0, j1 = (block_jobs(rng, n, planes, h, w, top, cuda)
                              for _ in range(2))
                    for pair in (False, True):
                        for mode in ("pixels", "14 bits", "bi"):
                            kw = dict(pair=pair)
                            if mode == "bi":
                                kw.update(planes1=other, jobs1=j1)
                            bi = mode != "pixels"
                            before = (mc_kernel.launches,
                                      mc_kernel.blocks_launches, mc.launches)
                            got = mc.mc_blocks(planes, j0, case, luma, bd, bi,
                                               h, w, **kw)
                            torch.cuda.synchronize()
                            assert (mc_kernel.launches,
                                    mc_kernel.blocks_launches,
                                    mc.launches) == (before[0],
                                                     before[1] + 1, before[2])
                            want = mc.mc_blocks_plain(planes, j0, case, luma,
                                                      bd, bi, h, w, **kw)
                            assert got.shape == want.shape
                            assert torch.equal(got, want), (
                                h, w, case, tuple(planes.shape), n, pair,
                                mode)
                            calls += 1
    assert calls == len(BLOCK_SHAPES[luma]) * 5 * 3 * 6


@pytest.mark.gpu
def test_mc_blocks_at_a_1080p_b_frames_shapes(cuda):
    """The P/B pass's blocks calls at 1080p: every block of a size class
    over padded reference stacks (2 references), luma and the Cb/Cr
    pair, uni in pixels and bi averaged, against the plain forms."""
    rng = np.random.RandomState(77)
    from thevc_tpu_torch.encoder.fast_inter import PAD_C, PAD_FULL
    hp, wp = 1088, 1920
    y = [torch.from_numpy(rng.randint(0, 256, (2, hp + 2 * PAD_FULL,
                                               wp + 2 * PAD_FULL))
                          .astype(np.int16)).to(cuda) for _ in range(2)]
    c = [torch.from_numpy(rng.randint(0, 256, (4, hp // 2 + 2 * PAD_C,
                                               wp // 2 + 2 * PAD_C))
                          .astype(np.int16)).to(cuda) for _ in range(2)]
    for s in (8, 16, 32, 64):
        n = (hp // s) * (wp // s)
        for luma, planes, size, top, pair in ((True, y, s, 4, False),
                                              (False, c, s // 2, 8, True)):
            rows, cols = planes[0].shape[1:]
            jobs = [torch.from_numpy(np.stack([
                rng.randint(0, 2, n), rng.randint(0, cols - size - 8, n),
                rng.randint(0, rows - size - 8, n), rng.randint(0, top, n),
                rng.randint(0, top, n)], axis=1).astype(np.int32)).to(cuda)
                for _ in range(2)]
            for kw in (dict(), dict(planes1=planes[1], jobs1=jobs[1])):
                bi = bool(kw)
                got = mc.mc_blocks(planes[0], jobs[0], "2d", luma, 8, bi,
                                   size, size, pair=pair, **kw)
                want = mc.mc_blocks_plain(planes[0], jobs[0], "2d", luma, 8,
                                          bi, size, size, pair=pair, **kw)
                assert torch.equal(got, want), (s, luma, bi)


@pytest.mark.gpu
def test_mc_blocks_rejects_bad_pairs_and_lists(cuda):
    planes = torch.zeros((3, 40, 40), dtype=torch.int16, device=cuda)
    even = torch.zeros((4, 40, 40), dtype=torch.int16, device=cuda)
    jobs = torch.zeros((5, 5), dtype=torch.int32, device=cuda)
    before = mc_kernel.blocks_launches
    for args, kw in [((planes, jobs, "2d", False, 8, False, 4, 4),
                      dict(pair=True)),                 # odd plane count
                     ((even, jobs, "2d", True, 8, True, 8, 8),
                      dict(jobs1=jobs)),                # no planes1
                     ((even, jobs, "2d", True, 8, False, 8, 8),
                      dict(planes1=even, jobs1=jobs)),  # not bi
                     ((even, jobs, "2d", True, 8, True, 8, 8),
                      dict(planes1=even[:, :20], jobs1=jobs)),
                     ((even, jobs, "2d", True, 8, True, 8, 8),
                      dict(planes1=even, jobs1=jobs[:4]))]:
        with pytest.raises(ValueError):
            mc_kernel.blocks(*args, **kw)
    assert mc_kernel.blocks_launches == before


# skewed mixes of a picture's jobs: (luma PU sizes, kinds)
MC_MIXES = {"small": ([(8, 4), (4, 8)], None),
            "large": ([(64, 64)], None),
            "bi_heavy": (None, ("bi", "bi", "bi", "uni")),
            "weighted_bi": (None, ("wbi",))}


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("mix", sorted(MC_MIXES))
def test_mc_picture_skewed_mixes_in_any_order(cuda, mix, bd):
    """The picture entry on job tables of one skewed size or kind mix,
    in the order drawn and shuffled, against the plain form."""
    sizes, kinds = MC_MIXES[mix]
    rng = np.random.RandomState(sorted(MC_MIXES).index(mix) + 10 * bd)
    jobs, planes, size = random_mc_jobs(rng, bd, 500, sizes=sizes,
                                        kinds=kinds)
    planes_d = [p.to(cuda) for p in planes]
    want = mc.mc_picture_plain(jobs, planes_d, size, bd)
    for order in (np.arange(len(jobs)), rng.permutation(len(jobs))):
        before = mc_kernel.launches
        got = mc.mc_picture(jobs[order], planes_d, size, bd)
        torch.cuda.synchronize()
        assert mc_kernel.launches == before + 1
        assert torch.equal(got, want), mix


@pytest.mark.gpu
def test_mc_kernels_reject_bad_inputs(cuda):
    jobs, planes, size = random_mc_jobs(np.random.RandomState(3), 8, 20)
    planes_d = [p.to(cuda) for p in planes]
    with pytest.raises(ValueError):
        mc_kernel.picture(jobs, planes, size, 8)          # CPU planes
    with pytest.raises(ValueError):
        mc_kernel.picture(jobs, planes_d, 10, 8)          # writes past
    with pytest.raises(ValueError):
        mc_kernel.picture(jobs, planes_d[:1], size, 8)    # plane index
    with pytest.raises(ValueError):
        mc_kernel.picture(jobs[:, :-1], planes_d, size, 8)
    with pytest.raises(ValueError):
        mc_kernel.picture(jobs, planes_d, size, 7)
    with pytest.raises(TypeError):
        mc_kernel.picture(jobs, [p.int() for p in planes_d], size, 8)
    stack = torch.zeros((2, 40, 40), dtype=torch.int16, device=cuda)
    blk = torch.zeros((5, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mc_kernel.blocks(stack, blk, "diag", True, 8, False, 8, 8)
    with pytest.raises(ValueError):
        mc_kernel.blocks(stack, blk, "2d", True, 8, False, 65, 8)
    with pytest.raises(ValueError):
        mc_kernel.blocks(stack, blk[:, :4].contiguous(), "2d", True, 8,
                         False, 8, 8)
    with pytest.raises(TypeError):
        mc_kernel.blocks(stack, blk.long(), "2d", True, 8, False, 8, 8)
    with pytest.raises(ValueError):
        mc_kernel.blocks(stack.cpu(), blk.cpu(), "2d", True, 8, False, 8, 8)


def qpel_origins(rng, n: int, rows: int, cols: int, s: int, edge: bool):
    """int32 origins [n, 3] of the quarter-pel entry over 2 planes of rows
    x cols: windows inside the planes where they fit, or (``edge``)
    reaching up to 2 s + 12 past every edge."""
    if edge:
        x = rng.randint(-2 * s - 12, cols + 12, n)
        y = rng.randint(-2 * s - 12, rows + 12, n)
    else:
        x = rng.randint(1, max(2, cols - s - 7), n)
        y = rng.randint(1, max(2, rows - s - 7), n)
    return np.stack([rng.randint(0, 2, n), x, y], axis=1).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", mc_kernel.QPEL_SIZES)
def test_mc_qpel_kernel_equals_plain(cuda, s, bd):
    rng = np.random.RandomState(7 * s + bd)
    # a padded 1080p plane pair (columns a multiple of 8: 16-byte loads),
    # a plane pair of 70 columns (clamped loads only) and one whose base is
    # not 16-byte aligned (a view into a stack of 3)
    big = torch.from_numpy(rng.randint(0, 1 << bd, (2, 1248, 2080))
                           .astype(np.int16)).to(cuda)
    odd = torch.from_numpy(rng.randint(0, 1 << bd, (2, 90, 70))
                           .astype(np.int16)).to(cuda)
    off = torch.from_numpy(rng.randint(0, 1 << bd, (3, 81, 88))
                           .astype(np.int16)).to(cuda)[1:]
    full = (1088 // s) * (1920 // s)
    cases = [(big, 1, True), (big, 13, False), (big, 1031, True),
             (big, full, False), (odd, 1, False), (odd, 517, True),
             (off, 13, True), (off, 300, False)]
    for planes, n, edge in cases:
        rows, cols = planes.shape[1:]
        origins = torch.from_numpy(qpel_origins(rng, n, rows, cols, s,
                                                edge)).to(cuda)
        got = mc.mc_qpel(planes, origins, s, bd)
        torch.cuda.synchronize()
        assert got.shape == (n, 49, s, s)
        want = mc.mc_qpel_plain(planes, origins, s, bd)
        assert torch.equal(got, want), (tuple(planes.shape), n, edge)


@pytest.mark.gpu
def test_mc_qpel_kernel_counts_and_rejects_bad_inputs(cuda):
    planes = torch.zeros((2, 40, 48), dtype=torch.int16, device=cuda)
    origins = torch.from_numpy(qpel_origins(np.random.RandomState(5), 9, 40,
                                            48, 8, True)).to(cuda)
    before = (mc_kernel.launches, mc_kernel.qpel_launches, mc.launches)
    mc.mc_qpel(planes, origins, 8, 8)
    mc_kernel.qpel(planes, origins, 16, 10)
    torch.cuda.synchronize()
    assert (mc_kernel.launches, mc_kernel.qpel_launches, mc.launches) == (
        before[0], before[1] + 2, before[2])
    for bad in [(planes.cpu(), origins.cpu(), 8, 8),      # CPU tensors
                (planes, origins.cpu(), 8, 8),            # mixed devices
                (planes, origins, 12, 8),                 # block size
                (planes, origins, 4, 8),
                (planes, origins, 8, 7),                  # bit depth
                (planes, origins[:, :2].contiguous(), 8, 8),
                (planes, origins.long(), 8, 8),           # dtype
                (planes, origins.float(), 8, 8),
                (planes.int(), origins, 8, 8),
                (planes[0], origins, 8, 8)]:              # planes' shape
        with pytest.raises(ValueError):
            mc_kernel.qpel(*bad)
    assert mc_kernel.qpel_launches == before[1] + 2


@pytest.mark.gpu
def test_inter_decode_cuda_equals_cpu(cuda, tmp_path):
    from thevc_tpu_torch import native
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.decoder.top import Decoder
    assert native.get_lib() is not None
    clip = tmp_path / "motion_416x240.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(clip), "--width", "416", "--height", "240",
                    "--frames", "5", "--seed", "1234", "--style", "motion"],
                   check=True, capture_output=True)
    stream = tmp_path / "ldb.bin"
    streams.encode(clip, stream, tmp_path / "ldb_rec.yuv", 416, 240, 5,
                   cfg=REPO / "tests" / "cfg" / "encoder_lowdelay_tlayers.cfg",
                   extra=("--QP=32",))
    data = stream.read_bytes()
    from thevc_tpu_torch.decoder import inter
    before = residual_kernel.launches
    mc.launches = mc_kernel.launches = 0
    real, inter_pics = inter._jobs, []

    def spy(*args):
        inter_pics.append(1)            # a picture with inter PUs
        return real(*args)
    inter._jobs = spy
    try:
        pics_cuda = Decoder(cuda).decode_stream(data)
    finally:
        inter._jobs = real
    # one MC kernel launch a picture with inter PUs, no plain MC
    assert residual_kernel.launches > before and mc.launches == 0
    assert mc_kernel.launches == len(inter_pics) == 4
    pics_cpu = Decoder("cpu").decode_stream(data)
    assert mc.launches > 0
    assert len(pics_cuda) == len(pics_cpu) == 5
    for a, b in zip(pics_cuda, pics_cpu):
        assert a.poc == b.poc and a.digest_ok and b.digest_ok
        for pa, pb in zip(a.frame.planes(), b.frame.planes()):
            assert np.array_equal(pa, pb)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 63, 4099])
@pytest.mark.parametrize("size", [8, 16, 32, 64])
def test_satd_kernel_49_candidates_equals_plain(cuda, size, n):
    """The quarter-pel refinement's shape: 49 candidates per PU."""
    rng = np.random.RandomState(size + n)
    org = torch.from_numpy(rng.randint(0, 256, (n, size, size)).astype(
        np.int16)).to(cuda)
    preds = torch.from_numpy(rng.randint(0, 256, (n, 49, size, size)).astype(
        np.int16)).to(cuda)
    before = satd_kernel.launches
    got = satd.satd_blocks(org, preds, 0)
    torch.cuda.synchronize()
    assert satd_kernel.launches == before + 1
    assert tuple(got.shape) == (n, 49)
    assert torch.equal(got, satd.satd_plain(org, preds, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_tu_recon_pipeline_inter_on_cuda_equals_plain(cuda, size):
    """Inter TUs: the DCT at 4x4 and the inter quant offset, as the P/B
    pass's ``_tq_rd(is_intra=False)`` makes them; and that function on
    CUDA against the CPU."""
    rng = np.random.RandomState(40 + size)
    n = 777
    org = torch.from_numpy(rng.randint(0, 256, (n, size, size)).astype(
        np.int32))
    pred = (org + torch.from_numpy(rng.randint(-60, 61, (n, size, size))
                                   .astype(np.int32))).clamp(0, 255)
    qp = torch.from_numpy(rng.randint(0, 52, n).astype(np.int32))
    levels, _ = tq.quant(tq.forward_transform(org - pred, False, 0), qp,
                         False, 0)
    args = [a.to(cuda) for a in (pred, levels, qp)]
    before = residual_kernel.launches
    got = tq.tu_recon_pipeline(*args, False, 0, 255)
    torch.cuda.synchronize()
    assert residual_kernel.launches == before + 1
    assert torch.equal(got, tq.tu_recon_pipeline_plain(*args, False, 0, 255))
    for tsize in ((size, -32) if size == 32 else (size,)):
        got = fast_intra._tq_rd(org.to(cuda), pred.to(cuda), tsize,
                                qp.to(cuda), 0, 255, is_intra=False)
        want = fast_intra._tq_rd(org, pred, tsize, qp, 0, 255,
                                 is_intra=False)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def _motion_frames(tmp_path, w, h, n):
    clip = tmp_path / f"motion_{w}x{h}.yuv"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(clip), "--width", str(w), "--height", str(h),
                    "--frames", str(n), "--seed", "1234", "--style",
                    "motion"], check=True, capture_output=True)
    raw = np.fromfile(clip, np.uint8).astype(np.int16)
    size = w * h * 3 // 2
    frames = []
    for i in range(n):
        f = raw[i * size:(i + 1) * size]
        frames.append((f[:w * h].reshape(h, w),
                       f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                       f[w * h * 5 // 4:].reshape(h // 2, w // 2)))
    return clip, frames


@pytest.mark.gpu
@pytest.mark.parametrize("b_slice", [False, True])
def test_decide_frame_p_cuda_equals_cpu(cuda, tmp_path, b_slice):
    from thevc_tpu.encoder.rdcost import chroma_weight, slice_lambda_and_qp
    from thevc_tpu.ops.transforms import qp_scaled
    w, h = 416, 240
    _clip, f = _motion_frames(tmp_path, w, h, 3)
    refs = [(1, *f[1]), (0, *f[0])]
    refs1 = [(0, *f[0]), (1, *f[1])] if b_slice else None
    for qp in (27, 37):
        lam, _ = slice_lambda_and_qp(qp, False, 1, 0.57, 0, True, 0)
        qpc = qp_scaled(qp, False, 0)
        args = (*f[2], refs, w, h, qp, qpc, qpc, lam, lam ** 0.5, lam ** 0.5,
                (1.0, 2.0, 5.5), (0.5, 3.5, chroma_weight(qp)), 4, 2, 64, 64,
                0, 255)
        before = (satd_kernel.launches, residual_kernel.launches,
                  mc_kernel.blocks_launches, mc.launches,
                  mc_kernel.qpel_launches, intra_rd_kernel.sweep_launches,
                  intra_rd_kernel.tu_rd_intra_launches,
                  intra_rd_kernel.tu_rd_given_launches)
        maps_cuda = fast_inter.decide_frame_p(*args, ref_pics_l1=refs1,
                                              device=cuda)
        # K2 for the quarter-pel candidates; the intra leaves and every
        # transform-RD estimate on the intra decision kernels, no K1
        assert satd_kernel.launches > before[0]
        assert residual_kernel.launches == before[1]
        assert intra_rd_kernel.sweep_launches > before[5]
        assert intra_rd_kernel.tu_rd_intra_launches > before[6]
        assert intra_rd_kernel.tu_rd_given_launches > before[7]
        # the pass's MC is the kernel's: no plain MC on the card
        assert mc_kernel.blocks_launches > before[2] \
            and mc.launches == before[3]
        assert mc_kernel.qpel_launches > before[4]
        maps_cpu = fast_inter.decide_frame_p(*args, ref_pics_l1=refs1,
                                             device="cpu")
        assert len(maps_cuda) == (14 if b_slice else 10)
        for a, b in zip(maps_cuda, maps_cpu):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg,extra", [
    ("encoder_lowdelay_P_main.cfg", "--wpP=1"),
    ("encoder_lowdelay_tlayers.cfg", "--wpB=1"),
    ("encoder_intra_main.cfg", "--ScalingList=1"),
    ("encoder_lowdelay_tlayers.cfg", "--ScalingList=1")])
def test_wp_and_scaling_decode_cuda_equals_cpu(cuda, tmp_path, cfg, extra):
    from thevc_tpu_torch import native
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.decoder.top import Decoder
    assert native.get_lib() is not None
    clip, _f = _motion_frames(tmp_path, 64, 64, 3)
    stream = tmp_path / "s.bin"
    streams.encode(clip, stream, tmp_path / "s_rec.yuv", 64, 64, 3,
                   cfg=REPO / "tests" / "cfg" / cfg,
                   extra=(extra, "--QP=32"))
    data = stream.read_bytes()
    before = (mc_kernel.launches, mc.launches)
    pics_cuda = Decoder(cuda).decode_stream(data)
    assert mc.launches == before[1]
    assert (mc_kernel.launches > before[0]) == ("intra" not in cfg)
    pics_cpu = Decoder("cpu").decode_stream(data)
    assert len(pics_cuda) == len(pics_cpu) == 3
    for a, b in zip(pics_cuda, pics_cpu):
        assert a.digest_ok and b.digest_ok
        for pa, pb in zip(a.frame.planes(), b.frame.planes()):
            assert np.array_equal(pa, pb)


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
def test_device_apply_replay_equals_eager_and_cpu(cuda, use_rdoq):
    """The fast-RD device apply of a 128x64 frame: the frame kernel (one
    launch), the plain form replayed as CUDA graphs and eager on
    ``cuda``, and the CPU, the same recon and level stacks (tolerance 0);
    the apply kernel counted once, the residual kernel (the plain form's)
    not by the kernel apply; the kernel form refuses graph replay."""
    from thevc_tpu_torch.cabac import contexts as cc
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.ops import apply_kernel
    rng = np.random.RandomState(29)
    w, h, qp = 128, 64, 27
    planes = [np.clip(np.add.outer(np.arange(hh) * 3, np.arange(ww) * 2)
                      % 256 + rng.randint(-40, 41, (hh, ww)), 0,
                      255).astype(np.int16)
              for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    lam = 0.57 * 2 ** ((qp - 12) / 3)
    maps = fast_intra.decide_frame(*planes, w, h, qp, qp, qp, lam,
                                   lam ** 0.5, (2.0, 3.0, 6.0),
                                   (1.0, 3.0, 1.0), 3, 2, 64, 0, 255,
                                   device="cpu")
    sched = fast_apply.build_schedule(*maps[:4], w, h, 64, 3, 2)
    args = (*planes, sched, w, h, qp, qp, qp, 64, 0, 255, True, use_rdoq,
            lam, lam, cc.make_context_states_idx(0, qp))
    with pytest.raises(ValueError, match="one launch a frame"):
        fast_apply.run_device_apply(*args, device=cuda, replay=True)
    outs = {}
    for name, device, plain, replay in (("cpu", "cpu", False, False),
                                        ("kernel", cuda, False, False),
                                        ("graph", cuda, True, True),
                                        ("eager", cuda, True, False)):
        before = (apply_kernel.launches, residual_kernel.launches)
        run = fast_apply.run_device_apply(*args, device=device,
                                          replay=replay, plain=plain)
        outs[name] = fast_apply.collect_device_apply(run)
        assert apply_kernel.launches - before[0] == (name == "kernel")
        if name == "kernel":
            assert residual_kernel.launches == before[1]
            assert run.state.tolist()[1] == 0
    for name in ("kernel", "graph", "eager"):
        got, want = outs[name], outs["cpu"]
        for g, e in zip(got[:3] + got[3] + got[4],
                        want[:3] + want[3] + want[4]):
            assert (g is None and e is None) or np.array_equal(g, e), name


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
def test_device_apply_nxn_classes_on_cuda(cuda, use_rdoq):
    """The device apply on maps with NxN CUs, so that every class of
    ``fast_apply.CLS`` runs, the 4x4 luma DST class (4, True, True)
    included: the frame kernel (one launch, every class in it) and the
    plain form replayed as CUDA graphs on ``cuda``, equal to the CPU
    (tolerance 0)."""
    from thevc_tpu_torch.cabac import contexts as cc
    from thevc_tpu_torch.encoder import fast_apply
    from thevc_tpu_torch.ops import apply_kernel
    from thevc_tpu_torch.streams import nxn_frame
    w, h, qp = 128, 64, 32
    planes, maps = nxn_frame(np.random.RandomState(24), w, h)
    assert maps[2].any()
    sched = fast_apply.build_schedule(*maps, w, h, 64, 3, 2)
    assert sched is not None
    steps = [int((np.diff(o) > 0).sum()) for o in sched.offs]
    # every class ran, the 4x4 luma (DST) class included
    assert all(sched.counts) and all(steps), (sched.counts, steps)
    assert fast_apply.CLS[0] == (4, True, True)
    lam = 0.57 * 2 ** ((qp - 12) / 3)
    args = (*planes, sched, w, h, qp, qp - 1, qp - 2, 64, 0, 255, True,
            use_rdoq, lam, lam / 1.2, cc.make_context_states_idx(0, qp))
    outs = {}
    for name, device, plain in (("cpu", "cpu", False),
                                ("kernel", cuda, False),
                                ("graph", cuda, True)):
        before = (apply_kernel.launches, residual_kernel.launches)
        run = fast_apply.run_device_apply(*args, device=device, plain=plain)
        outs[name] = fast_apply.collect_device_apply(run)
        assert run.n_waves == sched.n_waves
        assert apply_kernel.launches - before[0] == (name == "kernel")
        if name == "kernel":
            assert residual_kernel.launches == before[1]
            assert run.state.tolist()[1] == 0
    for name in ("kernel", "graph"):
        got, want = outs[name], outs["cpu"]
        for g, e in zip(got[:3] + got[3] + got[4],
                        want[:3] + want[3] + want[4]):
            assert (g is None and e is None) or np.array_equal(g, e), name


@pytest.mark.gpu
def test_graft_entry_on_cuda_equals_plain(cuda):
    from thevc_tpu_torch import graft_entry
    step, args = graft_entry.entry("cuda")
    assert all(a.device.type == "cuda" for a in args)
    before = residual_kernel.launches
    out = step(*args)
    torch.cuda.synchronize()
    assert residual_kernel.launches == before + 1
    assert torch.equal(out, tq.tu_recon_pipeline_plain(
        *args, use_dst=False, bit_increment=0, max_val=255))
    cpu_step, cpu_args = graft_entry.entry("cpu")
    assert torch.equal(out.cpu(), cpu_step(*cpu_args))


@pytest.mark.gpu
def test_one_rank_nccl_pool(cuda):
    from thevc_tpu_torch import graft_entry
    got = graft_entry.one_rank_pool("cuda:0")
    assert got["total"] == got["spent"] and got["device"] == "cuda:0"
    # a pool of one slot steers as that slot's own pool would
    assert got["frame_qp"] == graft_entry.local_qps([got["spent"]])[0]


@pytest.mark.gpu
def test_gloo_dryrun_eight_slots_on_one_card(cuda):
    from thevc_tpu_torch import graft_entry
    report = graft_entry.dryrun_multichip(8, "gloo", ["cuda:0"] * 8)
    assert report["pictures"] == report["digests_ok"] == 16
    assert report["sharded_decoded"] == 2
    assert report["qp_history"][1] != report["local_qps"]
    for s in report["slot_reports"]:
        assert s["device"] == "cuda:0" and not s["foreign_modules"]
        # the all-intra encode's decision passes run on the intra
        # decision kernels, the decode on K1
        assert s["launches"]["encode"]["intra_sweep"] > 0
        assert s["launches"]["encode"]["tu_rd"] > 0
        assert s["launches"]["decode"]["residual"] > 0
    # the slots' streams on the card are the CPU's, byte for byte
    host = graft_entry.dryrun_multichip(8, "gloo", ["cpu"] * 8)
    for key in ("qp_history", "spent_history", "stream_sha256"):
        assert report[key] == host[key], key


@pytest.fixture
def eight_cards(cuda):
    if torch.cuda.device_count() < 8:
        pytest.skip(f"the NCCL dry run needs 8 CUDA cards; found "
                    f"{torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(8)]


@pytest.mark.gpu
def test_nccl_dryrun_eight_cards(eight_cards):
    from thevc_tpu_torch import graft_entry
    report = graft_entry.dryrun_multichip(8, "nccl", eight_cards)
    assert report["pictures"] == report["digests_ok"] == 16
    assert report["devices"] == eight_cards and report["cards"] == 8
    assert report["qp_history"][1] != report["local_qps"]


@pytest.mark.gpu
def test_tool_streams_decode_on_cuda(cuda, tmp_path):
    from thevc_tpu_torch import native, streams
    from thevc_tpu_torch.decoder.top import Decoder
    assert native.get_lib() is not None
    made = streams.tool_streams(tmp_path)
    for name, (stream, rec, frames) in made.items():
        before = residual_kernel.launches
        pics = Decoder(cuda).decode_stream(stream.read_bytes())
        assert len(pics) == frames, name
        assert all(p.digest_ok is True for p in pics), name
        got = b"".join(pl.astype(np.uint8).tobytes() for p in pics
                       for pl in p.frame.planes())
        assert got == rec.read_bytes(), name
        assert residual_kernel.launches > before, name


@pytest.mark.gpu
def test_robust_and_fuzz_decode_cuda_equals_cpu(cuda, tmp_path):
    from thevc_tpu_torch import native, streams
    assert native.get_lib() is not None
    from thevc_tpu_torch.decoder import inter
    made = streams.robust_streams(tmp_path)
    before = residual_kernel.launches
    put, puts = inter.RefPlanes.put, []

    def spy(refs, pic, planes):
        puts.append(pic.poc)
        return put(refs, pic, planes)
    for case in streams.ROBUST_CASES:
        data, options, pocs = streams.robust_case(made, case)
        if case == "conceal":
            inter.RefPlanes.put = spy
        try:
            got, _ = streams.decode_outcome(data, cuda, options)
        finally:
            inter.RefPlanes.put = put
        if case == "conceal":
            # the concealed POC 2 reaches the card once, when POC 3 asks
            assert sorted(puts) == pocs
            assert puts.index(2) == puts.index(1) + 1
        assert not isinstance(got, str), (case, got)
        assert [p[0] for p in got] == pocs, case
        assert streams.same_outcome(
            got, streams.decode_outcome(data, "cpu", options)[0]), case
    assert residual_kernel.launches > before
    ra = made["ra"][0].read_bytes()
    for k, buf in enumerate(streams.fuzz_variants(ra, 12)):
        got, text = streams.decode_outcome(buf, cuda)
        assert "CUDA" not in text, (k, got, text)
        assert streams.same_outcome(got, streams.decode_outcome(buf)[0]), k
    # no CUDA error stuck: the clean stream decodes exactly
    clean, _ = streams.decode_outcome(ra, cuda)
    assert len(clean) == 9 and all(d is True for _p, d, _l in clean)


@pytest.mark.gpu
def test_resumed_fastrd_encode_on_cuda_equals_uninterrupted(cuda, tmp_path):
    import contextlib
    import io
    from thevc_tpu_torch import streams
    from thevc_tpu_torch.apps.encoder import main
    clip = streams.make_clip(tmp_path / "clip_96x80_9f.yuv", 96, 80, 9)
    ck = tmp_path / "state.pkl"

    def run(name, device, *extra):
        with contextlib.redirect_stdout(io.StringIO()):
            main(["-c", str(REPO / "tests" / "cfg" /
                            "encoder_lowdelay_P_main.cfg"),
                  "-i", str(clip), "-wdt", "96", "-hgt", "80", "-fr", "30",
                  "--SEIpictureDigest=1", "--FastRD=1", "--device", device,
                  "-b", str(tmp_path / f"{name}.bin"),
                  "-o", str(tmp_path / f"{name}.yuv"), *extra])
        return [(tmp_path / f"{name}.{x}").read_bytes()
                for x in ("bin", "yuv")]
    full = run("full", str(cuda), "-f", "9")
    before = satd_kernel.launches
    run("joined", str(cuda), "-f", "5", f"--CheckpointFile={ck}",
        "--CheckpointEvery=1")
    joined = run("joined", str(cuda), "-f", "9", f"--ResumeFile={ck}")
    assert satd_kernel.launches > before
    assert joined == full
    assert run("cpu", "cpu", "-f", "9") == full
