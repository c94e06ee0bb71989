"""The hand-written CUDA kernels (residual, dense and CG-packed; SATD)
against their plain versions, also at the shapes of the P/B fast-RD pass
(SATD over 49 quarter-pel candidates, inter TUs), the fast-RD decision
passes, motion compensation and the P/B decode (weighted prediction and
scaling lists included) on CUDA against the CPU, on a CUDA card.

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
from thevc_tpu_torch.ops import mc, residual_kernel, satd, satd_kernel, tq

REPO = Path(__file__).resolve().parents[1]
CASES = [(4, False, 0), (4, True, 0), (8, False, 0), (16, False, 0),
         (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2)]


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
    for qp in (27, 32, 37):
        lam, _ = slice_lambda_and_qp(qp, True, 1, 0.57, 0, True, 0)
        qpc = qp_scaled(qp, False, 0)
        args = (y, cb, cr, w, h, qp, qpc, qpc, lam, lam ** 0.5,
                (1.0, 2.0, 5.5), (0.5, 3.5, chroma_weight(qp)), 4, 2, 64, 0,
                255)
        before = (satd_kernel.launches, residual_kernel.launches)
        maps_cuda = fast_intra.decide_frame(*args, device=cuda)
        assert satd_kernel.launches > before[0]
        assert residual_kernel.launches > before[1]
        maps_cpu = fast_intra.decide_frame(*args, device="cpu")
        for a, b in zip(maps_cuda, maps_cpu):
            assert a.dtype == b.dtype and np.array_equal(a, b)


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
    before = residual_kernel.launches
    mc.launches = 0
    pics_cuda = Decoder(cuda).decode_stream(data)
    assert residual_kernel.launches > before and mc.launches > 0
    pics_cpu = Decoder("cpu").decode_stream(data)
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
        before = (satd_kernel.launches, residual_kernel.launches)
        maps_cuda = fast_inter.decide_frame_p(*args, ref_pics_l1=refs1,
                                              device=cuda)
        assert satd_kernel.launches > before[0]
        assert residual_kernel.launches > before[1]
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
    pics_cuda = Decoder(cuda).decode_stream(data)
    pics_cpu = Decoder("cpu").decode_stream(data)
    assert len(pics_cuda) == len(pics_cpu) == 3
    for a, b in zip(pics_cuda, pics_cpu):
        assert a.digest_ok and b.digest_ok
        for pa, pb in zip(a.frame.planes(), b.frame.planes()):
            assert np.array_equal(pa, pb)


@pytest.mark.gpu
@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
def test_device_apply_replay_equals_eager_and_cpu(cuda, use_rdoq):
    """The fast-RD device apply of a 128x64 frame: replayed as CUDA
    graphs, eager on ``cuda`` and on the CPU, the same recon and level
    stacks (tolerance 0), and the residual kernel counted once per
    launch: eager, in each replay, and in the warm-up step before each
    capture (the capture itself launches nothing)."""
    from thevc_tpu_torch.cabac import contexts as cc
    from thevc_tpu_torch.encoder import fast_apply
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
    outs = {}
    for name, device, replay in (("cpu", "cpu", False),
                                 ("eager", cuda, False),
                                 ("graph", cuda, True)):
        before = residual_kernel.launches
        run = fast_apply.run_device_apply(*args, device=device,
                                          replay=replay)
        outs[name] = fast_apply.collect_device_apply(run)
        if name != "cpu":
            per_step = [1 if luma else 2 for _, luma, _ in fast_apply.CLS]
            steps = [int((np.diff(o) > 0).sum()) for o in sched.offs]
            warm_up = sum(k for k, n in zip(per_step, steps) if n)
            assert residual_kernel.launches - before == sum(
                k * n for k, n in zip(per_step, steps)) \
                + (warm_up if replay else 0)
    for name in ("eager", "graph"):
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
        assert s["launches"]["encode"]["residual"] > 0
        assert s["launches"]["encode"]["satd"] > 0
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
