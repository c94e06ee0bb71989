"""The port's fast-RD intra decision pass against the JAX package's, on
the CPU.

Two seeded frames go through both packages with the same inputs: the
96x80 frame of tests/test_device_path.py and the first frame of a
416x240 clip from tools/make_test_clip.py at QP 32.  The integer stages
(reference lines, all 35 predictions, SATDs, MPMs, the RD distortion)
must be equal; the float32 bit estimates agree within rtol 1e-5 (XLA's
log2, sum order and fused multiply-adds differ from torch's in the last
bits); the six decision maps agree on at least 99.9% of the 4x4 units of
each plane.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import REPO
from thevc_tpu.encoder import fast_intra as ref
from thevc_tpu.encoder.rdcost import chroma_weight, slice_lambda_and_qp
from thevc_tpu.ops import transforms as tops
from thevc_tpu.ops.intra import HOR_IDX, INTRA_FILTER_THRESH, VER_IDX
from thevc_tpu_torch.encoder import fast_intra as port
from thevc_tpu_torch.ops.satd import satd_blocks

SIZES = (4, 8, 16, 32, 64)
BIT_RTOL = 1e-5


def _frame_96x80():
    rng = np.random.RandomState(5)
    y = rng.randint(0, 255, (80, 96)).astype(np.int16)
    yy, xx = np.mgrid[0:80, 0:96]
    y = ((y // 4 + xx * 2 + yy) % 255).astype(np.int16)
    cb = rng.randint(0, 255, (40, 48)).astype(np.int16)
    cr = rng.randint(0, 255, (40, 48)).astype(np.int16)
    return (y, cb, cr, 96, 80, 32, 30, 30, 57.0, 7.55, (1.0, 2.0, 5.5),
            (0.5, 3.5, 1.1), 4, 2, 64, 0, 255)


def _frame_416x240(path):
    subprocess.run([sys.executable, str(REPO / "tools" / "make_test_clip.py"),
                    str(path), "--width", "416", "--height", "240",
                    "--frames", "1"], check=True, capture_output=True)
    w, h, qp = 416, 240, 32
    raw = np.fromfile(path, np.uint8).astype(np.int16)
    y = raw[:w * h].reshape(h, w)
    cb = raw[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
    cr = raw[w * h * 5 // 4:w * h * 3 // 2].reshape(h // 2, w // 2)
    lam, _ = slice_lambda_and_qp(qp, True, 1, 0.57, 0, True, 0)
    qp_c = tops.qp_scaled(qp, False, 0)
    return (y, cb, cr, w, h, qp, qp_c, qp_c, lam, lam ** 0.5,
            (1.0, 2.0, 5.5), (0.5, 3.5, chroma_weight(qp)), 4, 2, 64, 0,
            255)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    clip = tmp_path_factory.mktemp("fast_intra") / "clip_416x240.yuv"
    return {"96x80": _frame_96x80(), "416x240_q32": _frame_416x240(clip)}


def _padded_luma(args):
    """The padded luma plane of dispatch_frame, and its block grid."""
    y, width, height, ctu = args[0], args[3], args[4], args[14]
    wp = -(-width // ctu) * ctu
    hp = -(-height // ctu) * ctu
    pad = 2 * ctu
    ppad = np.pad(y, ((1, hp - height + pad), (1, wp - width + pad)),
                  mode="edge").astype(np.int32)
    return ppad, wp, hp


def _lines_and_preds(args, s):
    """Reference lines, source blocks and all 35 predictions of size
    class ``s``, from both packages (JAX's unified form)."""
    ppad, wp, hp = _padded_luma(args)
    nby, nbx = hp // s, wp // s
    max_val = args[16]
    # planar reads the filtered lines where mode 0 is farther than the
    # threshold from both pure directions (fast_intra.py:429)
    filt = min(HOR_IDX, VER_IDX) > INTRA_FILTER_THRESH[s.bit_length() - 1]
    ra_j, rl_j = ref._gather_lines(jnp.asarray(ppad), s, nby, nbx)
    ra_p, rl_p = port._gather_lines(torch.from_numpy(ppad), s, nby, nbx)
    out = {"lines": ((ra_j, rl_j), (ra_p, rl_p))}

    @jax.jit
    def jax_preds(ra, rl):
        def smooth(a, other):
            mid = (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2
            corner = (other[:, 1] + 2 * a[:, 0] + a[:, 1] + 2) >> 2
            return jnp.concatenate([corner[:, None], mid, a[:, -1:]], axis=1)
        ra_f, rl_f = smooth(ra, rl), smooth(rl, ra)
        pl = ref._predict_mode(ra_f if filt else ra, rl_f if filt else rl,
                               s, 0, max_val)
        dc = ref._predict_mode(ra, rl, s, 1, max_val)
        ang = ref._predict_all_angular(ra, rl, ra_f, rl_f, s, max_val)
        return jnp.concatenate([pl[:, None], dc[:, None], ang], axis=1)

    def port_preds(ra, rl):
        ra_f, rl_f = port._smooth(ra, rl), port._smooth(rl, ra)
        pl = port._predict_mode(ra_f if filt else ra, rl_f if filt else rl,
                                s, 0, max_val)
        dc = port._predict_mode(ra, rl, s, 1, max_val)
        ang = port._predict_all_angular(ra, rl, ra_f, rl_f, s, max_val)
        return torch.cat([pl[:, None], dc[:, None], ang], dim=1).numpy()

    out["preds"] = (np.asarray(jax_preds(ra_j, rl_j)),
                    port_preds(ra_p, rl_p))
    org = (ppad[1:1 + nby * s, 1:1 + nbx * s].reshape(nby, s, nbx, s)
           .transpose(0, 2, 1, 3).reshape(nby * nbx, s, s))
    out["org"] = org
    return out


FRAMES = ["96x80", "416x240_q32"]


@pytest.fixture(scope="module")
def lines_preds(frames):
    """``_lines_and_preds`` of (frame, size class), computed once."""
    cache = {}

    def get(frame, s):
        if (frame, s) not in cache:
            cache[frame, s] = _lines_and_preds(frames[frame], s)
        return cache[frame, s]
    return get


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("frame", FRAMES)
def test_lines_predictions_and_satd_exact(frames, lines_preds, frame, s):
    got = lines_preds(frame, s)
    (ra_j, rl_j), (ra_p, rl_p) = got["lines"]
    np.testing.assert_array_equal(np.asarray(ra_j), ra_p.numpy())
    np.testing.assert_array_equal(np.asarray(rl_j), rl_p.numpy())
    pj, pp = got["preds"]
    assert pp.shape == pj.shape == (got["org"].shape[0], 35, s, s)
    np.testing.assert_array_equal(pj, pp)
    bit_inc = frames[frame][15]
    org = got["org"]
    n = org.shape[0]
    diff = (org[:, None] - pj.astype(np.int32)).reshape(n * 35, s, s)
    satd_j = np.asarray(jax.jit(ref._satd_d, static_argnums=(1, 2))(
        diff, s, bit_inc)).reshape(n, 35)
    satd_p = satd_blocks(torch.from_numpy(org.astype(np.int16)),
                         torch.from_numpy(pp.astype(np.int16)), bit_inc)
    np.testing.assert_array_equal(satd_j, satd_p.numpy())


def test_mpm_vec_exact():
    rng = np.random.RandomState(3)
    left = rng.randint(0, 35, 4000).astype(np.int32)
    above = rng.randint(0, 35, 4000).astype(np.int32)
    above[::3] = left[::3]                 # the left == above branch
    ref_m = ref._mpm_vec(jnp.asarray(left), jnp.asarray(above))
    got = port._mpm_vec(torch.from_numpy(left), torch.from_numpy(above))
    for a, b in zip(ref_m, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_coeff_bits_est_within_rtol(size):
    rng = np.random.RandomState(size)
    levels = (rng.standard_cauchy((300, size, size)) * 3).clip(
        -32768, 32767).astype(np.int32)
    levels[rng.rand(*levels.shape) < 0.6] = 0
    levels[:20] = 0                                  # all-zero TUs
    ref_b = np.asarray(ref._coeff_bits_est(jnp.asarray(levels), size))
    got = port._coeff_bits_est(torch.from_numpy(levels), size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref_b, rtol=BIT_RTOL, atol=0)


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, -32])
@pytest.mark.parametrize("frame", FRAMES)
def test_tq_rd_dist_exact_bits_within_rtol(frames, lines_preds, frame,
                                           size):
    args = frames[frame]
    s = abs(size)
    got = lines_preds(frame, s)
    org, preds = got["org"], got["preds"][0]
    rng = np.random.RandomState(s)
    n = org.shape[0]
    pred = preds[np.arange(n), rng.randint(0, 35, n)]
    qp = rng.randint(0, 52, n).astype(np.int32)
    bit_inc, max_val = args[15], args[16]
    d_j, b_j = ref._tq_rd(jnp.asarray(org), jnp.asarray(pred), size,
                          jnp.asarray(qp), bit_inc, max_val)
    d_p, b_p = port._tq_rd(torch.from_numpy(org), torch.from_numpy(pred),
                           size, torch.from_numpy(qp), bit_inc, max_val)
    np.testing.assert_array_equal(np.asarray(d_j), d_p.numpy())
    np.testing.assert_allclose(b_p.numpy(), np.asarray(b_j), rtol=BIT_RTOL,
                               atol=0)


@pytest.mark.parametrize("frame", FRAMES)
def test_decide_frame_maps_agree_with_jax(frames, frame, monkeypatch):
    # the JAX package's accelerator form (one gather for all modes); it
    # gives the same maps as its per-mode CPU form
    # (tests/test_device_path.py) and compiles in seconds
    monkeypatch.setenv("THEVC_FASTRD_UNIFIED", "1")
    monkeypatch.setenv("THEVC_DEVICE", "0")
    args = frames[frame]
    ref._frame_pass_cache.clear()
    try:
        maps_j = ref.decide_frame(*args)
    finally:
        ref._frame_pass_cache.clear()
    maps_p = port.decide_frame(*args, device="cpu")
    names = ("depth", "mode", "nxn", "chroma", "mode2", "mode3")
    for name, a, b in zip(names, maps_j, maps_p):
        assert b.dtype == a.dtype and b.shape == a.shape
        mismatch = int((a != b).sum())
        print(f"{frame} {name}: {mismatch} of {a.size} units differ")
        assert mismatch <= 0.001 * a.size, (name, mismatch)
    assert maps_p[2].flags["C_CONTIGUOUS"]


def test_predict_mode_refuses_angular():
    ra = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="angular"):
        port._predict_mode(ra, ra, 4, 2, 255)
