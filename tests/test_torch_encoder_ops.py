"""The port's encoder ops against the JAX package and numpy: forward
transform, quant, TU recon, and the Hadamard SATD.

Inputs come from numpy with a seed and go through both packages; every
comparison is exact (integer codec math, tolerance 0).
"""

import numpy as np
import pytest
import torch

from thevc_tpu.encoder import fast_intra as ref_fast_intra
from thevc_tpu.encoder.rdcost import calc_had_batched
from thevc_tpu.ops import jx, jx_pallas
from thevc_tpu.ops import transforms as tops
from thevc_tpu_torch.ops import satd, tq

# (size, use_dst, bit_increment), as tests/test_pallas.py
TU_CASES = [(4, False, 0), (4, True, 0), (8, False, 0), (16, False, 0),
            (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2)]
# the SATD cases of tests/test_pallas.py
SATD_CASES = [(4, 0), (8, 0), (16, 0), (32, 0), (8, 2), (64, 2)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("size,use_dst,bit_inc", TU_CASES)
def test_forward_transform_matches_jax_and_numpy(size, use_dst, bit_inc):
    rng = np.random.RandomState(size + 3 * bit_inc)
    hi = 256 << bit_inc
    block = rng.randint(-hi + 1, hi, (48, size, size)).astype(np.int32)
    got = tq.forward_transform(_t(block), use_dst, bit_inc)
    assert got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jx.forward_transform(block, use_dst, bit_inc)))
    np.testing.assert_array_equal(
        got, tops.forward_transform(block, use_dst, bit_inc))


@pytest.mark.parametrize("is_intra", [True, False])
@pytest.mark.parametrize("size,use_dst,bit_inc", TU_CASES)
def test_quant_matches_jax(size, use_dst, bit_inc, is_intra):
    rng = np.random.RandomState(size + 5 * bit_inc + is_intra)
    coeff = rng.randint(-32768, 32768, (52, size, size)).astype(np.int32)
    qp = np.arange(52, dtype=np.int32)             # every QP 0..51
    lv_ref, du_ref = jx.quant(coeff, qp, is_intra, bit_inc)
    lv, du = tq.quant(_t(coeff), _t(qp), is_intra, bit_inc)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(lv_ref))
    np.testing.assert_array_equal(du.numpy(), np.asarray(du_ref))


@pytest.mark.parametrize("size,use_dst,bit_inc", TU_CASES)
def test_tu_recon_pipeline_matches_jax(size, use_dst, bit_inc):
    rng = np.random.RandomState(size + 7 * bit_inc)
    n = 52
    max_val = (256 << bit_inc) - 1
    pred = rng.randint(0, max_val + 1, (n, size, size)).astype(np.int32)
    levels = rng.randint(-600, 600, (n, size, size)).astype(np.int32)
    levels[rng.rand(n) < 0.3] = 0
    qp = rng.randint(0, 52, n).astype(np.int32)
    ref = np.asarray(jx.tu_recon_pipeline(pred, levels, qp, use_dst,
                                          bit_inc, max_val))
    got = tq.tu_recon_pipeline(_t(pred), _t(levels), _t(qp), use_dst,
                               bit_inc, max_val)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("size,bit_inc", SATD_CASES)
def test_intra_sweep_satd_matches_pallas_and_numpy(size, bit_inc):
    rng = np.random.RandomState(size + bit_inc)
    hi = 256 << bit_inc
    org = rng.randint(0, hi, (size, size)).astype(np.int32)
    preds = rng.randint(0, hi, (35, size, size)).astype(np.int32)
    got = satd.intra_sweep_satd(_t(org), _t(preds), bit_inc)
    assert got.dtype == torch.int32 and tuple(got.shape) == (35,)
    got = got.numpy()
    np.testing.assert_array_equal(got, calc_had_batched(org, preds, bit_inc))
    np.testing.assert_array_equal(got, np.asarray(jx_pallas.satd_sweep_planar(
        org, preds, bit_inc, interpret=True)))


@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_satd_blocks_matches_fast_intra(size, bit_inc):
    rng = np.random.RandomState(11 * size + bit_inc)
    n, m = 9, 35
    hi = 256 << bit_inc
    org = rng.randint(0, hi, (n, size, size)).astype(np.int16)
    preds = rng.randint(0, hi, (n, m, size, size)).astype(np.int16)
    got = satd.satd_blocks(_t(org), _t(preds), bit_inc)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, m)
    diff = (org[:, None].astype(np.int32) - preds).reshape(n * m, size,
                                                          size)
    ref = np.asarray(ref_fast_intra._satd_d(diff, size, bit_inc))
    np.testing.assert_array_equal(got.numpy(), ref.reshape(n, m))


def test_satd_blocks_rejects_other_devices():
    x = torch.zeros((1, 4, 4), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        satd.satd_blocks(x, x[:, None])
