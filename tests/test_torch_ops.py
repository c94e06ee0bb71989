"""The port's stage-1 residual ops against the JAX package and numpy.

Inputs come from numpy with a seed and go through both packages; every
comparison is exact (integer codec math, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from thevc_tpu.decoder.recon import _pack_cgs
from thevc_tpu.ops import jx, jx_pallas
from thevc_tpu.ops import transforms as tops
from thevc_tpu_torch.decoder.recon import _pack_cgs as port_pack_cgs
from thevc_tpu_torch.ops import tq

# the cases of tests/test_pallas.py (sizes 4-32, DST, bit_inc 0/2)
CASES = [(4, False, 0), (4, True, 0), (8, False, 0), (16, False, 0),
         (32, False, 0), (4, True, 2), (8, False, 2), (32, False, 2)]


def _inputs(size, bit_inc, n):
    rng = np.random.RandomState(size + bit_inc + n)
    q = rng.randint(-32768, 32768, (n, size, size)).astype(np.int16)
    qp = rng.randint(0, 64, n).astype(np.int32)
    return q, qp


@pytest.mark.parametrize("n", [64, 129])
@pytest.mark.parametrize("size,use_dst,bit_inc", CASES)
def test_residual_pipeline_matches_jax_and_numpy(size, use_dst, bit_inc, n):
    q, qp = _inputs(size, bit_inc, n)
    got = tq.residual_pipeline(torch.from_numpy(q), torch.from_numpy(qp),
                               use_dst, bit_inc)
    assert got.dtype == torch.int16 and tuple(got.shape) == q.shape
    got = got.numpy()
    ref_np = tops.inverse_transform(
        tops.dequant(q.astype(np.int32), qp, bit_inc),
        use_dst, bit_inc).astype(np.int16)
    ref_xla = np.asarray(jx._residual_pipeline_xla(
        jnp.asarray(q), jnp.asarray(qp), use_dst, bit_inc))
    ref_pallas = np.asarray(jx_pallas.residual_pipeline_planar(
        q, qp, use_dst, bit_inc, interpret=True))
    assert np.array_equal(got, ref_np)
    assert np.array_equal(got, ref_xla)
    assert np.array_equal(got, ref_pallas)


@pytest.mark.parametrize("size,use_dst,bit_inc", CASES)
def test_dequant_and_inverse_transform_match_jax(size, use_dst, bit_inc):
    q, qp = _inputs(size, bit_inc, 64)
    deq = tq.dequant(torch.from_numpy(q), torch.from_numpy(qp), bit_inc)
    ref_deq = np.asarray(jx.dequant(jnp.asarray(q), jnp.asarray(qp),
                                    bit_inc))
    assert np.array_equal(deq.numpy(), ref_deq)
    res = tq.inverse_transform(deq, use_dst, bit_inc)
    ref_res = np.asarray(jx.inverse_transform(jnp.asarray(ref_deq),
                                              use_dst, bit_inc))
    assert np.array_equal(res.numpy(), ref_res)


def _sparse_blocks(rng, n, size):
    """TU batch whose 4x4 groups are mostly zero, as coded TUs are."""
    blocks = rng.randint(-600, 600, (n, size, size)).astype(np.int16)
    g = size // 4
    keep = rng.rand(n, g, 1, g, 1) < 0.3
    keep = np.broadcast_to(keep, (n, g, 4, g, 4)).reshape(n, size, size)
    return np.where(keep, blocks, 0).astype(np.int16)


@pytest.mark.parametrize("size", [8, 16, 32])
def test_unpack_and_packed_pipeline_match_jax(size):
    rng = np.random.RandomState(size)
    n = 37
    blocks = _sparse_blocks(rng, n, size)
    qp = rng.randint(0, 52, n).astype(np.int32)
    vals, idx = _pack_cgs(blocks, size, n)
    dense = tq._unpack_cgs(torch.from_numpy(vals), torch.from_numpy(idx),
                           n, size).numpy()
    assert np.array_equal(dense, blocks)
    assert np.array_equal(dense, np.asarray(jx._unpack_cgs(
        jnp.asarray(vals), jnp.asarray(idx), n, size)))
    for bit_inc in (0, 2):
        got = tq.residual_pipeline_packed(
            torch.from_numpy(vals), torch.from_numpy(idx),
            torch.from_numpy(qp), size, False, bit_inc).numpy()
        ref = np.asarray(jx.residual_pipeline_packed(
            jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(qp), size,
            False, bit_inc))
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("size", [8, 16, 32])
def test_packed_pipeline_full_range_matches_jax(size, bit_inc):
    """The inputs of the fused kernel's tests: full-range int16 groups,
    TUs with no coded group, padding rows, N not a multiple of the
    kernel's tile; the port's packed pipeline (its plain version here)
    against the JAX package's, exact."""
    rng = np.random.RandomState(100 + size + bit_inc)
    n = 37
    q = rng.randint(-32768, 32768, (n, size, size)).astype(np.int16)
    g = size // 4
    keep = rng.rand(n, g, 1, g, 1) < 0.5
    keep[rng.rand(n) < 0.2] = False
    q = np.where(np.broadcast_to(keep, (n, g, 4, g, 4)).reshape(q.shape),
                 q, 0).astype(np.int16)
    qp = rng.randint(0, 52 + 6 * bit_inc, n).astype(np.int32)
    vals, idx = port_pack_cgs(q, size, n)
    assert np.array_equal(vals, _pack_cgs(q, size, n)[0])
    got = tq.residual_pipeline_packed(
        torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(qp),
        size, False, bit_inc).numpy()
    ref = np.asarray(jx.residual_pipeline_packed(
        jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(qp), size, False,
        bit_inc))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transform_skip_residual_matches_reference(size, bit_inc):
    """The transform-skip residual of an inter TU (dequant, then the
    transform-skip shift) against the reference decoder's per-TU
    ``_residual``."""
    from thevc_tpu.decoder.recon import _residual
    q, qp = _inputs(size, bit_inc, 23)
    got = tq.transform_skip_inv(
        tq.dequant(torch.from_numpy(q).to(torch.int32),
                   torch.from_numpy(qp), bit_inc), bit_inc)
    assert got.dtype == torch.int16
    for k in range(len(q)):
        ref = _residual(q[k].astype(np.int32), int(qp[k]), False, True,
                        False, bit_inc)
        assert np.array_equal(got[k].numpy(), ref), k


def test_residual_pipeline_rejects_other_devices():
    q = torch.zeros((1, 4, 4), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        tq.residual_pipeline(q, torch.zeros(1, dtype=torch.int32,
                                            device="meta"))
