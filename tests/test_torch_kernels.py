"""The hand-written CUDA residual kernel against its plain version, on a
CUDA card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and
skips without one.  Run on the GPU machine with
``python -m pytest tests/test_torch_kernels.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from thevc_tpu.ops import transforms as tops
from thevc_tpu_torch.common.tables import from_reference
from thevc_tpu_torch.ops import residual_kernel, tq

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
    from thevc_tpu.decoder.recon import _pack_cgs
    vals, idx = _pack_cgs(q, size, n)
    got = tq.residual_pipeline_packed(
        torch.from_numpy(vals).to(cuda), torch.from_numpy(idx).to(cuda),
        torch.from_numpy(qp).to(cuda), size)
    ref = tq.residual_pipeline_plain(torch.from_numpy(q),
                                     torch.from_numpy(qp))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda):
    basis = from_reference(cuda).dct[8]
    x = torch.zeros((3, 8, 8), dtype=torch.int16, device=cuda)
    scale = torch.ones(3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        residual_kernel.residual(x.to(torch.int32), scale, basis, 2, 12)
    with pytest.raises(ValueError):
        residual_kernel.residual(x, scale[:2], basis, 2, 12)
    with pytest.raises(ValueError):
        residual_kernel.residual(x.transpose(1, 2), scale, basis, 2, 12)
    with pytest.raises(ValueError):
        residual_kernel.residual(x.cpu(), scale, basis, 2, 12)
    with pytest.raises(RuntimeError):
        residual_kernel.residual(x, scale, basis, 0, 12)   # bad shift
