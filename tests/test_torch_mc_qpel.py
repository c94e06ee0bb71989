"""The quarter-pel candidate MC of the P/B fast-RD pass (``ops.mc.mc_qpel``,
the plain version it runs on the CPU) against three independent forms of
the same 49 predictions a block, tolerance 0 (integer codec math):

- ``mc_blocks_plain`` on a 49-job table built here candidate by
  candidate;
- the former 7-``cat`` loop of the pass (``seven_cat_loop`` of
  ``tests/test_torch_mc_picture.py``);
- the JAX package's ``thevc_tpu/ops/jx_mc.py:mc_batch`` in the ``2d``
  case on the same windows, gathered here with numpy at clamped
  coordinates.

Block sizes 8, 16, 32 and 64 at bit depths 8 and 10, on 64x128 planes
with the pass's padding, and integer MVs that reach past the padded plane
(the clamp).  The kernel itself runs on the card only
(``tests/test_torch_kernels.py``, marked ``gpu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_mc_picture import seven_cat_loop
from thevc_tpu.ops import jx_mc
from thevc_tpu_torch.encoder import fast_inter
from thevc_tpu_torch.ops import mc, mc_kernel

SIZES = [8, 16, 32, 64]
BIT_DEPTHS = [8, 10]
PLANE = (64, 128)            # luma rows and columns before padding


def qpel_case(s: int, bd: int):
    """Seeded padded planes [2, rows, cols] and the pass's inputs for
    every s x s block of a 64x128 picture: (planes, ref, bx, by, int_mx,
    int_my, origins int64 [nb, 3])."""
    rng = np.random.RandomState(100 * s + bd)
    hp, wp = PLANE
    pad = fast_inter.PAD_FULL
    planes = torch.from_numpy(rng.randint(
        0, 1 << bd, (2, hp + 2 * pad, wp + 2 * pad)).astype(np.int16))
    nby, nbx = hp // s, wp // s
    nb = nby * nbx
    by, bx = fast_inter._block_grid(s, nby, nbx, "cpu")
    ref = torch.from_numpy(rng.randint(0, 2, nb))
    # inside the search range and past the padded plane on every side
    reach = pad + 2 * s
    int_mx = torch.from_numpy(rng.randint(-reach, reach + 1, nb))
    int_my = torch.from_numpy(rng.randint(-reach, reach + 1, nb))
    origins = torch.stack([ref, bx + int_mx + (pad - 3),
                           by + int_my + (pad - 3)], dim=1)
    return planes, ref, bx, by, int_mx, int_my, origins


def job_table(origins: np.ndarray) -> np.ndarray:
    """The 49 jobs of each block, candidate by candidate: (plane, window
    x, window y, fx, fy) of quarter-pel offset (qdx, qdy) at row (qdy + 3)
    * 7 + qdx + 3."""
    jobs = []
    for p, x, y in origins:
        for qdy in range(-3, 4):
            for qdx in range(-3, 4):
                jobs.append((p, x + qdx // 4, y + qdy // 4, qdx % 4,
                             qdy % 4))
    return np.asarray(jobs, np.int64)


@pytest.mark.parametrize("bd", BIT_DEPTHS)
@pytest.mark.parametrize("s", SIZES)
def test_mc_qpel_equals_blocks_plain_on_49_jobs(s, bd):
    planes, *_, origins = qpel_case(s, bd)
    before = (mc_kernel.launches, mc_kernel.qpel_launches)
    got = mc.mc_qpel(planes, origins, s, bd)
    # the CPU runs no kernel
    assert (mc_kernel.launches, mc_kernel.qpel_launches) == before
    nb = origins.shape[0]
    assert got.shape == (nb, 49, s, s) and got.dtype == torch.int16
    jobs = torch.from_numpy(job_table(origins.numpy()))
    assert torch.equal(mc.qpel_jobs(origins), jobs)
    want = mc.mc_blocks_plain(planes, jobs, "2d", True, bd, False, s, s)
    assert torch.equal(got, want.reshape(nb, 49, s, s))
    assert int(got.min()) >= 0 and int(got.max()) < 1 << bd


@pytest.mark.parametrize("bd", BIT_DEPTHS)
@pytest.mark.parametrize("s", SIZES)
def test_mc_qpel_equals_seven_cat_loop(s, bd):
    planes, ref, bx, by, int_mx, int_my, origins = qpel_case(s, bd)
    got = fast_inter._qpel_preds(planes, ref, int_mx, int_my, s,
                                 PLANE[1] // s, bd)
    assert torch.equal(got, mc.mc_qpel(planes, origins, s, bd))
    assert torch.equal(got, seven_cat_loop(planes, ref, bx, by, int_mx,
                                           int_my, s, bd))


@pytest.mark.parametrize("bd", BIT_DEPTHS)
@pytest.mark.parametrize("s", SIZES)
def test_mc_qpel_equals_jax_mc_batch(s, bd):
    planes, *_, origins = qpel_case(s, bd)
    got = mc.mc_qpel(planes, origins, s, bd).numpy()
    jobs = job_table(origins.numpy())
    p = planes.numpy()
    rows, cols = p.shape[1:]
    ys = np.clip(jobs[:, 2, None] + np.arange(s + 7), 0, rows - 1)
    xs = np.clip(jobs[:, 1, None] + np.arange(s + 7), 0, cols - 1)
    windows = p[jobs[:, 0, None, None], ys[:, :, None], xs[:, None, :]]
    want = np.asarray(jx_mc.mc_batch(
        jnp.asarray(windows), jnp.asarray(jobs[:, 3], jnp.int32),
        jnp.asarray(jobs[:, 4], jnp.int32), case="2d", luma=True, bd=bd,
        bi=False, out_h=s, out_w=s))
    assert np.array_equal(got.reshape(-1, s, s), want)


def test_mc_qpel_of_no_blocks_and_other_devices():
    planes, *_, origins = qpel_case(8, 8)
    assert mc.mc_qpel(planes, origins[:0], 8, 8).shape == (0, 49, 8, 8)
    with pytest.raises(ValueError):
        mc.mc_qpel(planes.to("meta"), origins.to("meta"), 8, 8)
