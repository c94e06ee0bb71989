"""The integer refinement of the P/B decision pass at the extremes of its
sums, and the operations of its kernel's bound, on the CPU.

``int_refine_plain`` (``thevc_tpu_torch/encoder/fast_inter.py``, the
plain form of ``csrc/inter_me.cu``'s ``int_refine_kernel``) is held
against the JAX package's lines of ``_inter_size_pass``
(``thevc_tpu/encoder/fast_inter.py:226-262``, written out as
``jax_int_refine`` in ``tests/test_torch_inter_me.py``) at 12 bits
(bit_inc 4): a source of 4095 against references of 0 with a sparse
4095, and the reverse, so that a 64x64 block's SAD reaches 4096 x 4095 =
16,773,120 and the candidates differ by multiples of 4095; sizes 8 and
64, sqrt-lambda 0 and the pass's own; the MVs equal, tolerance 0.

``chip_smoke.inter_me_bound``'s refinement operations
(``chip_smoke.refine_ops``: two float instructions a difference, the
absolute value an operand modifier of the add, and six a candidate cost)
equal that count on constructed calls, its bound the larger of the bytes'
time and the operations' at the float pipe's instruction rate (half
``FP32_OPS``); the operations of a 1080p B frame's 8 calls come to about
0.0496 ms.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from thevc_tpu_torch.encoder import fast_inter as port
from tests.test_torch_inter_me import (H, N_REFS, SQRT_LAM, W,
                                       both_int_refine, random_coarse)

# one intra-op thread: the test workers share the host's cores
torch.set_num_threads(1)

TOP = 4095                                # 12 bits: bit_inc 4


def extreme_planes(seed: int, src_top: bool) -> dict:
    """A uniform source at one extreme and references at the other with
    2% of their samples at the source's, padded as ``RefCache`` pads."""
    rng = np.random.RandomState(seed)
    pad = port.PAD_FULL
    org = np.full((H, W), TOP if src_top else 0, np.int16)
    sparse = rng.rand(N_REFS, H + 2 * pad, W + 2 * pad) < 0.02
    ry = np.where(sparse, TOP, 0) if src_top else np.where(sparse, 0, TOP)
    return dict(org=org, ry=ry.astype(np.int16), bit_inc=4)


@pytest.mark.parametrize("sqrt_lam", [0.0, SQRT_LAM], ids=["lam0", "lam"])
@pytest.mark.parametrize("src_top", [True, False], ids=["src4095", "src0"])
@pytest.mark.parametrize("s", [8, 64])
def test_int_refine_plain_extremes_equal_jax(s, src_top, sqrt_lam):
    p = extreme_planes(s + src_top, src_top)
    coarse = random_coarse(np.random.RandomState(s), s, H // s, W // s, 64)
    want, got = both_int_refine(p, coarse, s, sqrt_lam)
    for a, b in zip(want, got):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def refine_call(s: int, nby: int, nbx: int) -> tuple:
    """The arguments of one ``int_refine`` call on CPU tensors: a source
    and two padded references of nby x nbx blocks, a seeded coarse field."""
    rng = np.random.RandomState(s)
    pad = port.PAD_FULL
    h, w = nby * s, nbx * s
    org = torch.from_numpy(rng.randint(0, 256, (h, w)).astype(np.int16))
    refs = torch.from_numpy(rng.randint(0, 256, (N_REFS, h + 2 * pad,
                                                 w + 2 * pad))
                            .astype(np.int16))
    coarse = tuple(torch.from_numpy(c) for c in random_coarse(
        rng, s, nby, nbx, 64))
    return (org, refs, coarse, s, nby, nbx,
            torch.tensor(np.float32(SQRT_LAM)), 0, pad)


@pytest.mark.parametrize("s", port.INTER_SIZES)
def test_refine_floor_counts_two_instructions_a_difference(s):
    nby, nbx = 128 // s, 192 // s
    a = refine_call(s, nby, nbx)
    nb = nby * nbx
    want = 2 * 49 * s * s * nb + 6 * 49 * nb
    assert chip_smoke.refine_ops(s, nb) == want
    nbytes, ops, bound_ms, _by = chip_smoke.inter_me_bound(torch,
                                                           "int_refine", a)
    assert ops == want
    assert chip_smoke.INT32_OPS == chip_smoke.FP32_OPS / 2
    floor = 1000 * want / (chip_smoke.FP32_OPS / 2)
    assert bound_ms == pytest.approx(
        max(floor, 1000 * nbytes / chip_smoke.HBM_BYTES_S), rel=1e-12)


def test_refine_floor_of_a_1080p_b_frame():
    """The B frame's 8 calls (two lists, each class on the 1920x1088 grid
    of 64x64 CTUs that covers 1080 rows): about 0.0496 ms of operations,
    against 0.0741 ms at three instructions a difference."""
    grids = {8: (136, 240), 16: (68, 120), 32: (34, 60), 64: (17, 30)}
    total = 2 * sum(1000 * chip_smoke.refine_ops(s, g[0] * g[1])
                    / chip_smoke.INT32_OPS for s, g in grids.items())
    diffs = 2 * sum(49 * s * s * g[0] * g[1] for s, g in grids.items())
    assert 8.0e8 < diffs < 8.3e8
    assert total == pytest.approx(0.049649, rel=1e-4)
