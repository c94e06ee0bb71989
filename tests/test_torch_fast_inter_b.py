"""The port's fast-RD B decision pass against the JAX package's, on the CPU.

The inputs of ``tests/test_torch_fast_inter.py`` with an L1 list (frames
0 and 1): the bi-prediction stage from the same two uni winners (RD
costs within rtol 1e-5), then one whole B frame, whose fourteen maps
must agree with the JAX package's ``_frame_body_p`` on at least 99.9% of
4x4 units (the counts are printed).  Kept apart from the P tests so that
the two long JAX compiles run on different test workers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_fast_inter import (CBITS2, HP, LAM, P_MAPS, QP, QP_C,
                                         SQRT_LAM_ME, WP, BIT_RTOL, _pad_ref,
                                         check_maps, decide_args,
                                         jax_frame_maps, make_inputs)
from thevc_tpu.encoder import fast_inter as ref
from thevc_tpu_torch.encoder import fast_inter as port
from thevc_tpu_torch.encoder import fast_intra as port_intra

B_MAPS = P_MAPS + ("dir", "ref1", "mvx1", "mvy1")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory)


@pytest.mark.parametrize("s", [8, 32, 64])
def test_bi_size_pass_agrees(inputs, s):
    cur, refs0, refs1 = inputs
    rng = np.random.RandomState(s)
    nby, nbx = HP // s, WP // s
    py, pcb, pcr = (p.astype(np.int32) for p in port_intra._source_planes(
        *cur, 96, 80, 64))
    org = py[1:1 + HP, 1:1 + WP]
    org_cb = pcb[1:1 + HP // 2, 1:1 + WP // 2]
    org_cr = pcr[1:1 + HP // 2, 1:1 + WP // 2]
    stacks = []
    for refs in (refs0, refs1):
        stacks.append((np.stack([_pad_ref(p[1], ref.PAD_FULL, HP, WP)
                                 for p in refs]),
                       np.stack([_pad_ref(p[2], ref.PAD_C, HP // 2, WP // 2)
                                 for p in refs]),
                       np.stack([_pad_ref(p[3], ref.PAD_C, HP // 2, WP // 2)
                                 for p in refs])))
    # the two lists' uni winners: quarter-pel MVs within the search range
    mvx, mvy = (rng.randint(-270, 271, (2, nby, nbx)).astype(np.int32)
                for _ in range(2))
    r = rng.randint(0, 2, (2, nby, nbx)).astype(np.int32)
    rd = rng.rand(2, nby, nbx).astype(np.float32)
    f32 = np.float32
    fn = jax.jit(ref._bi_size_pass,
                 static_argnums=(7, 8, 9, 10, 11, 18, 19))
    rd_j = fn(jnp.asarray(org), jnp.asarray(org_cb), jnp.asarray(org_cr),
              *(jnp.asarray(np.stack([stacks[0][c], stacks[1][c]]))
                for c in range(3)),
              tuple(jnp.asarray(a) for a in (rd, mvx, mvy, r)), s, nby, nbx,
              ref.PAD_FULL, ref.PAD_C, jnp.int32(QP), jnp.int32(QP_C),
              jnp.int32(QP_C), f32(LAM), f32(CBITS2[2]), f32(SQRT_LAM_ME), 0,
              255)
    t = torch.from_numpy
    rd_p = port._bi_size_pass(
        t(org), t(org_cb), t(org_cr),
        [(t(st[0]), torch.cat([t(st[1]), t(st[2])])) for st in stacks],
        [tuple(t(a[k]).long() if a.dtype != np.float32 else t(a[k])
               for a in (rd, mvx, mvy, r)) for k in range(2)],
        s, nby, nbx, torch.tensor(QP), torch.tensor(QP_C),
        torch.tensor(QP_C), torch.tensor(f32(LAM)),
        torch.tensor(f32(CBITS2[2])), 0, 255)
    np.testing.assert_allclose(rd_p.numpy(), np.asarray(rd_j), rtol=BIT_RTOL)


def test_b_frame_maps_agree_with_jax(inputs):
    cur, refs0, refs1 = inputs
    maps_j = jax_frame_maps(cur, refs0, refs1)
    maps_p = port.decide_frame_p(*decide_args(cur, refs0),
                                 ref_pics_l1=refs1, device="cpu")
    check_maps(B_MAPS, maps_j, maps_p, "B frame")
    assert (maps_p[6] == 1).any()            # some CUs chose inter
