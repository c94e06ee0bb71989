"""The port's fast-RD device apply against the JAX package's
(``thevc_tpu/encoder/fast_apply.py``), on the CPU.

Inputs come from numpy seeds and pass between the packages as numpy
arrays; the JAX functions run jitted on the CPU.

- ``_predict_batch``: every class, seeded reference lines and modes
  (seed 13), tolerance 0.
- ``_sbh_batch``: every class, per-TU scans and (16x16 and up) the
  reference's static diagonal scan, seeded quantised batches (seed 17),
  tolerance 0.
- ``_rdoq_batch``: every class at QP 22, 32 and 37 on the transform
  coefficients of seeded residuals (seed 19), per-TU scans and the
  static diagonal scan.  Levels and delta_u are held at tolerance 0,
  except where XLA's own float32 order flips a decision: such a TU must
  be a near tie (one of its decisions between two costs within 16
  float32 ulps, ``_rdoq_batch(with_gaps=True)``), and at most 1 TU in
  1000 may be one.
- ``run_device_apply`` on a 128x64 frame with seeded decision maps (every
  size class, NxN 8x8 CUs, every luma and chroma mode kind): the native
  schedules are equal, and with RDOQ off the recon planes and every
  level stack equal the JAX apply's; with RDOQ on the same, except that
  a near tie (above) would make the records after it differ, and at most
  1 record in 1000 may.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thevc_tpu.encoder import fast_apply as ref
from thevc_tpu_torch.cabac import contexts as cc
from thevc_tpu_torch.encoder import fast_apply as port
from thevc_tpu_torch.ops import tq
from thevc_tpu_torch.streams import nxn_frame

CLASSES = list(enumerate(port.CLS))
IDS = [f"{'y' if luma else 'c'}{size}" for _, (size, luma, _) in CLASSES]
QPS = (22, 32, 37)
# a TU whose RDOQ levels differ from XLA's must have made a decision
# whose two costs lie this close (float32 ulps): the costs are sums of up
# to 1024 float32 terms, which XLA adds in another order (and, jitted,
# may fuse into multiply-adds), so they can move by a few ulps
NEAR_TIE_ULPS = 16


def _lam(qp):
    return float(np.float32(0.57 * 2 ** ((qp - 12) / 3)))


@pytest.mark.parametrize("ci", range(len(port.CLS)), ids=IDS)
def test_predict_batch_matches_jax(ci):
    size, luma, _ = port.CLS[ci]
    rng = np.random.RandomState(13 + ci)
    n = 140
    ra = rng.randint(0, 256, (n, 2 * size + 1)).astype(np.int32)
    rl = rng.randint(0, 256, (n, 2 * size + 1)).astype(np.int32)
    rl[:, 0] = ra[:, 0]
    mode = np.tile(np.arange(35, dtype=np.int32), n // 35)
    want = jax.jit(ref._predict_batch, static_argnums=(2, 3, 5))(
        jnp.asarray(ra), jnp.asarray(rl), size, luma, jnp.asarray(mode), 255)
    got = port._predict_batch(torch.from_numpy(ra), torch.from_numpy(rl),
                              size, luma, torch.from_numpy(mode), 255)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _coefficients(rng, n, size, use_dst):
    """Transform coefficients of seeded Laplacian residuals of varied
    spread: int32 [n, s, s]."""
    res = np.round(rng.laplace(0, 2 + 14 * rng.rand(n, 1, 1),
                               (n, size, size))).astype(np.int32)
    return tq.forward_transform(torch.from_numpy(res), use_dst, 0)


@pytest.mark.parametrize("ci", range(len(port.CLS)), ids=IDS)
def test_sbh_batch_matches_jax(ci):
    size, luma, use_dst = port.CLS[ci]
    rng = np.random.RandomState(17 + ci)
    n = 192
    co = _coefficients(rng, n, size, use_dst)
    levels, du = tq.quant(co, torch.full((n,), 27, dtype=torch.int32),
                          True, 0)
    modes = [(rng.randint(0, 3, n), None)]
    if size >= 16:
        modes.append((np.full(n, 2), 2))
    for sel, static in modes:
        fn = jax.jit(lambda lv, src, d, s: ref._sbh_batch(
            lv, src, d, s, size, static))
        want = fn(jnp.asarray(levels.numpy()), jnp.asarray(co.numpy()),
                  jnp.asarray(du.numpy()), jnp.asarray(sel, jnp.int32))
        got = port._sbh_batch(levels, co, du, torch.from_numpy(sel), size)
        assert np.array_equal(got.numpy(), np.asarray(want)), static
        assert not np.array_equal(got.numpy(), levels.numpy())


@pytest.mark.parametrize("ci", range(len(port.CLS)), ids=IDS)
def test_rdoq_batch_matches_jax_but_near_ties(ci):
    size, luma, use_dst = port.CLS[ci]
    rng = np.random.RandomState(19 + ci)
    n = 256
    # the qp is traced, so one compile per scan mode
    modes = [None] + ([2] if size >= 16 else [])
    fns = {static: jax.jit(
        lambda co, lam, qp, sel, trd, ebt, static=static: ref._rdoq_batch(
            co, lam, qp, size, sel, trd, luma, ebt, 0, static))
        for static in modes}
    tus = ties = 0
    for qp in QPS:
        init = cc.make_context_states_idx(0, qp)
        ebt_ref = {k: jnp.asarray(v)
                   for k, v in ref.est_bits_pack(init, size, luma).items()}
        ebt = port.est_bits_tensors(init, size, luma, "cpu")
        lam = _lam(qp)
        co = _coefficients(rng, n, size, use_dst)
        trd = rng.randint(0, 2, n)
        for static in modes:
            sel = rng.randint(0, 3, n) if static is None else np.full(n, 2)
            want = fns[static](jnp.asarray(co.numpy()), jnp.float32(lam),
                               jnp.int32(qp), jnp.asarray(sel, jnp.int32),
                               jnp.asarray(trd, jnp.int32), ebt_ref)
            want = [np.asarray(w) for w in want]
            sel_t, trd_t = torch.from_numpy(sel), torch.from_numpy(trd)
            got = port._rdoq_batch(co, lam, qp, size, sel_t, trd_t, luma,
                                   ebt, 0, with_gaps=True)
            assert got[0].abs().sum() > 0
            differ = np.nonzero(
                (got[0].numpy() != want[0]).any(axis=(1, 2))
                | (got[1].numpy() != want[1]).any(axis=(1, 2)))[0]
            gaps = got[2].numpy()[differ]
            assert (gaps <= NEAR_TIE_ULPS).all(), (qp, static, differ, gaps)
            tus += n
            ties += len(differ)
    assert ties * 1000 <= tus, (ties, tus)


# -- run_device_apply on a frame

W, H, CTU, MAX_SIG, MIN_TR = 128, 64, 64, 3, 2


@pytest.fixture(scope="module")
def frame():
    planes, maps = nxn_frame(np.random.RandomState(24), W, H, CTU, MAX_SIG)
    sched = port.build_schedule(*maps, W, H, CTU, MAX_SIG, MIN_TR)
    want = ref.build_schedule(*maps, W, H, CTU, MAX_SIG, MIN_TR)
    assert sched is not None and want is not None
    assert sched.n_waves == want.n_waves and sched.caps == want.caps
    assert sched.counts == want.counts and all(sched.counts)
    for a, b in zip(sched.flat + sched.offs, want.flat + want.offs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    return planes, sched, want


@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
def test_run_device_apply_matches_jax(frame, use_rdoq):
    (y, cb, cr), sched, sched_ref = frame
    qp = 32
    lam_y, lam_c = _lam(qp), _lam(qp) / 1.2
    init = cc.make_context_states_idx(0, qp)
    args = (W, H, qp, qp - 1, qp - 2, CTU, 0, 255, True, use_rdoq, lam_y,
            lam_c, init)
    want = ref.collect_device_apply(ref.run_device_apply(
        y, cb, cr, sched_ref, *args, device=jax.devices("cpu")[0]))
    run = port.run_device_apply(y, cb, cr, sched, *args, device="cpu")
    got = port.collect_device_apply(run)
    assert run.n_waves == sched.n_waves
    assert run.class_steps == sum(int((np.diff(o) > 0).sum())
                                  for o in sched.offs)
    records = differ = 0
    for ci, (size, luma, _) in enumerate(port.CLS):
        n_c = sched.counts[ci]
        for g, w in ((got[3][ci], want[3][ci]), (got[4][ci], want[4][ci])):
            if g is None:
                continue
            records += n_c
            differ += int((g[:n_c] != w[:n_c]).any(axis=(1, 2)).sum())
    if use_rdoq:
        assert differ * 1000 <= records, (differ, records)
    else:
        assert differ == 0
    if differ == 0:
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, w.astype(np.int16))
