"""The frame kernel's host side (``encoder.fast_apply``): the item list,
the wait rule and a dataflow emulation, on the CPU (no JAX).

The frame kernel (``csrc/apply.cu``) runs a frame's item list in one
launch, each item as soon as the units under its available range are
written.  Here, at 128x64 on ``streams.nxn_frame`` maps (every class of
``fast_apply.CLS`` has a record) and on ``fast_intra.decide_frame`` maps,
8 and 10 bits:

- ``frame_items`` holds every real row of every class and plane exactly
  once, in wave order, then exactly the padding rows that the plain
  form's windows cover;
- the wait rule (``wait_units``, which the kernel mirrors, and
  ``own_units``, what a writer flags) reproduces the native schedule:
  a record's wave is 1 + the largest wave among the writers of the units
  under its range, or 0 when there are none, and every such unit has a
  writer;
- the apply is exact in any order that rule allows: the items run one at
  a time through ``_class_step_plain`` (``apply_items`` on the CPU) in a
  seeded random such order and equal ``run_device_apply_plain`` on the
  CPU, every plane and every level-stack row, tolerance 0.

Marked ``gpu``: a chain of records in one launch, where each record
must wait for the one before it, against the plain version.  Run on the
GPU machine with ``python -m pytest tests/test_torch_apply_frame.py -m
gpu``.
"""

import numpy as np
import pytest
import torch

from thevc_tpu_torch.cabac import contexts as cc
from thevc_tpu_torch.encoder import fast_apply as fa
from thevc_tpu_torch.encoder import fast_intra
from thevc_tpu_torch.ops import apply_kernel
from thevc_tpu_torch.streams import nxn_frame

torch.set_num_threads(1)
W, H, CTU, MAX_SIG, MIN_TR = 128, 64, 64, 3, 2
QP = 32


def _lam(qp):
    return 0.57 * 2 ** ((qp - 12) / 3)


def _frame(kind: str, bit_inc: int):
    """(planes, schedule) of a seeded 128x64 frame: NxN maps, or the
    decision pass's maps of the frame's own planes, at 8 or 10 bits."""
    rng = np.random.RandomState(24 + bit_inc)
    planes, maps = nxn_frame(rng, W, H, CTU, MAX_SIG)
    if bit_inc:
        planes = [np.clip(p.astype(np.int32) * 4
                          + rng.randint(-3, 4, p.shape), 0,
                          1023).astype(np.int16) for p in planes]
    if kind == "decide":
        qp = QP + 6 * bit_inc
        lam = _lam(QP)
        maps = fast_intra.decide_frame(
            *planes, W, H, qp, qp, qp, lam, lam ** 0.5, (2.0, 3.0, 6.0),
            (1.0, 3.0, 1.0), MAX_SIG, MIN_TR, CTU, bit_inc,
            (1 << (8 + bit_inc)) - 1, device="cpu")[:4]
    sched = fa.build_schedule(*maps, W, H, CTU, MAX_SIG, MIN_TR)
    assert sched is not None
    return planes, sched


FRAMES = [("nxn", 0), ("nxn", 2), ("decide", 0), ("decide", 2)]
_cache = {}


@pytest.fixture(params=FRAMES, ids=[f"{k}-{8 + b}bit" for k, b in FRAMES])
def frame(request):
    if request.param not in _cache:
        _cache[request.param] = _frame(*request.param)
    return request.param, _cache[request.param]


def _waves(sched, ci):
    """The native wave of each real row of class ``ci``."""
    return np.repeat(np.arange(sched.n_waves), np.diff(sched.offs[ci]))


def test_nxn_maps_give_every_class():
    _planes, sched = _frame("nxn", 0)
    assert all(sched.counts), sched.counts


def test_item_list(frame):
    _key, (_planes, sched) = frame
    layout, n_lv = fa.level_layout(sched)
    items = fa.frame_items(sched, layout)
    assert items.dtype == np.int32 and items.shape[1] == 8
    ci = items[:, 6] & 15
    plane = (items[:, 6] >> 4) & 3
    real = (items[:, 6] >> 6) & 1
    n_real = int(real.sum())
    # every real item before every padding item
    assert real[:n_real].all() and not real[n_real:].any()
    want_real = sum(n * (1 if fa.CLS[c][1] else 2)
                    for c, n in enumerate(sched.counts))
    assert n_real == want_real
    seen_waves = []
    for c, (s, luma, _) in enumerate(fa.CLS):
        offs = np.asarray(sched.offs[c])
        active = np.nonzero(np.diff(offs))[0]
        # the plain form's windows: [offs[w], offs[w] + cap) at each
        # active wave; past the real rows they are padding
        covered = set()
        for w in active:
            covered.update(range(int(offs[w]), int(offs[w]) + sched.caps[c]))
        want_pad = sorted(r for r in covered if r >= sched.counts[c])
        for p in ((0,) if luma else (1, 2)):
            off, n_rows = layout[c, p]
            assert n_rows == len(sched.flat[c][0])
            sel = (ci == c) & (plane == p)
            rows = (items[sel, 7] - off) // (s * s)
            assert np.array_equal(items[sel, 7], off + rows * s * s)
            # the item carries its record's six fields
            flat = np.stack(sched.flat[c], axis=1)
            assert np.array_equal(items[sel, :6], flat[rows])
            got_real = rows[real[sel] == 1]
            assert np.array_equal(np.sort(got_real),
                                  np.arange(sched.counts[c]))
            got_pad = rows[real[sel] == 0]
            assert np.array_equal(np.sort(got_pad), want_pad)
            assert len(set(got_pad.tolist())) == len(got_pad)
        # wave order: the real items' waves never decrease
        for p in ((0,) if luma else (1, 2)):
            idx = np.nonzero((ci == c) & (plane == p) & (real == 1))[0]
            rows = (items[idx, 7] - layout[c, p][0]) // (s * s)
            seen_waves.append((idx, _waves(sched, c)[rows]))
    order = np.concatenate([i for i, _w in seen_waves])
    waves = np.concatenate([w for _i, w in seen_waves])
    assert np.all(np.diff(waves[np.argsort(order)]) >= 0)
    # the kernel's host check takes the list
    hp, wp = H, W
    apply_kernel.check_items(
        items, [(hp, wp), (hp // 2, wp // 2), (hp // 2, wp // 2)],
        (hp // 4, wp // 4), n_lv, range(len(fa.CLS)))


def test_wait_rule_reproduces_native_waves(frame):
    _key, (_planes, sched) = frame
    uh, uw = H // 4, W // 4
    checked = 0
    for luma in (True, False):
        classes = [c for c, cl in enumerate(fa.CLS) if cl[1] == luma]
        # the wave of each unit's writer
        owner = np.full((uh, uw), -1)
        for c in classes:
            s = fa.CLS[c][0]
            n = sched.counts[c]
            ux, uy = fa.own_units(sched.flat[c][0][:n], sched.flat[c][1][:n],
                                  s, luma)
            assert (owner[uy, ux] == -1).all(), "a unit written twice"
            owner[uy, ux] = _waves(sched, c)[:, None]
        assert (owner >= 0).all(), "a unit nobody writes"
        for c in classes:
            s = fa.CLS[c][0]
            n = sched.counts[c]
            xs, ys, lo, hi = (np.asarray(f[:n]) for f in sched.flat[c][:4])
            ux, uy, under = fa.wait_units(xs, ys, lo, hi, s, luma)
            inside = (ux >= 0) & (uy >= 0) & (ux < uw) & (uy < uh)
            assert (inside | ~under).all(), "a unit under a range off the map"
            writer = np.where(under, owner[uy.clip(0, uh - 1),
                                           ux.clip(0, uw - 1)], -1)
            want = _waves(sched, c)
            assert np.array_equal(writer.max(axis=1) + 1, want)
            checked += n
    assert checked == sum(sched.counts)


def _dependencies(items):
    """For each item, the items that write the units under its range."""
    owner = {}
    for k, (x, y, _lo, _hi, _m, _s, knd, _o) in enumerate(items.tolist()):
        c, p, real = knd & 15, (knd >> 4) & 3, (knd >> 6) & 1
        if real:
            s, luma, _ = fa.CLS[c]
            ux, uy = fa.own_units([x], [y], s, luma)
            for a, b in zip(ux[0], uy[0]):
                owner[p, int(a), int(b)] = k
    deps = []
    for x, y, lo, hi, _m, _s, knd, _o in items.tolist():
        c, p = knd & 15, (knd >> 4) & 3
        s, luma, _ = fa.CLS[c]
        ux, uy, under = fa.wait_units([x], [y], [lo], [hi], s, luma)
        deps.append({owner[p, int(a), int(b)]
                     for a, b, u in zip(ux[0], uy[0], under[0]) if u})
    return deps


def _random_order(deps, rng):
    """A seeded random order of the items in which every item follows
    the items it depends on."""
    n = len(deps)
    waiting = [set(d) for d in deps]
    users = [[] for _ in range(n)]
    for k, d in enumerate(deps):
        for j in d:
            users[j].append(k)
    ready = [k for k in range(n) if not waiting[k]]
    order = []
    while ready:
        k = ready.pop(rng.randint(len(ready)))
        order.append(k)
        for u in users[k]:
            waiting[u].discard(k)
            if not waiting[u]:
                ready.append(u)
    assert len(order) == n
    return np.array(order)


@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
def test_dataflow_emulation_is_exact(frame, use_rdoq):
    (_kind, bit_inc), (planes, sched) = frame
    qps = (QP + 6 * bit_inc, QP + 6 * bit_inc - 1, QP + 6 * bit_inc - 2)
    lams = (_lam(QP), _lam(QP) / 1.2, _lam(QP) / 1.2)
    max_val = (1 << (8 + bit_inc)) - 1
    init = cc.make_context_states_idx(0, QP)
    want = fa.collect_device_apply(fa.run_device_apply_plain(
        *planes, sched, W, H, *qps, CTU, bit_inc, max_val, True,
        use_rdoq, lams[0], lams[1], init, device="cpu"))
    layout, n_lv = fa.level_layout(sched)
    items = fa.frame_items(sched, layout)
    order = _random_order(_dependencies(items),
                          np.random.RandomState(5 + bit_inc))
    # not the list's own order
    assert not np.array_equal(order, np.arange(len(items)))
    g = fa.GUARD
    recs = [torch.zeros((H + 1 + g, W + 1 + g), dtype=torch.int16)] + [
        torch.zeros((H // 2 + 1 + g, W // 2 + 1 + g), dtype=torch.int16)
        for _ in range(2)]
    orgs = [torch.from_numpy(p) for p in planes]
    lv = torch.zeros(n_lv, dtype=torch.int16)
    ready = torch.zeros((3, H // 4, W // 4), dtype=torch.int32)
    ebts = ({c: fa.est_bits_tensors(init, s, luma, "cpu")
             for c, (s, luma, _) in enumerate(fa.CLS)} if use_rdoq else None)
    fa.apply_items(items[order], recs, orgs, lv, ready, None, qps, lams,
                   ebts, bit_inc, max_val, True)
    got = [recs[0][1:1 + H, 1:1 + W], recs[1][1:1 + H // 2, 1:1 + W // 2],
           recs[2][1:1 + H // 2, 1:1 + W // 2]]
    for gp, wp_ in zip(got, want[:3]):
        assert np.array_equal(gp.numpy(), wp_)
    stacks = [s for s in want[3]] + [s for s in want[4] if s is not None]
    assert np.array_equal(lv.numpy(),
                          np.concatenate([s.reshape(-1) for s in stacks]))
    # every unit of the frame flagged, as the kernel leaves its maps
    assert bool((ready == 1).all())


# -- the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
def test_chained_records_wait(cuda, luma):
    """A row of 8x8 TUs (luma, or Cb and Cr) in one launch, each reading
    the recon of the one to its left (its range: the left column beside
    it, line samples s .. 2s - 1): every
    record waits for the one before it, and the result equals the plain
    version's, which runs them one after another."""
    rng = np.random.RandomState(11)
    s, n = 8, 12
    ci = 1 if luma else 5
    hp, wp = 16, s * n
    g = fa.GUARD
    planes = [rng.randint(0, 256, (hp, wp)).astype(np.int16)
              for _ in range(3)]
    items = []
    for k in range(n):
        lo, hi = (1, 0) if k == 0 else (s, 2 * s - 1)
        for p in ((0,) if luma else (1, 2)):
            items.append([k * s, 0, lo, hi, 10 + k, 3,
                          apply_kernel.kind(ci, p, True),
                          (p * n + k) * s * s])
    items = np.array(items, np.int32)

    def state(device):
        recs = [torch.zeros((hp + 1 + g, wp + 1 + g), dtype=torch.int16,
                            device=device) for _ in range(3)]
        orgs = [torch.from_numpy(p).to(device) for p in planes]
        lv = torch.zeros(3 * n * s * s, dtype=torch.int16, device=device)
        ready = torch.zeros((3, hp // 4, wp // 4) if luma
                            else (3, hp // 2, wp // 2), dtype=torch.int32,
                            device=device)
        st = torch.zeros(apply_kernel.STATE_WORDS, dtype=torch.int32,
                         device=device)
        return recs, orgs, lv, ready, st
    qps, lams = (32, 31, 30), (_lam(32), _lam(32) / 1.2, _lam(32) / 1.2)
    init = cc.make_context_states_idx(0, 32)
    out = {}
    for name, device in (("cpu", "cpu"), ("cuda", cuda)):
        recs, orgs, lv, ready, st = state(device)
        ebts = {ci: fa.est_bits_tensors(init, s, luma, device)}
        before = apply_kernel.launches
        fa.apply_items(items, recs, orgs, lv, ready, st, qps, lams, ebts, 0,
                       255, True)
        if name == "cuda":
            torch.cuda.synchronize()
            assert apply_kernel.launches - before == 1
            ticket, error, waited = st.tolist()
            assert error == 0
            # the first record never waits; most of the others catch the
            # record before them still running
            assert 1 <= waited <= len(items) - (1 if luma else 2)
        out[name] = [t.cpu() for t in (*recs, lv, ready)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
