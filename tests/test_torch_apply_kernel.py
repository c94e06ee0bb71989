"""The fast-RD device apply's class step kernel (``ops.apply_kernel``,
``csrc/apply.cu``) and its dispatch (``encoder.fast_apply._class_step``).

On the CPU: the dispatcher runs the plain form and never enters the
kernel's binding; routed to the CUDA branch with a failing binding it
raises and never runs the plain form; an unsupported device raises; the
binding refuses what the kernel does not take before building anything;
and the tables the kernel reads equal the JAX package's
(``thevc_tpu/encoder/fast_apply.py`` ``_scan_tables`` :156,
``_rdoq_tables`` :245, ``est_bits_pack`` :312, and the angular plans of
``thevc_tpu/encoder/fast_intra.py:_unified_plan``) at every class.  The
plain form against the JAX package is ``tests/test_torch_fast_apply_jax.py``.

Marked ``gpu`` (each asks the ``cuda`` fixture for the card and skips
without one): one kernel step against ``_class_step_plain`` on the card,
tolerance 0, at every class, QP 22/27/37, RDOQ and SBH on and off, 8 and
10 bits, on windows at the start of the records and at their padded end;
and whole applies on ``streams.nxn_frame`` maps, kernel (eager and graph
replay) against the plain form on ``cuda`` and against the CPU, one launch
a class step.  Run on the GPU machine with
``python -m pytest tests/test_torch_apply_kernel.py -m gpu``.
"""

import types

import numpy as np
import pytest
import torch

from thevc_tpu.common import rom as jrom
from thevc_tpu.encoder import fast_apply as jfa
from thevc_tpu.encoder import fast_intra as jfi
from thevc_tpu_torch.cabac import contexts as cc
from thevc_tpu_torch.encoder import fast_apply as fa
from thevc_tpu_torch.ops import apply_kernel, residual_kernel
from thevc_tpu_torch.streams import nxn_frame

torch.set_num_threads(1)
GUARD = fa.GUARD


@pytest.fixture
def cuda():
    # decided here, not at import: the test workers must all collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def synthetic_step(ci: int, qp: int, use_rdoq: bool, sign_hide: bool,
                   bit_inc: int, window: str, device, seed: int = 0):
    """A class step's inputs (seeded): a recon plane of a 13s x 10s
    picture (the class's plane, its guard included) with smooth content
    and noise, and records on a grid 3 TUs apart (no record reads a region
    another one writes, so a step's result does not depend on its
    records' order),
    the right and bottom ones at the picture's edge, random modes, scans,
    transform depths and available ranges (some with nothing available),
    then the padding records of ``build_schedule`` (DC fill, in the
    guard).  ``window`` "start" puts the window of 8 over the first
    records, "end" over the last 4 real ones and 4 padding records.
    Returns a ``ClassStep`` on ``device``."""
    size, luma, _ = fa.CLS[ci]
    rng = np.random.RandomState(seed + 97 * ci + qp + 7 * bit_inc)
    max_val = (1 << (8 + bit_inc)) - 1
    # 5 x 4 records, the last column and row at the picture's edge
    wp, hp = 13 * size, 10 * size
    hgt, wid = hp + 1 + GUARD, wp + 1 + GUARD
    unit = 4 if luma else 2
    length = 4 * size + unit
    pos = [(x, y) for y in range(0, hp - size + 1, 3 * size)
           for x in range(0, wp - size + 1, 3 * size)]
    n = len(pos)
    lo = rng.randint(0, length, n)
    hi = np.minimum(length - 1, lo + rng.randint(0, length, n))
    none = rng.rand(n) < 0.15
    lo[none], hi[none] = 1, 0
    mode = rng.randint(0, 35, n)
    scan = rng.randint(0, 4, n) + 4 * rng.randint(0, 4, n)
    cap = 8
    fields = [np.array([p[0] for p in pos]), np.array([p[1] for p in pos]),
              lo, hi, mode, scan]
    pads = (wp + 2, hp + 2, 1, 0, fa.DC_IDX, 3)
    flat = tuple(torch.from_numpy(np.concatenate(
        [f.astype(np.int64), np.full(cap, v, np.int64)])).to(device)
        for f, v in zip(fields, pads))
    n_flat = n + cap
    start = 0 if window == "start" else n - cap // 2

    def plane():
        yy, xx = np.mgrid[0:hgt, 0:wid]
        base = (yy * 5 + xx * 3 + rng.randint(0, 64)) % (max_val + 1)
        noise = rng.randint(-(max_val // 8), max_val // 8 + 1, (hgt, wid))
        return np.clip(base + noise, 0, max_val).astype(np.int16)
    planes = []
    qps = (qp + 6 * bit_inc, qp + 6 * bit_inc - 2)
    for j in range(1 if luma else 2):
        org = np.zeros((n_flat, size, size), np.int16)
        smooth = rng.rand(n) < 0.5
        for r in range(n):
            amp = max_val // (16 if smooth[r] else 2)
            org[r] = np.clip(max_val // 2 + rng.randint(-amp, amp + 1,
                                                       (size, size)),
                             0, max_val)
        rec = torch.from_numpy(plane()).to(device)
        lv = torch.zeros((n_flat, size, size), dtype=torch.int16,
                         device=device)
        qpj = qps[j]
        planes.append((rec, lv, torch.from_numpy(org).to(device), qpj,
                       torch.full((cap,), qpj, dtype=torch.int32,
                                  device=device),
                       0.57 * 2 ** ((qp - 12) / 3) / (1 if luma else 1.2)))
    ebt = (fa.est_bits_tensors(cc.make_context_states_idx(0, qp), size,
                               luma, device) if use_rdoq else None)
    starts = torch.tensor([start], dtype=torch.int64, device=device)
    rows = torch.arange(cap, device=device)
    return fa.ClassStep(ci, planes, flat, starts, rows, ebt, bit_inc,
                        max_val, sign_hide, use_rdoq)


def clone_step(st):
    """A deep copy of a step's mutable state (planes, level stacks,
    counters)."""
    planes = [(rec.clone(), lv.clone(), wins, qp, qv, lam)
              for rec, lv, wins, qp, qv, lam in st.planes]
    return fa.ClassStep(st.ci, planes, st.flat, st.starts, st.rows, st.ebt,
                        st.bit_inc, st.max_val, st.sign_hide, st.use_rdoq)


def kernel_args(st):
    """The binding's arguments for a step (as ``_class_step`` passes
    them), with its tables on the step's device."""
    planes = [(rec, lv, wins, qp, lam)
              for rec, lv, wins, qp, _qv, lam in st.planes]
    return dict(ci=st.ci, planes=planes, records=st.flat, starts=st.starts,
                k=st.k, done=st.done,
                tables=fa.kernel_tables(st.ci, st.k.device), ebt=st.ebt,
                cap=len(st.rows), bit_inc=st.bit_inc, max_val=st.max_val)


# -- the CPU: dispatch and refusals -----------------------------------------

def test_cpu_step_is_the_plain_form(monkeypatch):
    def kernel(*a, **kw):
        raise AssertionError("the kernel's binding ran for a CPU step")
    monkeypatch.setattr(apply_kernel, "class_step", kernel)
    st = synthetic_step(1, 27, True, True, 0, "start", "cpu")
    want = clone_step(st)
    fa._class_step(st)
    fa._step_plain(want)
    for (r, lv, *_), (r2, lv2, *_) in zip(st.planes, want.planes):
        assert torch.equal(r, r2) and torch.equal(lv, lv2)
    assert int(st.k) == int(want.k) == 1


def test_cpu_apply_never_enters_the_kernel(monkeypatch):
    def kernel(*a, **kw):
        raise AssertionError("the kernel's binding ran for a CPU apply")
    monkeypatch.setattr(apply_kernel, "class_step", kernel)
    w, h, qp = 64, 64, 32
    planes, maps = nxn_frame(np.random.RandomState(3), w, h)
    sched = fa.build_schedule(*maps, w, h, 64, 3, 2)
    args = (*planes, sched, w, h, qp, qp - 1, qp - 2, 64, 0, 255, True,
            True, 20.0, 16.0, cc.make_context_states_idx(0, qp))
    got = fa.collect_device_apply(fa.run_device_apply(*args, device="cpu"))
    want = fa.collect_device_apply(fa.run_device_apply_plain(*args,
                                                             device="cpu"))
    for g, e in zip(got[:3] + got[3] + got[4], want[:3] + want[3] + want[4]):
        assert (g is None and e is None) or np.array_equal(g, e)


def test_cuda_branch_raises_and_never_runs_plain(monkeypatch):
    calls = []

    def broken(*a, **kw):
        calls.append("kernel")
        raise RuntimeError("apply kernel launch failed: no device")

    def plain(*a, **kw):
        calls.append("plain")
        raise AssertionError("the plain form ran for a CUDA step")
    monkeypatch.setattr(apply_kernel, "class_step", broken)
    monkeypatch.setattr(fa, "_step_plain", plain)
    monkeypatch.setattr(fa, "_class_step_plain", plain)
    monkeypatch.setattr(fa, "kernel_tables", lambda ci, device: {})
    st = synthetic_step(4, 27, True, True, 0, "start", "cpu")
    # no CUDA tensor exists here: the first plane's stand-in lies on
    # ``cuda`` as far as the dispatcher's device test can tell
    rec = types.SimpleNamespace(device=torch.device("cuda"))
    st.planes = [(rec, *p[1:]) for p in st.planes]
    with pytest.raises(RuntimeError, match="apply kernel"):
        fa._class_step(st)
    assert calls == ["kernel"]


def test_unsupported_device_raises():
    st = synthetic_step(2, 27, False, True, 0, "start", "cpu")
    meta = [(torch.empty(r.shape, dtype=r.dtype, device="meta"), *rest)
            for r, *rest in st.planes]
    st.planes = meta
    with pytest.raises(ValueError, match="unsupported device"):
        fa._class_step(st)


def _refusals():
    """(name, edit of the binding's arguments, expected error)."""
    def plane(j, f):
        def edit(kw):
            planes = list(kw["planes"])
            planes[j] = f(planes[j])
            kw["planes"] = planes
        return edit

    def setk(key, value):
        def edit(kw):
            kw[key] = value(kw) if callable(value) else value
        return edit

    def table(key, f):
        def edit(kw):
            kw["tables"] = dict(kw["tables"], **{key: f(kw["tables"][key])})
        return edit

    def ebt(key, f):
        def edit(kw):
            kw["ebt"] = dict(kw["ebt"], **{key: f(kw["ebt"][key])})
        return edit
    return [
        ("unknown class", setk("ci", 7), ValueError),
        ("class not an int", setk("ci", 1.0), ValueError),
        ("one plane for chroma",
         setk("planes", lambda kw: kw["planes"][:1]), ValueError),
        ("plane dtype", plane(0, lambda p: (p[0].to(torch.int32), *p[1:])),
         TypeError),
        ("plane shapes differ",
         plane(1, lambda p: (p[0][:-1].contiguous(), *p[1:])), ValueError),
        ("plane not contiguous",
         plane(0, lambda p: (p[0].t().contiguous().t(), *p[1:])),
         ValueError),
        ("plane 1-D", plane(0, lambda p: (p[0].reshape(-1), *p[1:])),
         ValueError),
        ("level stack dtype",
         plane(0, lambda p: (p[0], p[1].to(torch.int32), *p[2:])),
         TypeError),
        ("level stack shape",
         plane(1, lambda p: (p[0], p[1][:-1].contiguous(), *p[2:])),
         ValueError),
        ("windows dtype",
         plane(0, lambda p: (p[0], p[1], p[2].to(torch.uint8), *p[3:])),
         TypeError),
        ("QP above 63", plane(0, lambda p: (*p[:3], 64, p[4])), ValueError),
        ("negative QP", plane(1, lambda p: (*p[:3], -1, p[4])), ValueError),
        ("five record fields",
         setk("records", lambda kw: kw["records"][:5]), ValueError),
        ("record dtype",
         setk("records", lambda kw: (kw["records"][0].to(torch.int32),
                                     *kw["records"][1:])), TypeError),
        ("record length",
         setk("records", lambda kw: (kw["records"][0][:-1].contiguous(),
                                     *kw["records"][1:])), ValueError),
        ("starts dtype",
         setk("starts", lambda kw: kw["starts"].to(torch.int32)), TypeError),
        ("counter shape",
         setk("k", torch.zeros(2, dtype=torch.int64)), ValueError),
        ("done dtype", setk("done", torch.zeros(1, dtype=torch.int64)),
         TypeError),
        ("window of 0", setk("cap", 0), ValueError),
        ("window past the records",
         setk("cap", lambda kw: len(kw["records"][0]) + 1), ValueError),
        ("bit increment", setk("bit_inc", 5), ValueError),
        ("largest sample", setk("max_val", 1023), ValueError),
        ("basis dtype", table("basis", lambda t: t.to(torch.int64)),
         TypeError),
        ("plan shape", table("plan", lambda t: t[:, :32].contiguous()),
         ValueError),
        ("scan dtype", table("scan", lambda t: t.to(torch.int16)),
         TypeError),
        ("rgt shape", table("rgt", lambda t: t[:2].contiguous()),
         ValueError),
        ("sig0p dtype", ebt("sig0p", lambda t: t.to(torch.float64)),
         TypeError),
        ("rlv shape", ebt("rlv", lambda t: t[:2].contiguous()), ValueError),
        ("context table length", ebt("one1", lambda t: t[:8].contiguous()),
         ValueError),
        ("sigCG bits", ebt("cg", lambda t: [t[0]]), ValueError),
    ]


@pytest.mark.parametrize("name,edit,error", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_binding_refuses_before_building(monkeypatch, name, edit, error):
    def build():
        raise AssertionError("the kernel was built for a refused input")
    monkeypatch.setattr(apply_kernel, "build", build)
    st = synthetic_step(5, 27, True, True, 0, "start", "cpu")
    kw = kernel_args(st)
    apply_kernel.check_inputs(**kw)             # the unedited inputs pass
    edit(kw)
    with pytest.raises(error):
        apply_kernel.class_step(**kw, sign_hide=True)


def test_binding_refuses_a_cpu_launch(monkeypatch):
    def build():
        raise AssertionError("the kernel was built for CPU tensors")
    monkeypatch.setattr(apply_kernel, "build", build)
    st = synthetic_step(0, 27, False, False, 0, "start", "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        apply_kernel.class_step(**kernel_args(st), sign_hide=False)


def test_entry_arguments_match_the_c_signature():
    argtypes = apply_kernel._ENTRIES["thevc_apply_step"]
    for ci, use_rdoq in ((0, True), (6, False)):
        st = synthetic_step(ci, 22, use_rdoq, True, 2, "end", "cpu")
        kw = kernel_args(st)
        ptrs, scalars = apply_kernel.arguments(**kw, sign_hide=True)
        # 6 record fields, starts, k, done, 3 per plane (2 planes), 7
        # tables, 9 estBits
        assert len(ptrs) == 6 + 3 + 6 + 7 + 9
        assert (ptrs[12] is None) == fa.CLS[ci][1]
        assert all(p is None for p in ptrs[-9:]) == (not use_rdoq)
        assert len(argtypes) == 1 + len(scalars) + 1
        size, luma, _ = fa.CLS[ci]
        assert scalars[:4] == [size, int(luma), 8, 1 if luma else 2]
        assert scalars[8:10] == [2, 1023]
        for j, (_r, _l, _w, qp, _q, lam) in enumerate(st.planes):
            assert scalars[6 + j] == qp
            assert scalars[10 + j] == float(np.float32(lam))
            assert scalars[12 + j] == apply_kernel.err_scale(qp, size, 2)


# -- the tables the kernel reads, against the JAX package --------------------

@pytest.mark.parametrize("ci", range(len(fa.CLS)), ids=[
    f"{s}{'y' if y else 'c'}{'_dst' if d else ''}" for s, y, d in fa.CLS])
def test_kernel_tables_equal_jax(ci):
    size, luma, use_dst = fa.CLS[ci]
    assert fa.CLS[ci] == jfa.CLS[ci]
    tab = {k: v.numpy() for k, v in fa.kernel_tables(
        ci, torch.device("cpu")).items()}
    for k, v in tab.items():
        assert v.dtype == np.int32, k
    scan = jfa._scan_tables(size)
    assert np.array_equal(tab["scan"], scan)
    _sig, rgt, low, *_ = jfa._rdoq_tables(size, luma)
    assert np.array_equal(tab["rgt"], rgt)
    assert np.array_equal(tab["low"], low)
    ia, ib, fr = jfi._unified_plan(size, luma)
    assert np.array_equal(tab["plan"], np.stack([ia, ib, fr]).reshape(
        3, 33, size * size))
    basis = jrom.DST4 if use_dst else jrom.DCT_MATRICES[size]
    assert np.array_equal(tab["basis"], basis)
    assert np.array_equal(tab["quant_scales"], jrom.QUANT_SCALES)
    assert np.array_equal(tab["inv_quant_scales"], jrom.INV_QUANT_SCALES)


@pytest.mark.parametrize("init", [(0, 22), (0, 37), (1, 32), (2, 27)],
                         ids=["I22", "I37", "P32", "B27"])
@pytest.mark.parametrize("ci", range(len(fa.CLS)))
def test_kernel_est_bits_equal_jax(ci, init):
    size, luma, _ = fa.CLS[ci]
    init_ctx = cc.make_context_states_idx(*init)
    ebt = fa.est_bits_tensors(init_ctx, size, luma, "cpu")
    want = jfa.est_bits_pack(np.asarray(init_ctx, np.uint8), size, luma)
    for key in ("sig0p", "sig1p", "rlv"):
        assert ebt[key].dtype == torch.float32
        assert np.array_equal(ebt[key].numpy(), want[key]), key
    for key, src, col in (("one0", "one", 0), ("one1", "one", 1),
                          ("abs0", "abs_", 0), ("abs1", "abs_", 1),
                          ("cbf0", "cbp", 0), ("cbf1", "cbp", 1)):
        pad = np.zeros(apply_kernel.CTX_PAD, np.float32)
        pad[:len(want[src])] = want[src][:, col]
        assert np.array_equal(ebt[key].numpy(), pad), key
    assert np.array_equal(np.asarray(ebt["cg"]), want["cg"])


# -- the card ----------------------------------------------------------------

def _step_ids():
    return [f"{s}{'y' if y else 'c'}" for s, y, _ in fa.CLS]


@pytest.mark.gpu
@pytest.mark.parametrize("window", ["start", "end"])
@pytest.mark.parametrize("bit_inc", [0, 2], ids=["8bit", "10bit"])
@pytest.mark.parametrize("sign_hide", [False, True], ids=["sbh0", "sbh"])
@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
@pytest.mark.parametrize("qp", [22, 27, 37])
@pytest.mark.parametrize("ci", range(len(fa.CLS)), ids=_step_ids())
def test_kernel_step_equals_plain(cuda, ci, qp, use_rdoq, sign_hide,
                                  bit_inc, window):
    st = synthetic_step(ci, qp, use_rdoq, sign_hide, bit_inc, window, cuda)
    want = clone_step(st)
    before = apply_kernel.launches
    fa._class_step(st)
    assert apply_kernel.launches - before == 1
    fa._step_plain(want)
    torch.cuda.synchronize()
    for (r, lv, *_), (r2, lv2, *_) in zip(st.planes, want.planes):
        assert torch.equal(lv, lv2)
        assert torch.equal(r, r2)
    assert int(st.k) == int(want.k) == 1
    assert int(st.done) == 0


def _apply_args(w, h, qp, use_rdoq, seed):
    planes, maps = nxn_frame(np.random.RandomState(seed), w, h)
    sched = fa.build_schedule(*maps, w, h, 64, 3, 2)
    lam = 0.57 * 2 ** ((qp - 12) / 3)
    return sched, (*planes, sched, w, h, qp, qp - 1, qp - 2, 64, 0, 255,
                   True, use_rdoq, lam, lam / 1.2,
                   cc.make_context_states_idx(0, qp))


@pytest.mark.gpu
@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("use_rdoq", [False, True], ids=["rdoq0", "rdoq"])
def test_whole_apply_on_nxn_maps(cuda, use_rdoq, qp):
    sched, args = _apply_args(128, 64, qp, use_rdoq, 24 + qp)
    steps = [int((np.diff(o) > 0).sum()) for o in sched.offs]
    assert all(steps), steps
    outs = {"cpu": fa.collect_device_apply(fa.run_device_apply(
        *args, device="cpu"))}
    for name, replay in (("eager", False), ("graph", True)):
        before = (apply_kernel.launches, residual_kernel.launches)
        run = fa.run_device_apply(*args, device=cuda, replay=replay)
        outs[name] = fa.collect_device_apply(run)
        # one launch a class step, and one warm-up a class before capture
        assert apply_kernel.launches - before[0] == sum(steps) + (
            len(steps) if replay else 0)
        assert residual_kernel.launches == before[1]
        assert run.class_steps == sum(steps)
    outs["plain"] = fa.collect_device_apply(fa.run_device_apply_plain(
        *args, device=cuda))
    want = outs["cpu"]
    for name in ("eager", "graph", "plain"):
        got = outs[name]
        for g, e in zip(got[:3] + got[3] + got[4],
                        want[:3] + want[3] + want[4]):
            assert (g is None and e is None) or np.array_equal(g, e), name
