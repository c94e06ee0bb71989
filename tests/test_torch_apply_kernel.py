"""The fast-RD device apply's frame kernel (``ops.apply_kernel``,
``csrc/apply.cu``) and its dispatch (``encoder.fast_apply.apply_items``).

On the CPU: the dispatcher runs the plain version
(``apply_items_plain``: the items in list order through
``_class_step_plain``) and never enters the kernel's binding, and on a
class step's one-wave item list that equals the plain class step
(``_step_plain``); routed to the CUDA branch with a failing binding it
raises and never runs the plain form; an unsupported device raises; the
binding refuses what the kernel does not take before building anything;
the entry's argument arrays follow the C signature; and the tables the
kernel reads equal the JAX package's (``thevc_tpu/encoder/fast_apply.py``
``_scan_tables`` :156, ``_rdoq_tables`` :245, ``est_bits_pack`` :312, and
the angular plans of ``thevc_tpu/encoder/fast_intra.py:_unified_plan``) at
every class.  The plain form against the JAX package is
``tests/test_torch_fast_apply_jax.py``; the item list, the wait rule and
a dataflow emulation are ``tests/test_torch_apply_frame.py``.

Marked ``gpu`` (each asks the ``cuda`` fixture for the card and skips
without one): one class step's one-wave item list through the frame
kernel against ``_step_plain`` on the card, tolerance 0, at every class,
QP 22/27/37, RDOQ and SBH on and off, 8 and 10 bits, on windows at the
start of the records and at their padded end; and whole applies on
``streams.nxn_frame`` maps, the kernel (one launch a frame) against the
plain form on ``cuda`` and against the CPU.  Run on the GPU machine with
``python -m pytest tests/test_torch_apply_kernel.py -m gpu``.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from thevc_tpu.common import rom as jrom
from thevc_tpu.encoder import fast_apply as jfa
from thevc_tpu.encoder import fast_intra as jfi
from thevc_tpu_torch.cabac import contexts as cc
from thevc_tpu_torch.encoder import fast_apply as fa
from thevc_tpu_torch.ops import apply_kernel, build, residual_kernel
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
    counter)."""
    planes = [(rec.clone(), lv.clone(), wins, qp, qv, lam)
              for rec, lv, wins, qp, qv, lam in st.planes]
    return fa.ClassStep(st.ci, planes, st.flat, st.starts, st.rows, st.ebt,
                        st.bit_inc, st.max_val, st.sign_hide, st.use_rdoq)


def step_items(st):
    """A class step's window as a one-wave item list for the frame entry:
    its rows on each of its planes (the real ones with their source
    windows placed into a source plane of the picture, the padding ones
    reading zeros), every unit flagged written (the synthetic records
    read the plane as it is).  Returns the dispatcher's keyword
    arguments; their level buffer holds each plane's stack in turn."""
    size, luma, _ = fa.CLS[st.ci]
    device = st.k.device
    unit = 4 if luma else 2
    xs, ys, lo, hi, mode, scan = (t.cpu().numpy() for t in st.flat)
    rec0 = st.planes[0][0]
    hp, wp = rec0.shape[0] - 1 - GUARD, rec0.shape[1] - 1 - GUARD
    n_flat = len(xs)
    n_real = int((xs < wp).sum())       # padding rows lie in the guard
    rows = int(st.starts[0]) + np.arange(len(st.rows))
    plane_ids = (0,) if luma else (1, 2)
    items = []
    for j, p in enumerate(plane_ids):
        for r in rows:
            items.append([xs[r], ys[r], lo[r], hi[r], mode[r], scan[r],
                          apply_kernel.kind(st.ci, p, r < n_real),
                          (j * n_flat + r) * size * size])
    dummy = torch.zeros((1, 1), dtype=torch.int16, device=device)
    recs, orgs = [dummy] * 3, [dummy] * 3
    for p, (rec, _lv, wins, *_rest) in zip(plane_ids, st.planes):
        org = np.zeros((hp, wp), np.int16)
        w = wins.cpu().numpy()
        for r in range(n_real):
            org[ys[r]:ys[r] + size, xs[r]:xs[r] + size] = w[r]
        recs[p] = rec
        orgs[p] = torch.from_numpy(org).to(device)
    qps = [0, 0, 0]
    lams = [1.0, 1.0, 1.0]
    for p, (_r, _l, _w, qp, _qv, lam) in zip(plane_ids, st.planes):
        qps[p], lams[p] = qp, lam
    return dict(
        items=np.array(items, np.int32), recs=recs, orgs=orgs,
        lv=torch.cat([lv.reshape(-1) for _r, lv, *_ in st.planes]),
        ready=torch.ones((3, hp // unit, wp // unit), dtype=torch.int32,
                         device=device),
        state=torch.zeros(apply_kernel.STATE_WORDS, dtype=torch.int32,
                          device=device),
        qps=qps, lams=lams,
        ebts=None if st.ebt is None else {st.ci: st.ebt},
        bit_inc=st.bit_inc, max_val=st.max_val, sign_hide=st.sign_hide)


def kernel_args(st):
    """The binding's arguments for a step's one-wave item list (as
    ``apply_items`` passes them), with its class's tables on the step's
    device."""
    kw = step_items(st)
    kw["tables"] = {st.ci: fa.kernel_tables(st.ci, st.k.device)}
    return kw


def step_levels(st, kw):
    """The level stacks of a step's planes out of the item list's level
    buffer."""
    return kw["lv"].view(len(st.planes), *st.planes[0][1].shape)


# -- the CPU: dispatch and refusals -----------------------------------------

def test_cpu_step_is_the_plain_form(monkeypatch):
    def kernel(*a, **kw):
        raise AssertionError("the kernel's binding ran for a CPU apply")
    monkeypatch.setattr(apply_kernel, "apply_frame", kernel)
    st = synthetic_step(1, 27, True, True, 0, "start", "cpu")
    want = clone_step(st)
    kw = step_items(st)
    fa.apply_items(**kw)
    fa._step_plain(want)
    for j, (r2, lv2, *_) in enumerate(want.planes):
        assert torch.equal(st.planes[j][0], r2)
        assert torch.equal(step_levels(st, kw)[j], lv2)
    assert int(want.k) == 1


def test_cpu_apply_never_enters_the_kernel(monkeypatch):
    def kernel(*a, **kw):
        raise AssertionError("the kernel's binding ran for a CPU apply")
    monkeypatch.setattr(apply_kernel, "apply_frame", kernel)
    w, h, qp = 64, 64, 32
    planes, maps = nxn_frame(np.random.RandomState(3), w, h)
    sched = fa.build_schedule(*maps, w, h, 64, 3, 2)
    args = (*planes, sched, w, h, qp, qp - 1, qp - 2, 64, 0, 255, True,
            True, 20.0, 16.0, cc.make_context_states_idx(0, qp))
    run = fa.run_device_apply(*args, device="cpu")
    assert run.n_items == 0 and run.state is None
    got = fa.collect_device_apply(run)
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
        raise AssertionError("the plain form ran for a CUDA apply")
    monkeypatch.setattr(apply_kernel, "apply_frame", broken)
    monkeypatch.setattr(fa, "apply_items_plain", plain)
    monkeypatch.setattr(fa, "_class_step_plain", plain)
    monkeypatch.setattr(fa, "kernel_tables", lambda ci, device: {})
    st = synthetic_step(4, 27, True, True, 0, "start", "cpu")
    kw = step_items(st)
    # no CUDA tensor exists here: the first plane's stand-in lies on
    # ``cuda`` as far as the dispatcher's device test can tell
    rec = types.SimpleNamespace(device=torch.device("cuda"))
    kw["recs"] = [rec, *kw["recs"][1:]]
    with pytest.raises(RuntimeError, match="apply kernel"):
        fa.apply_items(**kw)
    assert calls == ["kernel"]


def test_unsupported_device_raises():
    st = synthetic_step(2, 27, False, True, 0, "start", "cpu")
    kw = step_items(st)
    kw["recs"] = [torch.empty(r.shape, dtype=r.dtype, device="meta")
                  for r in kw["recs"]]
    with pytest.raises(ValueError, match="unsupported device"):
        fa.apply_items(**kw)


def _refusals():
    """(name, edit of the binding's arguments, expected error)."""
    def plane(key, j, f):
        def edit(kw):
            planes = list(kw[key])
            planes[j] = f(planes[j])
            kw[key] = planes
        return edit

    def setk(key, value):
        def edit(kw):
            kw[key] = value(kw) if callable(value) else value
        return edit

    def item(col, f):
        def edit(kw):
            items = kw["items"].copy()
            items[0, col] = f(items[0])
            kw["items"] = items
        return edit

    def table(key, f):
        def edit(kw):
            tab = kw["tables"][5]
            kw["tables"] = {5: dict(tab, **{key: f(tab[key])})}
        return edit

    def ebt(key, f):
        def edit(kw):
            e = kw["ebts"][5]
            kw["ebts"] = {5: dict(e, **{key: f(e[key])})}
        return edit
    return [
        ("unknown class", item(6, lambda r: 7 | (r[6] & ~15)), ValueError),
        ("class not an int",
         setk("tables", lambda kw: {5.0: kw["tables"][5]}), ValueError),
        ("one plane for chroma", item(6, lambda r: r[6] & ~(3 << 4)),
         ValueError),
        ("plane dtype",
         plane("recs", 1, lambda t: t.to(torch.int32)), TypeError),
        ("plane shapes differ",
         plane("recs", 2, lambda t: t[:-1].contiguous()), ValueError),
        ("plane not contiguous",
         plane("recs", 1, lambda t: t.t().contiguous().t()), ValueError),
        ("plane 1-D", plane("recs", 1, lambda t: t.reshape(-1)), ValueError),
        ("level stack dtype", setk("lv", lambda kw: kw["lv"].to(torch.int32)),
         TypeError),
        ("level stack shape",
         setk("lv", lambda kw: kw["lv"].view(2, -1)), ValueError),
        ("source dtype",
         plane("orgs", 1, lambda t: t.to(torch.uint8)), TypeError),
        ("QP above 63", setk("qps", [0, 64, 30]), ValueError),
        ("negative QP", setk("qps", [0, 30, -1]), ValueError),
        ("seven item fields",
         setk("items", lambda kw: kw["items"][:, :7].copy()), ValueError),
        ("item dtype",
         setk("items", lambda kw: kw["items"].astype(np.int64)), ValueError),
        ("level row past the stacks",
         item(7, lambda r: r[7] + 10 ** 6), ValueError),
        ("ready dtype",
         setk("ready", lambda kw: kw["ready"].to(torch.int64)), TypeError),
        ("state shape",
         setk("state", torch.zeros(2, dtype=torch.int32)), ValueError),
        ("state dtype", setk("state", torch.zeros(3, dtype=torch.int64)),
         TypeError),
        ("ready maps of two planes",
         setk("ready", lambda kw: kw["ready"][:2].contiguous()), ValueError),
        ("TU outside its source", item(0, lambda r: 10 ** 4), ValueError),
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
        ("range past the line", item(3, lambda r: 10 ** 3), ValueError),
        ("mode out of range", item(4, lambda r: 35), ValueError),
        ("class without tables", item(6, lambda r: 6 | (r[6] & ~15)),
         ValueError),
        ("TU off the unit grid", item(0, lambda r: r[0] + 1), ValueError),
        ("ready maps 2-D", setk("ready", lambda kw: kw["ready"][0]),
         ValueError),
        ("RDOQ without a class's estBits", setk("ebts", {}), ValueError),
    ]


@pytest.mark.parametrize("name,edit,error", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_binding_refuses_before_building(monkeypatch, name, edit, error):
    def build():
        raise AssertionError("the kernel was built for a refused input")
    monkeypatch.setattr(apply_kernel, "build", build)
    st = synthetic_step(5, 27, True, True, 0, "start", "cpu")
    kw = kernel_args(st)
    apply_kernel.check_inputs(**{k: v for k, v in kw.items()
                                 if k not in ("lams", "sign_hide")})
    apply_kernel.check_items(kw["items"], [tuple(o.shape)
                                           for o in kw["orgs"]],
                             tuple(kw["ready"].shape[1:]), kw["lv"].numel(),
                             kw["tables"])      # the unedited inputs pass
    edit(kw)
    with pytest.raises(error) as refused:
        apply_kernel.apply_frame(**kw)
    # refused for the input, not for lying on the CPU
    assert "CUDA tensors" not in str(refused.value)


def test_binding_refuses_a_cpu_launch(monkeypatch):
    def build():
        raise AssertionError("the kernel was built for CPU tensors")
    monkeypatch.setattr(apply_kernel, "build", build)
    st = synthetic_step(0, 27, False, False, 0, "start", "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        apply_kernel.apply_frame(**kernel_args(st))


def _c_signature(name):
    """The parameter types of an ``extern "C"`` entry of ``csrc/apply.cu``."""
    src = (build.CSRC / "apply.cu").read_text()
    at = src.index(f'extern "C" int {name}(')
    params = src[src.index("(", at) + 1:src.index(")", at)]
    return [" ".join(p.split()[:-1]) for p in params.split(",")]


def test_entry_arguments_match_the_c_signature():
    ctypes_of = {"const void* const*": "p", "const int*": "p",
                 "const float*": "p", "void*": "p", "int*": "p", "int": "i"}
    for entry, argtypes in apply_kernel._ENTRIES.items():
        want = [ctypes_of[t] for t in _c_signature(entry)]
        got = ["i" if t is ctypes.c_int else "p" for t in argtypes]
        assert got == want, entry
    for ci, use_rdoq in ((0, True), (6, False)):
        st = synthetic_step(ci, 22, use_rdoq, True, 2, "end", "cpu")
        kw = kernel_args(st)
        items = torch.from_numpy(kw["items"])
        ptrs, ints, floats = apply_kernel.arguments(
            items, kw["recs"], kw["orgs"], kw["lv"], kw["ready"],
            kw["state"], kw["tables"], kw["ebts"], kw["qps"], kw["lams"],
            kw["bit_inc"], kw["max_val"], kw["sign_hide"])
        assert len(ptrs) == apply_kernel.N_PTRS == 12 + 7 * 14
        assert len(ints) == apply_kernel.N_INTS
        assert len(floats) == apply_kernel.N_FLOATS
        assert ptrs[:3] == [items.data_ptr(), kw["state"].data_ptr(),
                            kw["ready"].data_ptr()]
        assert ptrs[3:6] == [t.data_ptr() for t in kw["recs"]]
        assert ptrs[6:9] == [t.data_ptr() for t in kw["orgs"]]
        assert ptrs[9] == kw["lv"].data_ptr()
        for c in range(7):
            block = ptrs[12 + 14 * c:26 + 14 * c]
            assert all(p is not None for p in block[:5]) == (c == ci)
            assert all(p is None for p in block[5:]) == (
                c != ci or not use_rdoq)
        size, luma, _ = fa.CLS[ci]
        assert ints[:3] == [int(t.shape[0]) for t in kw["recs"]]
        assert ints[12:15] == [kw["ready"].shape[1], kw["ready"].shape[2],
                               kw["lv"].numel()]
        assert ints[15:18] == kw["qps"]
        assert ints[18:] == [2, 1023, 1, int(use_rdoq)]
        for p in range(3):
            assert floats[p] == float(np.float32(kw["lams"][p]))
            for j, s in enumerate((4, 8, 16, 32)):
                assert floats[3 + 4 * p + j] == apply_kernel.err_scale(
                    kw["qps"][p], s, 2)
        cg = floats[15 + 4 * ci:19 + 4 * ci]
        assert cg == ([float(v) for row in st.ebt["cg"] for v in row]
                      if use_rdoq else [0.0] * 4)


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
    kw = step_items(st)
    before = apply_kernel.launches
    fa.apply_items(**kw)
    assert apply_kernel.launches - before == 1
    fa._step_plain(want)
    torch.cuda.synchronize()
    for j, (r2, lv2, *_) in enumerate(want.planes):
        assert torch.equal(step_levels(st, kw)[j], lv2)
        assert torch.equal(st.planes[j][0], r2)
    ticket, error, waited = kw["state"].tolist()
    assert error == 0 and waited == 0
    assert ticket >= len(kw["items"])


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
    before = (apply_kernel.launches, residual_kernel.launches)
    run = fa.run_device_apply(*args, device=cuda)
    assert run.graphs == {}
    outs["kernel"] = fa.collect_device_apply(run)
    # one launch a frame, no K1
    assert apply_kernel.launches - before[0] == 1
    assert residual_kernel.launches == before[1]
    assert run.class_steps == sum(steps)
    assert run.n_items == len(fa.frame_items(sched,
                                             fa.level_layout(sched)[0]))
    ticket, error, waited = run.state.tolist()
    assert error == 0 and ticket >= run.n_items and waited >= 0
    outs["plain"] = fa.collect_device_apply(fa.run_device_apply_plain(
        *args, device=cuda))
    want = outs["cpu"]
    for name in ("kernel", "plain"):
        got = outs[name]
        for g, e in zip(got[:3] + got[3] + got[4],
                        want[:3] + want[3] + want[4]):
            assert (g is None and e is None) or np.array_equal(g, e), name
