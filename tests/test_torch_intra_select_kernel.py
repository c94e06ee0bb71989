"""The intra decision pass's selection kernels (``csrc/intra_select.cu``:
the MPM and top-3 select, the RD pick and the quadtree DP) against their
plain forms (``encoder/fast_intra.py``) on the card.

Every test is marked ``gpu`` and asks the ``cuda`` fixture for the card,
skipping without one (the refusals that need no card are in
``tests/test_torch_intra_select.py``).  Each kernel equals its plain form
run on the same CUDA tensors, tolerance 0 (ints equal, floats equal as
bits): the select and the pick, one launch each over every luma class,
on the sweeps and TU-RDs of seeded frames at CTU 16, 32 and 64 and 8 and
10 bits; the select on 1080p class tables at every CTU size with ties
planted (equal costs from different SATDs and bit classes at
sqrt-lambda 2, whole rows equal); the pick on 1080p class tables
(and the 4x4 class's NxN ids) with tied RD costs; the DP on seeded
leaves and chroma candidates for I, P and B slices, CTU 16, 32 and 64,
1080p and frames that are no CTU multiple, the NxN gate opened, MVs past
int16; whole I decision passes at 8 and 10 bits and P and B passes on
``cuda`` equal to the CPU's, one select, one pick and one DP launch a
pass; and each entry replays in a CUDA graph.  Run
on the GPU machine with
``python -m pytest tests/test_torch_intra_select_kernel.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from thevc_tpu_torch.encoder import fast_inter
from thevc_tpu_torch.encoder import fast_intra as fi
from thevc_tpu_torch.ops import intra_select_kernel as kern

pytestmark = pytest.mark.gpu

SIZES = (4, 8, 16, 32, 64)
BITS3 = (1.0, 2.0, 5.5)
SQRT_LAM, LAM = 7.55, 57.0
CBITS2 = (0.5, 3.5, 1.1)


@pytest.fixture
def cuda():
    # decided here, not at import: the test workers must all collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def same(got, want, what: str) -> None:
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for k, (a, b) in enumerate(zip(got, want)):
            same(a, b, f"{what}[{k}]")
        return
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            same(got[k], want[k], f"{what}[{k}]")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    bad = int((got != want).sum())
    assert bad == 0, f"{what}: {bad} of {got.numel()} differ"


def _f32(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def select_table(seed: int, ctu: int, wp: int, hp: int, dev) -> dict:
    """A class table for the select: every class up to ``ctu`` of a
    wp x hp frame, seeded SATDs whose costs tie at sqrt-lambda 2 (bits *
    sqrt_lam 2, 4 and 11; SATDs a base plus 0, 2, 7 or 9) and every fifth
    row all equal, with their first-minimum modes."""
    rng = np.random.RandomState(seed)
    out = {}
    for s in SIZES:
        if s > ctu:
            break
        nby, nbx = hp // s, wp // s
        nb = nby * nbx
        satd = rng.choice([0, 2, 7, 9], (nb, 35)) + rng.randint(0, 4000,
                                                                (nb, 1))
        satd[::5] = 300
        satd = torch.from_numpy(satd.astype(np.int32)).to(dev)
        out[s] = (satd, satd.argmin(dim=1).to(torch.int32), nby, nbx)
    return out


@pytest.mark.parametrize("sqrt_lam", [2.0, SQRT_LAM])
@pytest.mark.parametrize("ctu", [16, 32, 64])
def test_select_equals_plain(cuda, ctu, sqrt_lam):
    classes = select_table(ctu, ctu, 1920, 1088, cuda)
    args = (classes, ctu, tuple(_f32(b, cuda) for b in BITS3),
            _f32(sqrt_lam, cuda))
    kern.select_launches = 0
    got = kern.select(*args)
    assert kern.select_launches == 1
    same(got, fi.intra_select_pass_plain(*args),
         f"select ctu={ctu} sqrt_lam={sqrt_lam}")


def pick_inputs(seed: int, nb: int, dev) -> tuple:
    rng = np.random.RandomState(seed)
    topk = np.stack([rng.permutation(35)[:3] for _ in range(min(nb, 4096))])
    topk = np.resize(topk, (nb, 3)).astype(np.int32)
    mbits = np.asarray(BITS3, np.float32)[rng.randint(0, 3, (nb, 3))]
    dist = rng.randint(0, 6, (nb, 3)) * 16 + rng.randint(0, 9000, (nb, 1))
    cbits = (rng.randint(0, 80, (nb, 3)) / 8.0).astype(np.float32)
    # ties: equal dist and bits, so equal RD costs
    dist[::4] = dist[::4, :1]
    cbits[::4] = cbits[::4, :1]
    mbits[::4] = mbits[::4, :1]
    return tuple(torch.from_numpy(a).to(dev) for a in (
        topk, mbits, dist.astype(np.int32).reshape(-1), cbits.reshape(-1)))


def pick_table(seed: int, ctu: int, wp: int, hp: int, dev) -> dict:
    return {s: (*pick_inputs(seed + s, (hp // s) * (wp // s), dev), hp // s,
                wp // s) for s in SIZES if s <= ctu}


@pytest.mark.parametrize("ctu", [16, 32, 64])
def test_pick_equals_plain(cuda, ctu):
    args = (pick_table(ctu, ctu, 1920, 1088, cuda), ctu, _f32(LAM, cuda))
    kern.pick_launches = 0
    got = kern.pick(*args)
    assert kern.pick_launches == 1
    same(got, fi.intra_pick_pass_plain(*args), f"pick ctu={ctu}")


@pytest.mark.parametrize("ctu", [16, 32, 64])
@pytest.mark.parametrize("bit_inc", [0, 2])
def test_select_and_pick_equal_plain_on_a_pass(cuda, ctu, bit_inc):
    w, h = 200, 136
    args = i_args(w, h, ctu, bit_inc, ctu + bit_inc)
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    py = torch.from_numpy(np.ascontiguousarray(fi._source_planes(
        *args[:5], ctu)[0], np.int16)).to(cuda)
    max_val = (256 << bit_inc) - 1
    qp = torch.tensor(args[5], dtype=torch.int32, device=cuda)
    bits3 = tuple(_f32(b, cuda) for b in BITS3)
    grids = {s: (hp // s, wp // s) for s in SIZES if s <= ctu}
    classes = {s: (*fi.intra_sweep(py, s, *g, bit_inc, max_val), *g)
               for s, g in grids.items()}
    sel = (classes, ctu, bits3, _f32(SQRT_LAM, cuda))
    zero_counts()
    top = kern.select(*sel)
    same(top, fi.intra_select_pass_plain(*sel), f"select ctu={ctu}")
    cands = {s: (*top[s], *fi.tu_rd_modes((py,), s, *g, top[s][0], (qp,),
                                          bit_inc, max_val, luma=True), *g)
             for s, g in grids.items()}
    pk = (cands, ctu, _f32(LAM, cuda))
    same(kern.pick(*pk), fi.intra_pick_pass_plain(*pk), f"pick ctu={ctu}")
    assert counts() == dict(select=1, pick=1, dp=0)


def dp_inputs(seed: int, ctu: int, wp: int, hp: int, kind: str, dev):
    """Seeded DP inputs on ``dev``: LumaClass-like tuples, ChromaCands
    and inter leaves (None, P or B)."""
    rng = np.random.RandomState(seed)
    lam = _f32(LAM, dev)
    lam_w_bits2 = ((_f32(CBITS2[0], dev), _f32(CBITS2[1], dev)), lam,
                   _f32(CBITS2[2], dev))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def cands(s):
        nby, nbx = hp // s, wp // s
        nb = nby * nbx
        best = t(rng.randint(0, 35, nb).astype(np.int32))
        dist = rng.randint(0, s ** 3, 2 * nb * 5)
        bits = (rng.randint(0, 400, 2 * nb * 5) / 8.0).astype(np.float32)
        dist.reshape(2, nb, 5)[:, ::3] = dist.reshape(2, nb, 5)[:, ::3, :1]
        bits.reshape(2, nb, 5)[:, ::3] = bits.reshape(2, nb, 5)[:, ::3, :1]
        return fi.ChromaCands(fi._chroma_ids(best).reshape(nby, nbx, 5),
                              t(dist.astype(np.int32)), t(bits))
    res, cres, inter = {}, {}, {}
    for s in SIZES:
        if s > ctu:
            continue
        n = (hp // s, wp // s)
        res[s] = tuple(t(a) for a in (
            rng.randint(0, 35, n).astype(np.int32),
            rng.randint(0, 10 * s ** 3, n).astype(np.int32),
            (rng.rand(*n) * s).astype(np.float32),
            rng.randint(0, 35, n).astype(np.int32),
            rng.randint(0, 35, n).astype(np.int32)))
        if s < 8:
            continue
        cres[s] = cands(s)
        leaf = [(rng.rand(*n) * 12 * s ** 3).astype(np.float32),
                rng.randint(-40000, 40000, n), rng.randint(-300, 300, n),
                rng.randint(0, 4, n)]
        if kind == "B":
            leaf += [rng.randint(1, 4, n), rng.randint(-300, 300, n),
                     rng.randint(-40000, 40000, n), rng.randint(0, 4, n)]
        inter[s] = tuple(t(a if k == 0 else a.astype(np.int32))
                         for k, a in enumerate(leaf))
    return (res, cres, cands(8), lam, lam_w_bits2,
            None if kind == "I" else inter)


DP_CASES = [  # kind, ctu, width, height, max_sig, min_tr_log2
    ("I", 64, 1920, 1080, 3, 2),
    ("P", 64, 1920, 1080, 3, 2),
    ("B", 64, 1920, 1080, 3, 2),
    ("I", 64, 200, 136, 4, 2),          # the NxN gate open (no legal SPS)
    ("B", 64, 136, 72, 4, 2),
    ("I", 32, 96, 72, 3, 2),
    ("P", 32, 120, 88, 2, 3),
    ("I", 16, 72, 40, 1, 2),
    ("B", 16, 40, 24, 2, 2),
]


@pytest.mark.parametrize("kind,ctu,w,h,max_sig,mtl", DP_CASES)
def test_dp_equals_plain(cuda, kind, ctu, w, h, max_sig, mtl):
    wp, hp = -(-w // ctu) * ctu, -(-h // ctu) * ctu
    res, cres, cres8, lam, lw2, inter = dp_inputs(w + ctu, ctu, wp, hp,
                                                  kind, cuda)
    pen = fast_inter._INTRA_PEN_BITS if inter is not None else 0.0
    args = (res, cres, cres8, w, h, lam, lw2, max_sig, mtl, ctu, wp, hp,
            inter, pen)
    kern.dp_launches = 0
    got = kern.dp(*args)
    assert kern.dp_launches == 1
    want = fi.intra_dp_plain(*args)
    same(got, want, f"dp {kind} ctu={ctu} {w}x{h}")
    if max_sig == 4:
        assert bool(got[2].any()), "no NxN CU"
    if inter is not None:
        assert bool(got[6].any()) and not bool(got[6].all())


def _content(rng, h: int, w: int, bit_inc: int) -> np.ndarray:
    hi = 256 << bit_inc
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0))
    noise = rng.randint(0, 24, (h, w))
    out = ((base + noise) * (1 << bit_inc) % hi).astype(np.int16)
    out[:h // 3] = 100 << bit_inc                 # a flat band: ties
    return out


def i_args(w: int, h: int, ctu: int, bit_inc: int, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    y, cb, cr = (_content(rng, h // d, w // d, bit_inc) for d in (1, 2, 2))
    qp = 32 + 6 * bit_inc
    max_sig = {16: 1, 32: 2, 64: 3}[ctu]
    return (y, cb, cr, w, h, qp, qp - 2, qp - 1, 57.0, 7.55, BITS3, CBITS2,
            max_sig, 2, ctu, bit_inc, (256 << bit_inc) - 1)


def counts() -> dict:
    return dict(select=kern.select_launches, pick=kern.pick_launches,
                dp=kern.dp_launches)


def zero_counts() -> None:
    kern.select_launches = kern.pick_launches = kern.dp_launches = 0


@pytest.mark.parametrize("w,h,ctu,bit_inc", [(200, 136, 64, 0),
                                             (200, 136, 64, 2),
                                             (96, 72, 32, 0),
                                             (72, 40, 16, 2)])
def test_i_pass_cuda_equals_cpu(cuda, w, h, ctu, bit_inc):
    args = i_args(w, h, ctu, bit_inc, w + bit_inc)
    zero_counts()
    got = fi.decide_frame(*args, device="cuda")
    assert counts() == dict(select=1, pick=1, dp=1)
    want = fi.decide_frame(*args, device="cpu")
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"map {k}"


@pytest.mark.parametrize("b_slice", [False, True])
def test_pb_pass_cuda_equals_cpu(cuda, b_slice):
    rng = np.random.RandomState(9)
    w, h = 192, 128
    cur = tuple(_content(rng, h // d, w // d, 0) for d in (1, 2, 2))
    r0 = (1, *(np.roll(p, 2 // d, 1) for p, d in zip(cur, (1, 2, 2))))
    r1 = (0, *(np.roll(p, -3 // d, 0) for p, d in zip(cur, (1, 2, 2))))
    args = (*cur, [r0, r1], w, h, 32, 30, 30, 57.92, 7.61, 7.61, BITS3,
            CBITS2, 4, 2, 64, 64, 0, 255)
    l1 = [r1, r0] if b_slice else None
    zero_counts()
    got = fast_inter.decide_frame_p(*args, ref_pics_l1=l1, device="cuda")
    assert counts() == dict(select=1, pick=1, dp=1)
    want = fast_inter.decide_frame_p(*args, ref_pics_l1=l1, device="cpu")
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"map {k}"


def test_entries_replay_in_a_graph(cuda):
    bits3 = tuple(_f32(b, cuda) for b in BITS3)
    sel = (select_table(1, 64, 1920, 1088, cuda), 64, bits3,
           _f32(SQRT_LAM, cuda))
    pk = (pick_table(2, 64, 1920, 1088, cuda), 64, _f32(LAM, cuda))
    res, cres, cres8, lam, lw2, inter = dp_inputs(3, 64, 1920, 1088, "B",
                                                  cuda)
    dp = (res, cres, cres8, 1920, 1080, lam, lw2, 3, 2, 64, 1920, 1088,
          inter, 8.0)
    eager = (kern.select(*sel), kern.pick(*pk), kern.dp(*dp))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern.select(*sel), kern.pick(*pk), kern.dp(*dp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (kern.select(*sel), kern.pick(*pk), kern.dp(*dp))
    for t in (out[0][4][0], out[0][64][1], out[1][4][0], out[1][16][5],
              out[2]):
        t.fill_(-1) if t.dtype != torch.float32 else t.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    same(list(out), list(eager), "graph replay")
