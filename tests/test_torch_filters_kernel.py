"""The in-loop filter stage's dispatch and its hand-written CUDA kernel
(``ops.filters_kernel``, ``csrc/filters.cu``).

On the CPU: ``ops.filters.filter_pictures`` is the plain form and never
enters the kernel's binding; a call routed to the CUDA branch raises when
the binding fails and never runs the plain form; an unsupported device
raises; the binding refuses what the kernel does not take before building
anything; and on the real filter inputs of the decode-tool streams and a
10-bit low-delay B stream both packages build equal maps and SAO tables,
through which the port's stage equals the JAX package's ``filter_pictures``
(tolerance 0).

Marked ``gpu`` (each asks the ``cuda`` fixture for the card and skips
without one): the kernel against the plain form on the card, tolerance 0
and equal dtypes, over bit depths, filter switches, batch sizes, picture
sizes, offsets, maps and SAO parameters, and a CUDA graph's replay against
its eager call.  Run on the GPU machine with
``python -m pytest tests/test_torch_filters_kernel.py -m gpu``.
"""

import copy
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from thevc_tpu_torch import streams
from thevc_tpu_torch.decoder import filters as port_filters
from thevc_tpu_torch.decoder.top import Decoder
from thevc_tpu_torch.ops import filters as tf
from thevc_tpu_torch.ops import filters_kernel

# the legal (do_deblock, do_sao, do_sao_chroma); with both filters off the
# decoder never calls the stage
SWITCHES = [(True, False, False), (True, True, False), (True, True, True),
            (False, True, False), (False, True, True)]
# H, W, CTU: the kernel's tiling (64x64 luma, 32x32 chroma tiles with a
# 4-sample halo) meets a picture smaller than one tile, an 8-bit width
# whose rows are not 16-byte aligned (the per-sample path), and partial
# tiles at the right and bottom edges
SIZES = [(64, 64, 64), (240, 416, 64), (1080, 1920, 64), (8, 8, 16),
         (72, 200, 16), (136, 264, 32)]


def filter_inputs(rng, nb: int, h: int, w: int, ctu: int, bd: int,
                  u8: bool):
    """Seeded inputs of one filter call (numpy, as ``_filter_pictures``
    stacks them): luma of flat 8x8 blocks with a little noise and some
    noisy samples, where both strong and weak filters fire; one chroma
    plane noise, one flat 8x8 blocks; maps over the CTU-padded unit grid
    with bs 0-2, QPs from -12 to 51 and ``no_p``/``no_q`` set; every SAO
    type, half the band positions at 28-31 (they wrap), offsets pre-shifted
    as the decoder does.  Returns (arrays, CTU statics)."""
    uh, uw = -(-h // ctu) * ctu // 4, -(-w // ctu) * ctu // 4
    ctus_w, ctus_h = -(-w // ctu), -(-h // ctu)
    nctu = ctus_w * ctus_h
    scale = 1 << (bd - 8)
    dt = np.uint8 if u8 else np.int16
    blocks = rng.randint(96, 160, (nb, h // 8, w // 8)) * scale
    y = np.kron(blocks, np.ones((1, 8, 8), np.int64)) \
        + rng.randint(0, 2 * scale, (nb, h, w))
    y = np.where(rng.rand(nb, h, w) < 0.05,
                 rng.randint(0, 1 << bd, (nb, h, w)), y).astype(dt)
    cb = rng.randint(0, 1 << bd, (nb, h // 2, w // 2)).astype(dt)
    cr = (np.kron(rng.randint(60, 200, (nb, h // 16 + 1, w // 16 + 1))
                  * scale, np.ones((1, 8, 8), np.int64))[:, :h // 2, :w // 2]
          + rng.randint(0, 3, (nb, h // 2, w // 2))).astype(dt)

    def maps():
        return ((rng.rand(nb, uh, uw) < 0.8).astype(np.uint8),
                rng.randint(0, 3, (nb, uh, uw)).astype(np.uint8),
                rng.randint(-12, 52, (nb, uh, uw)).astype(np.int8),
                rng.randint(-12, 52, (nb, uh, uw)).astype(np.int8),
                (rng.rand(nb, uh, uw) < 0.1).astype(np.uint8),
                (rng.rand(nb, uh, uw) < 0.1).astype(np.uint8))
    types = rng.randint(-1, 5, (nb, 3, nctu)).astype(np.int8)
    band_pos = rng.randint(0, 32, (nb, 3, nctu)).astype(np.int32)
    wrap = rng.rand(nb, 3, nctu) < 0.5
    band_pos[wrap] = rng.randint(28, 32, int(wrap.sum()))
    offsets = (rng.randint(-7, 8, (nb, 3, nctu, 4))
               << (bd - min(bd, 10))).astype(np.int32)
    return ((y, cb, cr, maps(), maps(), types, band_pos, offsets),
            dict(ctu_size=ctu, ctus_w=ctus_w, ctus_h=ctus_h))


def to_device(arrs, device):
    y, cb, cr, dv, dh, types, band_pos, offsets = arrs

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(y), t(cb), t(cr), tuple(t(a) for a in dv),
            tuple(t(a) for a in dh), t(types), t(band_pos), t(offsets))


STATICS = dict(beta_offset=1, tc_offset=-2, bit_depth=8, do_deblock=True,
               do_sao=True, do_sao_chroma=True)


def small_call(device="cpu"):
    arrs, ctus = filter_inputs(np.random.RandomState(1), 2, 64, 96, 32, 8,
                               True)
    return to_device(arrs, device), dict(STATICS, **ctus)


# -- the dispatch, on the CPU

def test_cpu_runs_plain_and_never_the_binding(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel's binding was entered")
    monkeypatch.setattr(filters_kernel, "filter_pictures", refuse)
    monkeypatch.setattr(filters_kernel, "build", refuse)
    args, statics = small_call()
    before = filters_kernel.launches
    got = tf.filter_pictures(*args, out_u8=True, **statics)
    want = tf.filter_pictures_plain(*args, out_u8=True, **statics)
    assert filters_kernel.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, w)
    # filter_picture (one picture, int16) goes the same way
    one = tf.filter_picture(args[0][1], args[1][1], args[2][1],
                            tuple(a[1] for a in args[3]),
                            tuple(a[1] for a in args[4]), args[5][1],
                            args[6][1], args[7][1], **statics)
    for g, w in zip(one, want):
        assert g.dtype == torch.int16 and torch.equal(g, w[1].to(g.dtype))


def test_cuda_branch_raises_and_never_runs_plain(monkeypatch):
    calls = []

    def broken(*a, **kw):
        calls.append("kernel")
        raise RuntimeError("filter kernel launch failed: no device")

    def plain(*a, **kw):
        calls.append("plain")
        raise AssertionError("the plain form ran for a CUDA call")
    monkeypatch.setattr(filters_kernel, "filter_pictures", broken)
    monkeypatch.setattr(tf, "filter_pictures_plain", plain)
    monkeypatch.setattr(tf, "_filter_core", plain)
    args, statics = small_call()
    # no CUDA tensor exists here: the luma plane's stand-in lies on
    # ``cuda`` as far as the dispatcher's device test can tell
    args = [types.SimpleNamespace(device=torch.device("cuda")), *args[1:]]
    with pytest.raises(RuntimeError, match="filter kernel"):
        tf.filter_pictures(*args, **statics)
    assert calls == ["kernel"]


def test_unsupported_device_raises():
    args, statics = small_call("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tf.filter_pictures(*args, **statics)


def _refusals():
    """(name, edit of the arguments, expected error) for check_inputs."""
    def sub(i, f):
        def edit(args):
            args = list(args)
            args[i] = f(args[i])
            return args
        return edit

    def sub_map(d, k, f):
        def edit(args):
            args = list(args)
            maps = list(args[d])
            maps[k] = f(maps[k])
            args[d] = tuple(maps)
            return args
        return edit
    return [
        ("luma int32", sub(0, lambda t: t.to(torch.int32)), TypeError),
        ("chroma dtype differs", sub(1, lambda t: t.to(torch.int16)),
         TypeError),
        ("luma not batched", sub(0, lambda t: t[0]), ValueError),
        ("height not a multiple of 8", sub(0, lambda t: t[:, :60]),
         ValueError),
        ("width not a multiple of 8", sub(0, lambda t: t[:, :, :92]),
         ValueError),
        ("chroma shape", sub(2, lambda t: t[:, :16]), ValueError),
        ("luma not contiguous",
         sub(0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
         ValueError),
        ("qp_p int32", sub_map(3, 2, lambda t: t.to(torch.int32)),
         TypeError),
        ("flags bool", sub_map(4, 0, lambda t: t.bool()), TypeError),
        ("maps too small", lambda a: [*a[:3], tuple(m[:, :4] for m in a[3]),
                                      tuple(m[:, :4] for m in a[4]), *a[5:]],
         ValueError),
        ("horizontal maps differ", sub_map(4, 1, lambda t: t[:, :, :-1]),
         ValueError),
        ("no_q not contiguous",
         sub_map(3, 5, lambda t: t.transpose(1, 2).contiguous()
                 .transpose(1, 2)), ValueError),
        ("SAO types int32", sub(5, lambda t: t.to(torch.int32)), TypeError),
        ("SAO band positions shape", sub(6, lambda t: t[:, :2]), ValueError),
        ("SAO offsets int8", sub(7, lambda t: t.to(torch.int8)), TypeError),
    ]


@pytest.mark.parametrize("name,edit,error", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_binding_refuses_before_building(name, edit, error, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel was built")
    monkeypatch.setattr(filters_kernel, "build", refuse)
    args, statics = small_call()
    with pytest.raises(error):
        filters_kernel.filter_pictures(*edit(args), **statics)


@pytest.mark.parametrize("change", ["ctus_w", "bit_depth", "cpu"])
def test_binding_refuses_statics_and_host_tensors(change, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernel was built")
    monkeypatch.setattr(filters_kernel, "build", refuse)
    args, statics = small_call()
    if change == "ctus_w":
        statics["ctus_w"] -= 1          # the grid no longer covers W
        args = (*args[:5], *(a[:, :, :-2] for a in args[5:7]),
                args[7][:, :, :-2])
    elif change == "bit_depth":
        statics["bit_depth"] = 7
    with pytest.raises(ValueError):
        filters_kernel.filter_pictures(*args, **statics)


# -- the port's stage against the JAX package's on real decode inputs

@pytest.fixture(scope="module")
def filter_calls(tmp_path_factory):
    """Every ``_filter_pictures`` call of the CPU decodes of the decode-tool
    streams (without QP 22) and a 2-frame 10-bit low-delay B stream of the
    tool clip, its entries deep-copied when the call is made."""
    from thevc_tpu import native
    assert native.get_lib() is not None
    root = tmp_path_factory.mktemp("filter_calls")
    clips = streams.tool_clips(root)
    jobs = {name: (clips[clip], streams.INTRA_CFG, extra)
            for name, (clip, extra) in streams.TOOL_STREAMS.items()
            if name != "qp22"}
    jobs["ldb10"] = (clips["clip"],
                     streams.CFG / "encoder_lowdelay_tlayers.cfg",
                     ("--InternalBitDepth=10",))

    def encode(item):
        name, (clip, cfg, extra) = item
        stream = root / f"{name}.bin"
        streams.encode(clip, stream, root / f"{name}_rec.yuv",
                       streams.TOOL_W, streams.TOOL_H, streams.TOOL_FRAMES,
                       cfg=cfg, extra=extra)
        return name, stream
    with ThreadPoolExecutor(len(jobs)) as ex:
        made = dict(ex.map(encode, jobs.items()))
    calls = {}
    real = port_filters._filter_pictures
    for name, stream in made.items():
        calls[name] = []

        def record(entries, device, calls=calls[name]):
            calls.append(copy.deepcopy(entries))
            return real(entries, device)
        port_filters._filter_pictures = record
        try:
            pics = Decoder("cpu").decode_stream(stream.read_bytes())
        finally:
            port_filters._filter_pictures = real
        assert len(pics) == streams.TOOL_FRAMES
        assert all(p.digest_ok for p in pics)
    return calls


def _equal_inputs(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a[0] != b[0]:
        return False
    flat_a = [*a[1], *a[2], *a[3:]]
    flat_b = [*b[1], *b[2], *b[3:]]
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(flat_a, flat_b))


@pytest.mark.parametrize("name", ["pcm", "qp51", "dqp", "nofilt", "ldb10"])
def test_real_inputs_match_jax(name, filter_calls):
    from thevc_tpu.decoder import filters as jax_filters
    from thevc_tpu.ops import jx_filters
    calls = filter_calls[name]
    assert calls
    ran = 0
    for entries in calls:
        for f, sh, sps, pps, *rec, ref_poc in entries:
            ours = port_filters._picture_filter_inputs(f, sh, sps, pps,
                                                       ref_poc)
            theirs = jax_filters._picture_filter_inputs(f, sh, sps, pps,
                                                        ref_poc)
            assert _equal_inputs(ours, theirs)
            if ours is None:
                continue
            statics, dv, dh, types, band_pos, offsets = ours
            dt = np.uint8 if statics["bit_depth"] == 8 else np.int16
            planes = [p[None].astype(dt) for p in rec]
            host = (*planes, tuple(a[None] for a in dv),
                    tuple(a[None] for a in dh), types[None], band_pos[None],
                    offsets[None])
            for out_u8 in (True, False):
                want = jx_filters.filter_pictures(*host, out_u8=out_u8,
                                                  **statics)
                got = tf.filter_pictures(*to_device(host, "cpu"),
                                         out_u8=out_u8, **statics)
                for g, w in zip(got, want):
                    assert g.dtype == (torch.uint8 if out_u8
                                       else torch.int16)
                    assert np.array_equal(g.numpy(), np.asarray(w))
            ran += 1
    # the filters-off stream turns deblocking and SAO off: no filter call
    # for any of its pictures, in either package
    assert ran == (0 if name == "nofilt" else sum(map(len, calls)))


# -- the kernel on the card

@pytest.fixture
def cuda():
    # decided here, not at import: the test workers must all collect the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launches_of(statics) -> int:
    # one launch a call, whichever filters are on
    return 1


@pytest.mark.gpu
@pytest.mark.parametrize("hwc", SIZES, ids=[f"{w}x{h}" for h, w, _ in SIZES])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("switches", SWITCHES,
                         ids=["dbk", "dbk_sao", "dbk_sao_chroma", "sao",
                              "sao_chroma"])
@pytest.mark.parametrize("bd", [8, 10])
def test_kernel_equals_plain(cuda, bd, switches, nb, hwc):
    h, w, ctu = hwc
    seed = bd * 1000 + SWITCHES.index(switches) * 100 + nb * 10 \
        + SIZES.index(hwc)
    rng = np.random.RandomState(seed)
    arrs, ctus = filter_inputs(rng, nb, h, w, ctu, bd, bd == 8)
    beta_offset, tc_offset = (int(v) for v in rng.randint(-6, 7, 2))
    statics = dict(ctus, beta_offset=beta_offset, tc_offset=tc_offset,
                   bit_depth=bd, do_deblock=switches[0], do_sao=switches[1],
                   do_sao_chroma=switches[2], out_u8=bd == 8)
    args = to_device(arrs, cuda)
    before = filters_kernel.launches
    got = tf.filter_pictures(*args, **statics)
    torch.cuda.synchronize()
    assert filters_kernel.launches - before == _launches_of(statics)
    want = tf.filter_pictures_plain(*args, **statics)
    changed = False
    for g, wt, src in zip(got, want, args[:3]):
        assert g.dtype == wt.dtype
        assert torch.equal(g, wt)
        changed |= not torch.equal(g.to(torch.int32), src.to(torch.int32))
    if min(h, w) > 8:
        assert changed
    elif not switches[1]:
        # an 8x8 picture has no edge to filter (its one CTU's SAO may
        # change nothing either)
        assert not changed


@pytest.mark.gpu
@pytest.mark.parametrize("in_u8,out_u8", [(True, False), (False, True),
                                          (False, False)])
def test_kernel_dtype_combinations(cuda, in_u8, out_u8):
    rng = np.random.RandomState(3 + 2 * in_u8 + out_u8)
    arrs, ctus = filter_inputs(rng, 2, 72, 104, 32, 8, in_u8)
    for switches in SWITCHES + [(False, False, False)]:
        statics = dict(ctus, beta_offset=-3, tc_offset=4, bit_depth=8,
                       do_deblock=switches[0], do_sao=switches[1],
                       do_sao_chroma=switches[2], out_u8=out_u8)
        args = to_device(arrs, cuda)
        got = tf.filter_pictures(*args, **statics)
        want = tf.filter_pictures_plain(*args, **statics)
        for g, wt in zip(got, want):
            assert g.dtype == wt.dtype and torch.equal(g, wt)


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda):
    arrs, ctus = filter_inputs(np.random.RandomState(9), 2, 240, 416, 64, 8,
                               True)
    args = to_device(arrs, cuda)
    statics = dict(STATICS, **ctus, out_u8=True)
    eager = tf.filter_pictures(*args, **statics)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tf.filter_pictures(*args, **statics)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tf.filter_pictures(*args, **statics)
    for p in captured:
        p.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for g, e in zip(captured, eager):
        assert torch.equal(g, e)


@pytest.mark.gpu
@pytest.mark.parametrize("switches", SWITCHES + [(False, False, False)],
                         ids=["dbk", "dbk_sao", "dbk_sao_chroma", "sao",
                              "sao_chroma", "copy"])
def test_call_allocates_only_its_outputs(cuda, switches):
    arrs, ctus = filter_inputs(np.random.RandomState(5), 2, 240, 416, 64, 8,
                               True)
    args = to_device(arrs, cuda)
    statics = dict(ctus, beta_offset=2, tc_offset=-1, bit_depth=8,
                   do_deblock=switches[0], do_sao=switches[1],
                   do_sao_chroma=switches[2], out_u8=False)
    tf.filter_pictures(*args, **statics)       # the tables, built once
    torch.cuda.synchronize()
    # what three tensors of the outputs' shapes and dtype take
    before = torch.cuda.memory_allocated()
    like = [torch.empty_like(p, dtype=torch.int16) for p in args[:3]]
    outputs = torch.cuda.memory_allocated() - before
    del like
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = tf.filter_pictures(*args, **statics)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before == outputs
    assert torch.cuda.max_memory_allocated() - before == outputs
    assert all(g.dtype == torch.int16 for g in got)
