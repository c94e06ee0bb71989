"""The premises of the intra decision kernels' design (``csrc/intra_rd.cu``),
checked on the CPU with numpy and the port's own tables (no JAX, no card).

- The TU-RD kernel runs its four transform passes on the int8 tensor
  cores with each int16 operand split 256 hi + lo.  That needs the
  forward first pass's output to fit int16: for every TU size (the 4x4
  DST and DCT, 8, 16, 32) and every bit increment the wrapper takes, its
  largest output on worst-case residuals (each row's basis signs times the
  largest residual of the int16 planes, min(2^(8 + bit_inc) - 1, 32767)),
  rounding offset included, fits; the split's recombination is exact for
  every int16.
- The sweep's Hadamard first pass fits int16 exactly when bit_inc <= 4
  (the kernel's tensor-core form; butterflies above).
- The sweep's prediction in float32: (32 - f) a + f b + 0.5 then one FMA by
  1/32 into 1.5 * 2^23 gives 1.5 * 2^23 + ((32 - f) a + f b + 16) >> 5
  exactly, for every weight and samples at their extremes.
- The transpose trick: the plain form's SATD of a mode m in 2..17 equals
  the SATD of the vertical form (mode 36 - m) on the swapped lines against
  the transposed source, at every size, on seeded frames at 8 and 10
  bits, through ``intra_sweep_plain`` (the whole block grid transposed)
  and ``_predict_modes`` (each prediction the other's transpose, luma and
  chroma).
- The entries refuse a max_val the kernels' operand forms do not hold:
  above that of the bit depth 8 + bit_inc, or of an int16 plane.
"""

import numpy as np
import pytest
import torch

from thevc_tpu_torch.common.tables import from_reference
from thevc_tpu_torch.encoder import fast_intra as fi
from thevc_tpu_torch.ops import intra_rd_kernel

CPU = torch.device("cpu")
BIT_INCS = range(intra_rd_kernel.MAX_BIT_INC + 1)
# (TU size, DST): the intra 4x4 DST and the DCTs
BASES = [(4, True), (4, False), (8, False), (16, False), (32, False)]


def _basis(t: int, dst: bool) -> np.ndarray:
    return from_reference(CPU).basis(t, dst).numpy().astype(np.int64)


def _max_residual(bit_inc: int) -> int:
    """The largest |org - pred| of the samples the kernels take."""
    return intra_rd_kernel.max_val_limit(bit_inc)


@pytest.mark.parametrize("bit_inc", BIT_INCS)
@pytest.mark.parametrize("t,dst", BASES)
def test_forward_first_pass_fits_int16(t, dst, bit_inc):
    basis = _basis(t, dst)
    sh1 = t.bit_length() - 2 + bit_inc          # log2 t - 1 + bit_inc
    add = 1 << (sh1 - 1)
    r = _max_residual(bit_inc)
    # each row's worst residual row: its basis signs times the largest
    # residual, both ways
    worst = np.sign(basis) * r                  # [k, n]
    high = ((basis * worst).sum(axis=1) + add) >> sh1
    low = ((-(basis * worst)).sum(axis=1) + add) >> sh1
    assert high.max() <= 32767 and low.min() >= -32768
    # the plain form's first pass on those rows reaches the bound
    from thevc_tpu_torch.ops.tq import _fwd_pass
    x = torch.from_numpy(np.concatenate([worst, -worst])[:, None, :]
                         .repeat(t, axis=1))     # [2k, t, t]: rows repeated
    y = _fwd_pass(x, from_reference(CPU).basis(t, dst), sh1)
    got = y.numpy()
    assert got.max() == high.max() and got.min() == low.min()
    # the residual itself is an int16 operand: its high byte is s8
    assert -128 <= (-r) >> 8 and r >> 8 <= 127


def _split4(x: np.ndarray, y: np.ndarray):
    """The kernels' split of four int16 (0, 1 in x; 2, 3 in y, as uint32
    words of two halves): high bytes as s8, low bytes as u8, element 0 in
    the lowest byte (``__byte_perm`` 0x7531 and 0x6420)."""
    bx = x.astype(np.uint32).view(np.uint8).reshape(-1, 4)
    by = y.astype(np.uint32).view(np.uint8).reshape(-1, 4)
    hi = np.stack([bx[:, 1], bx[:, 3], by[:, 1], by[:, 3]], axis=1)
    lo = np.stack([bx[:, 0], bx[:, 2], by[:, 0], by[:, 2]], axis=1)
    return hi.view(np.int8).astype(np.int64), lo.astype(np.int64)


@pytest.mark.parametrize("element", range(4))
def test_split_recombines_every_int16(element):
    v = np.arange(-32768, 32768, dtype=np.int64)
    other = np.random.RandomState(element).randint(-32768, 32768, v.size)
    vals = [other, other[::-1], -other, other // 3]
    vals[element] = v
    pack = [(a & 0xFFFF) | ((b & 0xFFFF) << 16)
            for a, b in ((vals[0], vals[1]), (vals[2], vals[3]))]
    hi, lo = _split4(*pack)
    assert np.array_equal(256 * hi[:, element] + lo[:, element], v)
    assert hi.min() >= -128 and hi.max() <= 127 and lo.max() <= 255


@pytest.mark.parametrize("bit_inc", BIT_INCS)
@pytest.mark.parametrize("b", [4, 8])
def test_hadamard_first_pass_fits_int16(b, bit_inc):
    h = from_reference(CPU).hadamard[b].numpy().astype(np.int64)
    d = (256 << bit_inc) - 1
    # the worst first pass: every difference of one sign at its extreme
    worst = (np.abs(h) * d).sum(axis=1).max()
    assert worst == b * d
    fits = worst <= 32767
    if b == 8:
        assert fits == (bit_inc <= 4)
    # the tensor-core form runs for bit_inc <= 4 at both tile sizes, where
    # the prediction splits as 16 hi + lo with hi < 256
    if bit_inc <= 4:
        assert fits and ((256 << bit_inc) - 1) >> 4 <= 255
    # and on the numbers: H D on a block of worst differences
    block = np.full((b, b), d)
    assert np.abs(h @ block).max() == b * d


@pytest.mark.parametrize("bit_inc", [0, 8])
def test_float_prediction_is_exact(bit_inc):
    rng = np.random.RandomState(bit_inc)
    top = _max_residual(bit_inc)
    a = np.concatenate([rng.randint(0, top + 1, 20000),
                        [0, 0, top, top, 1, top - 1]]).astype(np.int64)
    b = np.concatenate([rng.randint(0, top + 1, 20000),
                        [0, top, 0, top, top - 1, 1]]).astype(np.int64)
    magic = 1.5 * 2 ** 23
    for f in range(32):
        want = ((32 - f) * a + f * b + 16) >> 5
        # fmaf(w0, a, 0.5) and fmaf(w1, b, .) are exact (below 2^22 with
        # one fraction bit); the last FMA rounds once: float64 holds its
        # exact value, float32 rounds it
        x = (32 - f) * a.astype(np.float64) + 0.5 + f * b
        assert np.all(x == np.float32(x).astype(np.float64))
        z = np.float32(x / 32.0 + magic)
        assert np.array_equal(z.astype(np.float64) - magic, want)
        # its low 16 bits are the prediction
        bits = z.view(np.uint32)
        assert np.array_equal(bits & 0xFFFF, want)
        assert np.all(bits - np.uint32(0x4B400000) == want)


def _plane(rng, rows: int, cols: int, bit_inc: int) -> torch.Tensor:
    """A seeded int16 plane of ramps, edges and noise at 8 + bit_inc
    bits."""
    hi = 256 << bit_inc
    yy, xx = np.mgrid[0:rows, 0:cols]
    v = ((xx * 7 + yy * 3 + rng.randint(0, 96, (rows, cols))) << bit_inc)
    v[:, cols // 3] = hi - 1                     # a bright column
    v[rows // 2, :] = 0                          # a dark row
    return torch.from_numpy((v % hi).astype(np.int16))


@pytest.mark.parametrize("bit_inc", [0, 2])
@pytest.mark.parametrize("s", fi.SIZES)
def test_transpose_trick(s, bit_inc):
    rng = np.random.RandomState(s + 7 * bit_inc)
    nby, nbx = 3, 5
    max_val = (256 << bit_inc) - 1
    plane = _plane(rng, nby * s + 2 * s + 1, nbx * s + 2 * s + 1, bit_inc)
    trans = plane.t().contiguous()               # a (nbx, nby) grid
    satd, _ = fi.intra_sweep_plain(plane, s, nby, nbx, bit_inc, max_val)
    satd_t, _ = fi.intra_sweep_plain(trans, s, nbx, nby, bit_inc, max_val)
    # block (by, bx) of the plane is block (bx, by) of the transposed one
    satd_t = satd_t.reshape(nbx, nby, 35).permute(1, 0, 2).reshape(-1, 35)
    for m in range(2, 18):
        # column index of mode m in [planar, DC, 2..34] is m
        assert torch.equal(satd[:, m], satd_t[:, 36 - m]), m
    # each prediction is the other's transpose, luma and chroma
    modes = torch.arange(2, 18, dtype=torch.int32).repeat(nby * nbx, 1)
    for luma in (True, False):
        pred = fi._predict_modes(plane, s, nby, nbx, modes, max_val, luma)
        pred_t = fi._predict_modes(trans, s, nbx, nby, 36 - modes.reshape(
            nby, nbx, 16).permute(1, 0, 2).reshape(-1, 16), max_val, luma)
        pred_t = pred_t.reshape(nbx, nby, 16, s, s).permute(1, 0, 2, 4, 3)
        assert torch.equal(pred, pred_t.reshape(nby * nbx, 16, s, s)), luma


@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was built")
    monkeypatch.setattr(intra_rd_kernel, "build", refuse)


@pytest.mark.parametrize("bit_inc", [0, 2, 7, 8])
@pytest.mark.parametrize("entry", ["sweep", "given", "intra"])
def test_kernels_refuse_samples_above_int16(no_build, entry, bit_inc):
    # the kernels take samples up to that of the bit depth 8 + bit_inc,
    # and of an int16 plane (MAX_VAL); above it they refuse: at bit_inc 0
    # the sweep packs samples as bytes, and the forward first pass fits
    # int16 only for residuals below 2^(8 + bit_inc)
    top = min((256 << bit_inc) - 1, intra_rd_kernel.MAX_VAL)
    assert intra_rd_kernel.max_val_limit(bit_inc) == top
    plane = torch.zeros((8 + 8 + 1, 8 + 8 + 1), dtype=torch.int16)
    basis = from_reference(CPU).basis(8, True)
    lb = fi._level_bits_units(CPU)
    blocks = torch.zeros((2, 8, 8), dtype=torch.int16)
    qp = torch.zeros(2, dtype=torch.int32)
    calls = {
        "sweep": lambda mv: intra_rd_kernel.check_sweep(plane, 8, 1, 1,
                                                        bit_inc, mv),
        "given": lambda mv: intra_rd_kernel.check_given(
            blocks, blocks, qp, basis, lb, 8, bit_inc, mv),
        "intra": lambda mv: intra_rd_kernel.check_intra(
            (plane,), torch.zeros((1, 2), dtype=torch.int32), qp, basis, lb,
            8, 1, 1, bit_inc, mv)}
    calls[entry](top)
    # 10-bit samples at bit_inc 0 among the refused
    for bad in {top + 1, max(1023, top + 1), intra_rd_kernel.MAX_VAL + 1}:
        with pytest.raises(ValueError, match="max_val"):
            calls[entry](bad)


@pytest.mark.parametrize("size", [32, 64])
def test_chroma_entry_refuses_luma_only_sizes(no_build, monkeypatch, size):
    # chroma blocks are 4..16, and 32 as four 16x16 TUs (-32): the kernel
    # has no chroma 32x32 TU and the entry refuses before building
    monkeypatch.setattr(intra_rd_kernel, "_check_cuda", lambda *a: None)
    plane = torch.zeros((size + size + 1, size + size + 1), dtype=torch.int16)
    basis = from_reference(CPU).basis(32, True)
    with pytest.raises(ValueError, match="chroma size"):
        intra_rd_kernel.tu_rd_intra(
            (plane, plane.clone()), torch.zeros((1, 5), dtype=torch.int32),
            torch.zeros(10, dtype=torch.int32), basis,
            fi._level_bits_units(CPU), size, 1, 1, False, 0, 255)
    assert set(intra_rd_kernel.CHROMA_RD_SIZES) < set(
        intra_rd_kernel.RD_SIZES)
