"""The MC kernel's generic entries as the P/B fast-RD pass and the decode
call them, on the CPU (no card needed; the kernels themselves are held
against these forms by the ``gpu`` tests of ``test_torch_kernels.py``):

- ``ops.mc.mc_blocks`` with two planes a job (Cb and Cr stacked) and with
  a second list (the bi average in the call) equals the JAX package's
  ``jx_mc.mc_batch`` (and ``jx_mc.bi_avg_batch``) on the same
  numpy-gathered windows, every case, luma and chroma, 8 and 10 bits,
  windows past every plane edge;
- the picture entry's host ordering (``mc_kernel.picture_order``): every
  job once, the runs and bands the kernel reads cover each job's rows
  once, and every band fits a warp's shared memory.
"""

import numpy as np
import pytest
import torch

from thevc_tpu.ops import jx_mc
from thevc_tpu_torch.ops import mc, mc_kernel

SHAPES = {True: [(8, 8), (4, 16), (64, 64)], False: [(4, 4), (2, 4),
                                                     (32, 32)]}
N = 23


def _windows(planes, jobs, q, case, luma, h, w):
    """numpy windows [N, rows, cols] of jobs (plane + q, x, y, ...) over
    planes [P, H, W] at clamped coordinates (the edge padding a
    reference picture holds)."""
    rows, cols = mc.window_shape(case, luma, h, w)
    _, ph, pw = planes.shape
    ys = np.clip(jobs[:, 2, None] + np.arange(rows), 0, ph - 1)
    xs = np.clip(jobs[:, 1, None] + np.arange(cols), 0, pw - 1)
    return planes[(jobs[:, 0] + q)[:, None, None], ys[:, :, None],
                  xs[:, None, :]].astype(np.int16)


def _inputs(rng, luma, h, w, bd, n_planes=3):
    """Cb then Cr planes [2 n_planes, 40, 52] and jobs [N, 5] over the
    first n_planes, windows reaching past every edge."""
    planes = rng.randint(0, 1 << bd, (2 * n_planes, 40, 52)).astype(np.int16)
    top = 4 if luma else 8
    jobs = np.stack([rng.randint(0, n_planes, N),
                     rng.randint(-w - 12, 52 + 12, N),
                     rng.randint(-h - 12, 40 + 12, N),
                     rng.randint(0, top, N), rng.randint(0, top, N)],
                    axis=1).astype(np.int32)
    return planes, jobs


def _jax(planes, jobs, q, case, luma, bd, bi, h, w):
    return np.asarray(jx_mc.mc_batch(
        _windows(planes, jobs, q, case, luma, h, w), jobs[:, 3], jobs[:, 4],
        case=case, luma=luma, bd=bd, bi=bi, out_h=h, out_w=w))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("case", mc.CASES)
def test_two_planes_equal_mc_batch(case, luma, bd):
    rng = np.random.RandomState(mc.CASES.index(case) + 4 * luma + bd)
    for h, w in SHAPES[luma]:
        planes, jobs = _inputs(rng, luma, h, w, bd)
        for bi in (False, True):
            before = mc.launches
            got = mc.mc_blocks(torch.from_numpy(planes),
                               torch.from_numpy(jobs), case, luma, bd, bi,
                               h, w, pair=True)
            assert got.shape == (2, N, h, w) and got.dtype == torch.int16
            assert mc.launches == before + 2          # one pass a plane
            for q in (0, 1):
                want = _jax(planes, jobs, 3 * q, case, luma, bd, bi, h, w)
                np.testing.assert_array_equal(got[q].numpy(), want)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("case", mc.CASES)
def test_bi_call_equals_bi_avg_of_mc_batch(case, luma, bd):
    rng = np.random.RandomState(40 + mc.CASES.index(case) + 4 * luma + bd)
    for h, w in SHAPES[luma]:
        p0, j0 = _inputs(rng, luma, h, w, bd)
        p1, j1 = _inputs(rng, luma, h, w, bd, n_planes=2)
        for pair in (False, True):
            got = mc.mc_blocks(torch.from_numpy(p0), torch.from_numpy(j0),
                               case, luma, bd, True, h, w, pair=pair,
                               planes1=torch.from_numpy(p1),
                               jobs1=torch.from_numpy(j1))
            assert got.shape == ((2, N) if pair else (N,)) + (h, w)
            for q in ((0, 1) if pair else (0,)):
                want = np.asarray(jx_mc.bi_avg_batch(
                    _jax(p0, j0, 3 * q, case, luma, bd, True, h, w),
                    _jax(p1, j1, 2 * q, case, luma, bd, True, h, w), bd))
                np.testing.assert_array_equal(
                    (got[q] if pair else got).numpy(), want)


def test_bi_call_needs_both_lists_and_bi():
    planes = torch.zeros((2, 16, 16), dtype=torch.int16)
    jobs = torch.zeros((3, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        mc_kernel.blocks(planes, jobs, "2d", True, 8, True, 8, 8)  # CPU
    got = mc.mc_blocks(planes, jobs, "2d", True, 8, True, 8, 8,
                       planes1=planes, jobs1=jobs)
    # both lists at 0: (0 - 8192) * 2 averaged back to 0
    assert torch.equal(got, torch.zeros((3, 8, 8), dtype=torch.int16))


def _ordered_jobs(rng, n):
    """Jobs of every HEVC PU size (luma and chroma) and of random sizes
    1..64, in random order: only the sizes and the component matter."""
    sizes = [(h, w) for h in (4, 8, 12, 16, 24, 32, 48, 64)
             for w in (4, 8, 12, 16, 24, 32, 48, 64)]
    jobs = np.zeros((n, mc.JOB_COLS), np.int32)
    for i in range(n):
        luma = rng.rand() < 0.5
        h, w = sizes[rng.randint(len(sizes))] if rng.rand() < 0.8 \
            else tuple(rng.randint(1, 65, 2))
        if not luma:
            h, w = max(1, h // 2), max(1, w // 2)
        jobs[i, :4] = (h, w, luma, 0)
        jobs[i, mc.J_DST] = i                  # which job this was
    return jobs


@pytest.mark.parametrize("n", [1, 7, 600])
def test_picture_order_covers_every_row_once(n):
    jobs = _ordered_jobs(np.random.RandomState(n), n)
    ordered, runs, items = mc_kernel.picture_order(jobs)
    assert sorted(ordered[:, mc.J_DST]) == list(range(n))
    rows = mc_kernel.band_rows(ordered)
    bands = -(-ordered[:, mc.J_H] // rows)
    # most bands first; the runs tile the items and the ordered jobs
    assert (np.diff(bands) <= 0).all() and len(runs) <= mc_kernel.MAX_RUNS
    assert runs[0, 0] == 0 and runs[0, 1] == 0 and items == bands.sum()
    assert (np.diff(runs[:, 2]) < 0).all()
    covered = [np.zeros(h, np.int64) for h in ordered[:, mc.J_H]]
    for item in range(items):
        # the kernel's lookup: the last run that starts at or before it
        r = np.flatnonzero(runs[:, 0] <= item)[-1]
        j = runs[r, 1] + (item - runs[r, 0]) // runs[r, 2]
        band = (item - runs[r, 0]) % runs[r, 2]
        assert bands[j] == runs[r, 2]
        covered[j][band * rows[j]:(band + 1) * rows[j]] += 1
    assert all((c == 1).all() for c in covered)


def test_picture_bands_fit_a_warp():
    h, w = np.meshgrid(np.arange(1, 65), np.arange(1, 65))
    jobs = np.zeros((h.size, mc.JOB_COLS), np.int32)
    jobs[:, mc.J_H], jobs[:, mc.J_W] = h.ravel(), w.ravel()
    rows = mc_kernel.band_rows(jobs)
    groups = (jobs[:, mc.J_W] + 7) // 8
    assert (rows >= 1).all() and (rows <= 32).all()
    assert (rows * groups <= 64).all()              # two groups a lane
    for taps in (8, 4):
        win = (rows + taps - 1) * (8 * groups + 16)
        first = (rows + taps - 1) * 8 * groups
        assert (2 * win + first <= mc_kernel.PICTURE_WARP_SAMPLES).all()
