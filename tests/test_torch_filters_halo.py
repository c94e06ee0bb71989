"""The in-loop filter kernel's halo (``csrc/filters.cu``), checked on the
plain form (``ops.filters.filter_pictures_plain``) on the CPU.

The kernel writes each plane in output tiles, 64x64 luma and 32x32 chroma
(the same tile grid), and reads for a tile a window of it and HALO = 4
samples each side, with the map units and SAO parameters that window
meets.  Here, on 2 pictures of 200x136 (CTU 32; 136 and 200 are not
multiples of 64, so the last tile row and column are partial), for tiles
at the origin, inside, and at the right and bottom edges:

- changing every sample outside a plane's window, every sample of the
  other planes, every map unit outside the units the window covers and the
  SAO parameters of every CTU the tile does not meet leaves the tile's
  output as it was (tolerance 0);
- changing the samples of the window's outermost ring alone moves some
  tile's output: the halo is not larger than needed, and the first check
  is not vacuous.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_filters_kernel import SWITCHES, filter_inputs
from thevc_tpu_torch.ops import filters as tf

SOURCE = Path(tf.__file__).resolve().parents[1] / "csrc" / "filters.cu"
TILE, HALO = 64, 4                 # luma; chroma tiles are TILE / 2
H, W, CTU, NB = 136, 200, 32, 2
# tile origins (y0, x0) in luma samples: the origin, inside, the right
# edge, the bottom edge and the bottom-right corner
TILES = [(0, 0), (64, 64), (64, 192), (128, 64), (128, 192)]
IDS = ["dbk", "dbk_sao", "dbk_sao_chroma", "sao", "sao_chroma"]


def test_kernel_uses_this_tiling():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kLumaTile") == TILE
    assert const("kChromaTile") == TILE // 2
    assert const("kHalo") == HALO


def _case(bd: int, switches: tuple):
    seed = 7 * bd + SWITCHES.index(switches)
    rng = np.random.RandomState(seed)
    arrs, ctus = filter_inputs(rng, NB, H, W, CTU, bd, bd == 8)
    beta_offset, tc_offset = (int(v) for v in rng.randint(-6, 7, 2))
    statics = dict(ctus, beta_offset=beta_offset, tc_offset=tc_offset,
                   bit_depth=bd, do_deblock=switches[0], do_sao=switches[1],
                   do_sao_chroma=switches[2], out_u8=bd == 8)
    return rng, arrs, statics


def _run(arrs, statics):
    y, cb, cr, dv, dh, types, band_pos, offsets = arrs

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    out = tf.filter_pictures_plain(
        t(y), t(cb), t(cr), tuple(map(t, dv)), tuple(map(t, dh)), t(types),
        t(band_pos), t(offsets), **statics)
    return [o.numpy() for o in out]


def _geometry(p: int, y0: int, x0: int):
    """Plane p's tile of the luma tile at (y0, x0): its interior, its
    window and the luma unit range the window covers, each as (rows,
    columns) slices or index ranges, clipped to the plane."""
    s = 1 if p == 0 else 2
    hp, wp, t = H // s, W // s, TILE // s
    ty, tx = y0 // s, x0 // s
    interior = (slice(ty, min(ty + t, hp)), slice(tx, min(tx + t, wp)))
    wy = (max(ty - HALO, 0), min(ty + t + HALO, hp))
    wx = (max(tx - HALO, 0), min(tx + t + HALO, wp))
    # a chroma sample (y, x) sits in the luma unit (y // 2, x // 2)
    unit = 4 // s
    uy = ((ty - HALO) // unit, (ty + t + HALO - 1) // unit + 1)
    ux = ((tx - HALO) // unit, (tx + t + HALO - 1) // unit + 1)
    return interior, (wy, wx), (uy, ux), (hp, wp, t, ty, tx)


def _changed(rng, a, maxv):
    """Every value of ``a`` moved to another in its range."""
    step = rng.randint(1, maxv + 1, a.shape)
    return ((a.astype(np.int64) + step) % (maxv + 1)).astype(a.dtype)


def _perturb_outside(rng, arrs, statics, p, y0, x0):
    y, cb, cr, dv, dh, types, band_pos, offsets = arrs
    bd = statics["bit_depth"]
    maxv = (1 << bd) - 1
    _interior, ((wy0, wy1), (wx0, wx1)), ((uy0, uy1), (ux0, ux1)), \
        (hp, wp, t, ty, tx) = _geometry(p, y0, x0)
    planes = []
    for q, plane in enumerate((y, cb, cr)):
        new = _changed(rng, plane, maxv)
        if q == p:
            new[:, wy0:wy1, wx0:wx1] = plane[:, wy0:wy1, wx0:wx1]
        planes.append(new)
    keep = np.zeros(dv[0].shape, bool)
    keep[:, max(uy0, 0):uy1, max(ux0, 0):ux1] = True

    def maps(ms):
        out = []
        for k, m in enumerate(ms):
            span = {1: 2, 2: 64, 3: 64}.get(k, 1)   # bs 0-2, QPs
            lo = -12 if k in (2, 3) else 0
            moved = (((m.astype(np.int64) - lo + rng.randint(1, span + 1,
                                                             m.shape))
                      % (span + 1)) + lo).astype(m.dtype)
            out.append(np.where(keep, m, moved))
        return tuple(out)
    # the CTUs the tile meets keep their SAO parameters
    cs = CTU if p == 0 else CTU // 2
    ctus_w = statics["ctus_w"]
    rows = range(ty // cs, (min(ty + t, hp) - 1) // cs + 1)
    cols = range(tx // cs, (min(tx + t, wp) - 1) // cs + 1)
    mine = np.zeros(types.shape[-1], bool)
    for r in rows:
        for c in cols:
            mine[r * ctus_w + c] = True
    new_types = rng.randint(-1, 5, types.shape).astype(types.dtype)
    new_band = rng.randint(0, 32, band_pos.shape).astype(band_pos.dtype)
    new_off = rng.randint(-7, 8, offsets.shape).astype(offsets.dtype)
    new_types[:, p, mine] = types[:, p, mine]
    new_band[:, p, mine] = band_pos[:, p, mine]
    new_off[:, p, mine] = offsets[:, p, mine]
    return (*planes, maps(dv), maps(dh), new_types, new_band, new_off)


def _perturb_ring(rng, arrs, statics, p, y0, x0):
    """The samples of plane p's window's outermost ring alone changed."""
    maxv = (1 << statics["bit_depth"]) - 1
    _i, _w, _u, (hp, wp, t, ty, tx) = _geometry(p, y0, x0)
    plane = arrs[p]
    new = plane.copy()
    ring = np.zeros(plane.shape[1:], bool)
    for r in (ty - HALO, ty + t + HALO - 1):
        if 0 <= r < hp:
            ring[r, max(tx - HALO, 0):min(tx + t + HALO, wp)] = True
    for c in (tx - HALO, tx + t + HALO - 1):
        if 0 <= c < wp:
            ring[max(ty - HALO, 0):min(ty + t + HALO, hp), c] = True
    moved = _changed(rng, plane, maxv)
    new[:, ring] = moved[:, ring]
    return tuple(new if q == p else a for q, a in enumerate(arrs))


@pytest.mark.parametrize("tile", TILES, ids=[f"{y}_{x}" for y, x in TILES])
@pytest.mark.parametrize("switches", SWITCHES, ids=IDS)
@pytest.mark.parametrize("bd", [8, 10])
def test_tile_depends_on_its_window_alone(bd, switches, tile):
    rng, arrs, statics = _case(bd, switches)
    base = _run(arrs, statics)
    for p in range(3):
        interior = (slice(None), *_geometry(p, *tile)[0])
        got = _run(_perturb_outside(rng, arrs, statics, p, *tile), statics)
        assert np.array_equal(got[p][interior], base[p][interior]), \
            f"plane {p}'s tile at {tile} moved"


@pytest.mark.parametrize("bd", [8, 10])
def test_window_ring_can_move_the_tile(bd):
    moved = []
    for switches in SWITCHES:
        rng, arrs, statics = _case(bd, switches)
        base = _run(arrs, statics)
        for tile in TILES:
            for p in range(3):
                interior = (slice(None), *_geometry(p, *tile)[0])
                got = _run(_perturb_ring(rng, arrs, statics, p, *tile),
                           statics)
                if not np.array_equal(got[p][interior], base[p][interior]):
                    moved.append((switches, tile, p))
    # the ring moves a deblocked tile: a luma edge on the tile's border
    # reads 4 samples into the halo
    assert any(s[0] for s, _t, _p in moved), moved
