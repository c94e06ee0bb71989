"""In-loop filter driver for the port: host-built edge maps and SAO
tables, pixel math on the device.

The device half of ``thevc_tpu/decoder/filters.py``:
``filter_picture_device`` (:283) and ``filter_pictures_device`` (:310).
The one-picture form also hands back the filtered planes on the device,
where inter pictures read them as references.
The host inputs come from the JAX package's ``_picture_filter_inputs``
(:230), which builds them with numpy and the native core.
"""

from __future__ import annotations

import numpy as np
import torch

from thevc_tpu.decoder.filters import _picture_filter_inputs

from ..ops import filters as ops_filters
from ..ops.device import stat_d2h, stat_h2d, stat_launch


def _filter_pictures(entries, device: torch.device) -> list:
    """Deblocking + SAO for many pictures, one launch per filter setting.

    entries: [(f, sh, sps, pps, rec_y, rec_cb, rec_cr, ref_poc)].
    Pictures that share the filter setting (offsets, bit depth, CTU
    grid, which filters are on) run as one batch; 8-bit pictures travel
    as uint8 both ways (lossless: values are clipped to [0, 255]).
    Returns [(host planes, device planes)]: the host planes in the
    dtypes of the inputs, the device planes as the filter left them on
    ``device`` (None for a picture with both filters off)."""
    inputs = [_picture_filter_inputs(f, sh, sps, pps, rp)
              for (f, sh, sps, pps, _ry, _rcb, _rcr, rp) in entries]
    out: list = [None] * len(entries)
    groups: dict = {}
    for i, inp in enumerate(inputs):
        if inp is None:                 # both filters off
            out[i] = (tuple(entries[i][4:7]), None)
        else:
            groups.setdefault(tuple(sorted(inp[0].items())), []).append(i)

    for idxs in groups.values():
        statics = inputs[idxs[0]][0]
        u8 = statics["bit_depth"] == 8
        dt = np.uint8 if u8 else np.int16
        host = [np.stack([entries[i][4 + p] for i in idxs]).astype(dt)
                for p in range(3)]
        host += [np.stack([inputs[i][1][k] for i in idxs]) for k in range(6)]
        host += [np.stack([inputs[i][2][k] for i in idxs]) for k in range(6)]
        host += [np.stack([inputs[i][k] for i in idxs]) for k in (3, 4, 5)]
        stat_launch(sum(a.nbytes for a in host))
        t = [torch.from_numpy(a).to(device) for a in host]
        planes = ops_filters.filter_pictures(
            t[0], t[1], t[2], tuple(t[3:9]), tuple(t[9:15]),
            t[15], t[16], t[17], out_u8=u8, **statics)
        y, cb, cr = (p.cpu().numpy() for p in planes)
        stat_d2h(y.nbytes + cb.nbytes + cr.nbytes)
        for j, i in enumerate(idxs):
            ry, rcb, rcr = entries[i][4:7]
            out[i] = ((y[j].astype(ry.dtype), cb[j].astype(rcb.dtype),
                       cr[j].astype(rcr.dtype)),
                      tuple(p[j] for p in planes))
    return out


def filter_pictures_device(entries, device: torch.device) -> list:
    """Deblocking + SAO for many pictures (``_filter_pictures``); returns
    [(y, cb, cr)] on the host in the dtypes of the inputs."""
    return [h for h, _d in _filter_pictures(entries, device)]


def filter_picture_device(f, sh, sps, pps, rec_y, rec_cb, rec_cr,
                          device: torch.device, ref_poc=None):
    """Deblocking + SAO of one picture on ``device``.  Returns (host
    planes, device planes); the device planes are a copy of the host
    ones when both filters are off."""
    host, dev = _filter_pictures(
        [(f, sh, sps, pps, rec_y, rec_cb, rec_cr, ref_poc)], device)[0]
    if dev is None:
        stat_h2d(sum(a.nbytes for a in host))
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in host)
    return host, dev
