"""Decoder top for the port: the JAX package's ``Decoder`` with its device
path on a ``torch.device``.

``Decoder`` subclasses ``thevc_tpu.decoder.top.Decoder`` (NAL dispatch,
parameter sets, slice parsing, DPB and output order are shared) and
overrides the four methods that reach the device:

- ``_parallel_all_intra`` (reference :120): an all-intra stream of more
  than one access unit decodes in batches of pictures;
- ``_batched_all_intra`` (:236): parse a batch on host threads;
- ``_finish_ctx_batch`` (:280): one stage-1 launch per TU class and one
  filter launch for the batch, then the digests;
- ``_finish_picture`` (:565): the serial route, one picture at a time,
  which every stream with P or B slices takes.  Inter CUs are
  reconstructed on the device from reference planes that stay there
  (``decoder.inter.RefPlanes``), and the picture enters the DPB with its
  reference POCs and compressed motion, as the reference stores it.

A scaling-list stream or a weighted-prediction slice raises
``NotImplementedError`` (in ``decoder.recon`` / ``decoder.inter``)
instead of decoding on the host.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from thevc_tpu import headers
from thevc_tpu import nal as nal_mod
from thevc_tpu.bitstream import InputBitstream
from thevc_tpu.decoder import top as ref_top
from thevc_tpu.decoder.refpic import Picture
from thevc_tpu.digest import calc_digest
from thevc_tpu.io.yuv import YuvFrame

from ..ops.device import resolve, stage
from . import filters, inter, recon

# pictures per batched launch: bounds the device and host memory a batch
# holds (8 pictures of 1920x1080 are ~25 MB of samples)
BATCH = 8


def _digest_picture(cur, rec_y, rec_cb, rec_cr) -> ref_top.DecodedPicture:
    """The output picture, with its MD5/CRC/checksum SEI verified."""
    sh0 = cur.slices[0].sh
    frame = YuvFrame(rec_y, rec_cb, rec_cr)
    pic = ref_top.DecodedPicture(sh0.poc, frame)
    pic.output = sh0.pic_output_flag
    for sei in cur.sei:
        if sei.get("type") == "picture_digest":
            got = calc_digest(sei["method"], frame.planes(),
                              cur.sps.internal_bit_depth)
            pic.digest_ok = got == list(sei["digest"])
    return pic


def _blank_planes(sps):
    w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
    return (np.zeros((h, w), np.int16), np.zeros((h // 2, w // 2), np.int16),
            np.zeros((h // 2, w // 2), np.int16))


def _runs(cur):
    return [(r.sh, r.inter_pred, r.cu_start, r.cu_end) for r in cur.slices]


class Decoder(ref_top.Decoder):
    """Main decoder whose stage-1 residuals, motion compensation and
    in-loop filters run on ``device`` (a ``torch.device`` or its
    name)."""

    def __init__(self, device, max_temporal_layer: int = -1,
                 skip_frames: int = 0) -> None:
        super().__init__(max_temporal_layer, skip_frames)
        self.device = resolve(device)
        # load the native core on this thread before any pool starts:
        # concurrent first calls to native.get_lib() can see None
        recon.native_lib()
        self.refs = inter.RefPlanes(self.device)

    def _parallel_all_intra(self, units):
        """Batched decode of an all-intra stream.  Splits the stream into
        access units and scans every slice header (cheap bit parsing, no
        CABAC) to record each AU's POC.  Returns None, for the serial
        route, when the stream has one AU, when temporal-layer or skip
        options apply, when leading-skip NAL types appear, or when a
        slice is not an I slice."""
        if self.max_temporal_layer >= 0 or self.skip_frames:
            return None
        param_units = []
        aus: list = []          # each: the SEIs and slices of one AU
        cur: list = []
        cur_has_slice = False
        for u in units:
            if nal_mod.is_slice_nal(u.nal_type):
                if u.nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_TFD,
                                  nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                                  nal_mod.NAL_UNIT_CODED_SLICE_BLANT):
                    return None
                # first_slice_in_pic_flag is the first RBSP bit
                if cur_has_slice and u.rbsp and (u.rbsp[0] & 0x80):
                    aus.append(cur)
                    cur = []
                cur.append(u)
                cur_has_slice = True
            elif u.nal_type == nal_mod.NAL_UNIT_SEI:
                if cur_has_slice:
                    aus.append(cur)
                    cur = []
                    cur_has_slice = False
                cur.append(u)
            else:
                param_units.append(u)
        if cur_has_slice:
            aus.append(cur)
        elif cur:
            return None        # trailing SEI without a slice: keep serial
        if len(aus) <= 1:
            return None

        probe = ref_top.Decoder()
        for u in param_units:
            probe.decode_nal(u)
        if not probe.sps_map:
            return None
        # callers read the activated parameter sets off this decoder
        self.vps_map.update(probe.vps_map)
        self.sps_map.update(probe.sps_map)
        self.pps_map.update(probe.pps_map)
        prev_poc = 0
        prev_sh = None
        au_poc: list = []
        for au in aus:
            first = True
            for u in au:
                if not nal_mod.is_slice_nal(u.nal_type):
                    continue
                sh, _sps, _pps = headers.parse_slice_header(
                    InputBitstream(u.rbsp), u.nal_type, u.temporal_id,
                    probe.sps_map, probe.pps_map, prev_poc,
                    prev_slice=prev_sh)
                if not sh.is_intra:
                    return None
                if first:
                    au_poc.append(sh.poc)
                    first = False
                prev_poc = sh.poc
                prev_sh = sh
        return self._batched_all_intra(param_units, aus, au_poc)

    def _batched_all_intra(self, param_units, aus, au_poc):
        """Parse up to ``BATCH`` access units on host threads (the native
        parse releases the GIL), then finish them as one batch."""
        def parse_job(arg):
            au, poc0 = arg
            # a reference decoder that only parses: defer_finish parks
            # the parsed picture without reconstructing it
            d = ref_top.Decoder()
            d.defer_finish = True
            d.poc_random_access = -(1 << 30)   # all-intra: nothing to skip
            for u in param_units:
                d.decode_nal(u)
            d.prev_poc = poc0
            for u in au:
                d.decode_nal(u)
            d.flush()
            return d.deferred[0] if d.deferred else None

        pairs = list(zip(aus, au_poc))
        with ThreadPoolExecutor(max_workers=BATCH) as ex:
            for lo in range(0, len(pairs), BATCH):
                ctxs = [c for c in ex.map(parse_job, pairs[lo:lo + BATCH])
                        if c is not None]
                if ctxs:
                    self._finish_ctx_batch(ctxs, ex)
        return [p for p in sorted(self.pictures, key=lambda p: p.poc)
                if p.output]

    def _finish_ctx_batch(self, ctxs, ex) -> None:
        """Reconstruct, filter and digest a batch of parsed pictures: one
        stage-1 launch per TU class and one filter launch per setting."""
        items = [(cur.f, cur.sps, cur.pps, _runs(cur)) for cur in ctxs]
        stores = recon.batched_residual_stores(items, self.device)

        def recon_job(arg):
            (f, sps, pps, runs), store = arg
            planes = _blank_planes(sps)
            recon.reconstruct_picture(f, sps, pps, runs, *planes,
                                      self.device, resi_store=store)
            return planes
        recs = list(ex.map(recon_job, zip(items, stores)))

        entries = [(cur.f, cur.slices[0].sh, cur.sps, cur.pps, *planes, None)
                   for cur, planes in zip(ctxs, recs)]
        outs = filters.filter_pictures_device(entries, self.device)
        self.pictures.extend(ex.map(lambda a: _digest_picture(a[0], *a[1]),
                                    zip(ctxs, outs)))

    def _decode_slice(self, unit, bs) -> None:
        with stage("parse", self.device):
            super()._decode_slice(unit, bs)

    def _finish_picture(self) -> None:
        """Reconstruct, filter, digest and store one picture (the serial
        route)."""
        if self.defer_finish:
            self.deferred.append(self.cur)
            self.cur = None
            return
        cur, self.cur = self.cur, None
        with stage("digest_dpb", self.device):
            self._finish(cur)

    def _finish(self, cur) -> None:
        f, sps, pps = cur.f, cur.sps, cur.pps
        sh0 = cur.slices[0].sh
        any_inter = any(not run.sh.is_intra for run in cur.slices)
        self.refs.drop_unreferenced()
        planes = _blank_planes(sps)
        recon.reconstruct_picture(f, sps, pps, _runs(cur), *planes,
                                  self.device, refs=self.refs)

        # per-unit reference POC map for deblock BS + the DPB motion
        # snapshot
        ref_poc, ref_is_lt = self._resolve_ref_pocs(cur)
        with stage("filters", self.device):
            (rec_y, rec_cb, rec_cr), dev_planes = \
                filters.filter_picture_device(
                    f, sh0, sps, pps, *planes, self.device,
                    ref_poc if any_inter else None)

        ref_pocs0 = [[p.poc for p in cur.slices[0].list0],
                     [p.poc for p in cur.slices[0].list1]]
        dpb_pic = Picture(sh0.poc, (rec_y, rec_cb, rec_cr), f, sh0,
                          ref_pocs0, margin=sps.max_cu_width + 16,
                          ref_poc=ref_poc, ref_is_lt=ref_is_lt)
        if any_inter:      # all-intra motion fields are zero already
            dpb_pic.compress_motion()
        self.dpb.add(dpb_pic)
        self.refs.put(dpb_pic, dev_planes)
        pic = _digest_picture(cur, rec_y, rec_cb, rec_cr)
        if self.keep_models:
            pic.model = f
        self.pictures.append(pic)
