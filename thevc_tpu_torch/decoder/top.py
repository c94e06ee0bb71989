"""Decoder top for the port: NAL dispatch, parameter-set activation, the
picture/slice split, the DPB, output order and digest verification of
``thevc_tpu/decoder/top.py``, with the device path on a ``torch.device``.

The host parts of the reference's ``Decoder`` are copied into the port's
``Decoder`` unchanged (``decode_stream``, ``decode_nal``,
``_decode_slice``, the random-access and lost-picture handling,
``_resolve_ref_pocs``); the methods that reach the device are the
port's own:

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

Scaling lists (``decoder.recon``) and weighted prediction
(``decoder.inter``) decode on the device route too.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import headers
from .. import nal as nal_mod
from ..bitstream import InputBitstream
from ..common.tiles import TileInfo
from ..digest import calc_digest
from ..io.yuv import YuvFrame
from ..ops.device import resolve, stage
from ..params import Pps, Sps, Vps
from . import filters, inter, recon
from .cu_parser import SliceDataParser
from .frame import FrameModel
from .inter import InterPredictor
from .mv import MvCtx
from .refpic import (Dpb, Picture, build_ref_lists,
                     check_all_ref_pics_available, check_ldc)

# pictures per batched launch: bounds the device and host memory a batch
# holds (8 pictures of 1920x1080 are ~25 MB of samples)
BATCH = 8

_MAX_INT = 2 ** 31 - 1


@dataclass
class DecodedPicture:
    poc: int
    frame: YuvFrame
    output: bool = True
    digest_ok: Optional[bool] = None
    model: Optional[object] = None     # FrameModel when keep_models is set


class _SliceRun:
    """One parsed slice segment and its reconstruction context."""

    def __init__(self, sh, list0, list1, inter_pred, cu_start: int):
        self.sh = sh
        self.list0 = list0
        self.list1 = list1
        self.inter_pred = inter_pred
        self.cu_start = cu_start
        self.cu_end = cu_start


class _PicCtx:
    """A picture being accumulated slice by slice."""

    def __init__(self, f: FrameModel, sps: Sps, pps: Pps, sei: List[dict]):
        self.f = f
        self.sps = sps
        self.pps = pps
        self.sei = sei
        self.slices: List[_SliceRun] = []
        self.n_regular = 0          # count of non-dependent slices
        self.dep_ctx = None         # CABAC ctx chain for dependent slices


def _digest_picture(cur, rec_y, rec_cb, rec_cr) -> DecodedPicture:
    """The output picture, with its MD5/CRC/checksum SEI verified."""
    sh0 = cur.slices[0].sh
    frame = YuvFrame(rec_y, rec_cb, rec_cr)
    pic = DecodedPicture(sh0.poc, frame)
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


class Decoder:
    """Main decoder whose stage-1 residuals, motion compensation and
    in-loop filters run on ``device`` (a ``torch.device`` or its
    name)."""

    def __init__(self, device, max_temporal_layer: int = -1,
                 skip_frames: int = 0) -> None:
        self.vps_map: Dict[int, Vps] = {}
        self.sps_map: Dict[int, Sps] = {}
        self.pps_map: Dict[int, Pps] = {}
        self.prev_poc = 0
        self.pending_sei: List[dict] = []
        self.pictures: List[DecodedPicture] = []
        self.dpb = Dpb()
        self.cur: Optional[_PicCtx] = None
        # TAppDecTop.cpp:144-155: NALs above this temporal layer are dropped
        # before decode (-1 = decode all layers).
        self.max_temporal_layer = max_temporal_layer
        # random-access / broken-link state (TDecTop.cpp:55-58)
        self.skip_frames = skip_frames
        # keep each picture's FrameModel on the DecodedPicture (serial
        # path only) for decision-map introspection by tools/
        self.keep_models = False
        self.poc_random_access = _MAX_INT
        self.poc_cra = 0
        self.prev_rap_is_bla = False
        self._skip_poc: Optional[int] = None   # picture being skipped
        self._warned_ra = False
        # multi-picture device pipeline: when set, _finish_picture defers
        # recon/filter/digest and parks the parsed picture context here
        self.defer_finish = False
        self.deferred: List[_PicCtx] = []

        self.device = resolve(device)
        # the native core is required: fail here, before any pool starts,
        # if it cannot be built or loaded
        recon.native_lib()
        self.refs = inter.RefPlanes(self.device)

    def decode_stream(self, data: bytes):
        """Decode a whole Annex-B stream, returning pictures in POC order."""
        units = list(nal_mod.iter_annexb_nals(data))
        parallel = self._parallel_all_intra(units)
        if parallel is not None:
            return parallel
        for unit in units:
            self.decode_nal(unit)
        self.flush()
        return [p for p in sorted(self.pictures, key=lambda p: p.poc)
                if p.output]

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

        probe = Decoder(self.device)
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
            d = Decoder(self.device)
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

    def flush(self) -> None:
        """Finish the picture in flight (end of stream)."""
        if self.cur is not None:
            self._finish_picture()

    def decode_nal(self, unit: nal_mod.NalUnit) -> None:
        bs = InputBitstream(unit.rbsp)
        t = unit.nal_type
        if t == nal_mod.NAL_UNIT_VPS:
            vps = headers.parse_vps(bs)
            self.vps_map[vps.vps_id] = vps
        elif t == nal_mod.NAL_UNIT_SPS:
            sps = headers.parse_sps(bs)
            self.sps_map[sps.sps_id] = sps
        elif t == nal_mod.NAL_UNIT_PPS:
            pps = headers.parse_pps(bs)
            self.pps_map[pps.pps_id] = pps
            # substream model, set at PPS activation (TDecTop.cpp:284,
            # reached from xDecodePPS): WPP = one per CTU row; dependent
            # slices force one
            sps = self.sps_map[pps.sps_id]
            if pps.tiles_or_entropy_coding_sync_idc == 2:
                pps.num_substreams = sps.pic_height_in_ctus * (
                    pps.num_tile_columns_minus1 + 1)
            else:
                pps.num_substreams = 1
            if pps.dependent_slices_enabled_flag:
                pps.num_substreams = 1
        elif t == nal_mod.NAL_UNIT_SEI:
            self.pending_sei.extend(headers.parse_sei_rbsp(unit.rbsp))
        elif nal_mod.is_slice_nal(t):
            if (self.max_temporal_layer >= 0
                    and unit.temporal_id > self.max_temporal_layer):
                return
            self._decode_slice(unit, bs)

    def _decode_slice(self, unit: nal_mod.NalUnit, bs: InputBitstream) -> None:
        with stage("parse", self.device):
            self._parse_slice(unit, bs)

    def _parse_slice(self, unit: nal_mod.NalUnit, bs: InputBitstream) -> None:
        prev_sh = self.cur.slices[-1].sh if (self.cur and self.cur.slices) \
            else None
        sh, sps, pps = headers.parse_slice_header(
            bs, unit.nal_type, unit.temporal_id, self.sps_map, self.pps_map,
            self.prev_poc, prev_slice=prev_sh)

        if pps.dependent_slices_enabled_flag and sh.dependent_slice:
            # dependent slice segment: inherit everything but the segment
            # address from the previous slice (TDecTop copySliceInfo)
            if prev_sh is None:
                if self._skip_poc is not None:
                    return        # parent slice was skipped
                raise ValueError("dependent slice without preceding slice")
            dep_start = sh.dependent_slice_start_cu_addr
            merged = copy.copy(prev_sh)
            merged.first_slice_in_pic = sh.first_slice_in_pic
            merged.dependent_slice = True
            merged.dependent_slice_start_cu_addr = dep_start
            merged.nal_unit_type = sh.nal_unit_type
            merged.temporal_id = sh.temporal_id
            sh = merged
            new_pic = False
        else:
            sh.dependent_slice = False
            new_pic = sh.first_slice_in_pic or (
                self.cur is not None and self.cur.slices
                and sh.poc != self.cur.slices[0].sh.poc)

        if new_pic and self.cur is not None:
            self._finish_picture()
        self.prev_poc = sh.poc

        if not sh.dependent_slice and self.cur is None:
            # skip checks run per regular slice while no picture is open
            # (TDecTop.cpp:420-431)
            if self._random_access_skip(sh, unit.nal_type) or \
                    self._bla_skip(sh, unit.nal_type):
                self._skip_poc = sh.poc
                return
            self._skip_poc = None
        elif self._skip_poc is not None and self.cur is None:
            if sh.poc == self._skip_poc:
                return
            self._skip_poc = None

        # lost-reference detection + concealment (TDecTop.cpp:392-397)
        if not sh.is_intra:
            while True:
                lost = check_all_ref_pics_available(
                    sh, self.dpb, self.poc_random_access, sps.bits_for_poc)
                if lost <= 0:
                    break
                self._create_lost_picture(lost - 1, sps, pps)

        if self.cur is None:
            # first slice of a picture: DPB bookkeeping + picture alloc
            # (TDecTop::xDecodeSlice "if (m_bFirstSliceInPicture)")
            if unit.nal_type == nal_mod.NAL_UNIT_CODED_SLICE_IDR:
                self.dpb.idr_flush()
            else:
                self.dpb.apply_rps(sh.rps, sh.poc, sps.bits_for_poc)
            # checkCRA state updates (TComSlice.cpp:595, asserts elided)
            if unit.nal_type == nal_mod.NAL_UNIT_CODED_SLICE_IDR:
                self.prev_rap_is_bla = False
            elif unit.nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_CRA,
                                   nal_mod.NAL_UNIT_CODED_SLICE_CRANT):
                self.poc_cra = sh.poc
                self.prev_rap_is_bla = False
            elif unit.nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                                   nal_mod.NAL_UNIT_CODED_SLICE_BLANT):
                self.poc_cra = sh.poc
                self.prev_rap_is_bla = True
            f = FrameModel(sps, pps)
            f.init_tiles(TileInfo(f.ctus_w, f.ctus_h, pps))
            self.cur = _PicCtx(f, sps, pps, self.pending_sei)
            self.pending_sei = []
        cur = self.cur
        f = cur.f

        # convert coded (raster) slice addresses to encode/tile-scan order
        # (TDecTop.cpp "convert the start and end CU addresses")
        parts = f.parts_per_ctu
        if not sh.dependent_slice:
            lcu = sh.slice_cur_start_cu_addr // parts
            sh.slice_cur_start_cu_addr = int(f.ctu_inv_order[lcu]) * parts
            sh.dependent_slice_start_cu_addr = sh.slice_cur_start_cu_addr
            cur.n_regular += 1
        else:
            lcu = sh.dependent_slice_start_cu_addr // parts
            sh.dependent_slice_start_cu_addr = int(
                f.ctu_inv_order[lcu]) * parts

        list0: list = []
        list1: list = []
        inter_pred = None
        mvctx = None
        if not sh.is_intra:
            list0, list1 = build_ref_lists(sh, self.dpb, sps.bits_for_poc)
            col_pic = None
            if sh.tmvp_enabled:
                col_list = list1 if (sh.slice_type == 0 and sh.col_dir) \
                    else list0
                col_pic = col_list[sh.col_ref_idx]
            ldc = check_ldc(sh, list0, list1)
            mvctx = MvCtx(f, sh, sps, pps, list0, list1, col_pic, ldc)
            inter_pred = InterPredictor(f, sh, sps, pps, list0, list1)

        # WPP: split the slice data into per-row substreams
        # (TDecGop::decompressSlice, TComBitStream::extractSubstream)
        substreams = None
        if pps.num_substreams > 1:
            sizes = list(sh.substream_sizes)
            substreams = []
            for i in range(pps.num_substreams):
                n_bits = sizes[i] if i < len(sizes) else bs.num_bits_left
                substreams.append(bs.extract_substream(n_bits))

        run = _SliceRun(sh, list0, list1, inter_pred, len(f.cu_list))
        from .native_parse import parse_slice_native
        ok, dep_out = parse_slice_native(
            f, sh, sps, pps, bs, mvctx,
            slice_idx=max(cur.n_regular - 1, 0),
            substreams=substreams, dep_ctx_in=cur.dep_ctx)
        if ok:
            cur.dep_ctx = dep_out
        else:
            parser = SliceDataParser(
                f, sh, sps, pps, bs, mvctx,
                slice_idx=max(cur.n_regular - 1, 0),
                substreams=substreams, dep_ctx_in=cur.dep_ctx)
            parser.parse_slice()
            cur.dep_ctx = parser.dep_ctx_out
        run.cu_end = len(f.cu_list)
        cur.slices.append(run)

    def _random_access_skip(self, sh, nal_type: int) -> bool:
        """isRandomAccessSkipPicture (TDecTop.cpp:738): -s counting and
        leading-picture drop before the first random-access point."""
        if self.skip_frames:
            self.skip_frames -= 1
            return True
        if self.poc_random_access == _MAX_INT:
            if nal_type in (nal_mod.NAL_UNIT_CODED_SLICE_CRA,
                            nal_mod.NAL_UNIT_CODED_SLICE_CRANT,
                            nal_mod.NAL_UNIT_CODED_SLICE_BLA,
                            nal_mod.NAL_UNIT_CODED_SLICE_BLANT):
                self.poc_random_access = sh.poc
            elif nal_type == nal_mod.NAL_UNIT_CODED_SLICE_IDR:
                self.poc_random_access = 0
            else:
                if not self._warned_ra:
                    print("\nWarning: this is not a valid random access "
                          "point and the data is discarded until the "
                          "first CRA picture")
                    self._warned_ra = True
                return True
        elif sh.poc < self.poc_random_access and \
                nal_type == nal_mod.NAL_UNIT_CODED_SLICE_TFD:
            return True
        return False

    def _bla_skip(self, sh, nal_type: int) -> bool:
        """isSkipPictureForBLA (TDecTop.cpp:715): TFD pictures that follow
        a BLA in decoding order but precede it in output order."""
        return (self.prev_rap_is_bla and sh.poc < self.poc_cra
                and nal_type == nal_mod.NAL_UNIT_CODED_SLICE_TFD)

    def _create_lost_picture(self, lost_poc: int, sps: Sps, pps: Pps) -> None:
        """xCreateLostPicture (TDecTop.cpp:217): conceal a missing reference
        by cloning the reconstruction of the closest-POC DPB picture."""
        print(f"\ninserting lost poc : {lost_poc}")
        closest = None
        best = _MAX_INT
        for p in self.dpb.pics:
            d = abs(p.poc - lost_poc)
            if 0 < d < best and p.poc != self.prev_poc:
                best, closest = d, p
        f = FrameModel(sps, pps)   # zero motion, ref_idx=-1, no pred modes
        if closest is not None:
            print(f"copying picture {closest.poc} to {lost_poc} "
                  f"({self.prev_poc})")
            planes = (closest.rec_y.copy(), closest.rec_cb.copy(),
                      closest.rec_cr.copy())
        else:
            w = sps.pic_width_in_luma_samples
            h = sps.pic_height_in_luma_samples
            planes = (np.zeros((h, w), np.int16),
                      np.zeros((h // 2, w // 2), np.int16),
                      np.zeros((h // 2, w // 2), np.int16))
        pic = Picture(lost_poc, planes, f, None, [[], []],
                      margin=sps.max_cu_width + 16)
        pic.referenced = True
        self.dpb.add(pic)
        self.pictures.append(DecodedPicture(
            lost_poc, YuvFrame(*planes), output=True))
        if self.poc_random_access == _MAX_INT:
            self.poc_random_access = lost_poc

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
        # the stage's parts are timed in _filter_pictures as filters.*;
        # what is left of it (the call's own Python) is filters.rest
        with stage("filters.rest", self.device):
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

    @staticmethod
    def _resolve_ref_pocs(cur: _PicCtx):
        """Per-unit [2, uh, uw] reference POC + long-term flag from each
        unit's slice's reference lists (ref lists are per-slice in the
        reference)."""
        f = cur.f
        NULLP = -(2 ** 30)
        ref_poc = np.full(f.ref_idx.shape, NULLP, np.int64)
        ref_is_lt = np.zeros(f.ref_idx.shape, bool)
        for si, run in enumerate(cur.slices):
            if run.sh.is_intra:
                continue
            mask = f.slice_idx == Decoder._regular_idx(cur, si)
            for lst, lst_pics in ((0, run.list0), (1, run.list1)):
                for idx, p in enumerate(lst_pics):
                    m = mask & (f.ref_idx[lst] == idx)
                    ref_poc[lst][m] = p.poc
                    if p.is_used_as_long_term:
                        ref_is_lt[lst][m] = True
        return ref_poc, ref_is_lt

    @staticmethod
    def _regular_idx(cur: _PicCtx, slice_pos: int) -> int:
        """Regular-slice index of the slice at position slice_pos (dependent
        slices share their parent's index)."""
        n = -1
        for i in range(slice_pos + 1):
            if not cur.slices[i].sh.dependent_slice:
                n += 1
        return max(n, 0)
