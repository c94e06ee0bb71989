"""HM-compatible encoder configuration: cfg-file parsing + defaults.

Behavioral reference: TAppEncCfg.cpp (parseCfg option table :154, GOPEntry
istream operator, xCheckParameter derivations :700+) and
program_options_lite.cpp (cfg-file syntax: `Name : value # comment`).

Only the option surface exercised by the shipped cfg files is materialized;
unknown keys are kept in `extras` rather than rejected (the reference prints
"Unhandled argument ignored" for unknown command-line options but accepts
every cfg key that matches an option).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GopEntry:
    """One FrameN line (TAppEncCfg.h GOPEntry)."""
    slice_type: str = "P"
    poc: int = 0
    qp_offset: int = 0
    qp_factor: float = 0.0
    temporal_id: int = 0
    num_ref_pics_active: int = 0
    ref_pic: bool = False
    num_ref_pics: int = 0
    reference_pics: List[int] = field(default_factory=list)
    used_by_curr_pic: List[bool] = field(default_factory=list)
    inter_rps_prediction: int = 0
    delta_rps: int = 0
    num_ref_idc: int = 0
    ref_idc: List[int] = field(default_factory=list)


def _parse_gop_entry(text: str) -> GopEntry:
    """GOPEntry operator>> (TAppEncCfg.cpp:84)."""
    toks = text.split()
    ge = GopEntry()
    it = iter(toks)

    def nxt(cast, default=None):
        try:
            return cast(next(it))
        except StopIteration:
            if default is None:
                raise
            return default

    ge.slice_type = nxt(str)
    ge.poc = nxt(int)
    ge.qp_offset = nxt(int)
    ge.qp_factor = nxt(float)
    ge.temporal_id = nxt(int)
    ge.num_ref_pics_active = nxt(int)
    ge.ref_pic = bool(nxt(int))
    ge.num_ref_pics = nxt(int, 0)
    for _ in range(ge.num_ref_pics):
        ref = nxt(int)
        ge.reference_pics.append(ref)
        ge.used_by_curr_pic.append(True)
    ge.inter_rps_prediction = nxt(int, 0)
    if ge.inter_rps_prediction == 1:
        ge.delta_rps = nxt(int, 0)
        ge.num_ref_idc = nxt(int, 0)
        ge.ref_idc = [nxt(int, 0) for _ in range(ge.num_ref_idc)]
    elif ge.inter_rps_prediction == 2:
        ge.delta_rps = nxt(int, 0)
    return ge


# Option-name -> (attribute, type).  Types: int, float, bool-as-int, str.
_OPTIONS = {
    "InputFile": ("input_file", str), "i": ("input_file", str),
    "BitstreamFile": ("bitstream_file", str), "b": ("bitstream_file", str),
    "ReconFile": ("recon_file", str), "o": ("recon_file", str),
    "CheckpointFile": ("checkpoint_file", str),
    "CheckpointEvery": ("checkpoint_every", int),
    "ResumeFile": ("resume_file", str),
    "SourceWidth": ("source_width", int), "wdt": ("source_width", int),
    "SourceHeight": ("source_height", int), "hgt": ("source_height", int),
    "InputBitDepth": ("input_bit_depth", int),
    "BitDepth": ("input_bit_depth", int),
    "OutputBitDepth": ("output_bit_depth", int),
    "InternalBitDepth": ("internal_bit_depth", int),
    "FrameRate": ("frame_rate", int), "fr": ("frame_rate", int),
    "FrameSkip": ("frame_skip", int), "fs": ("frame_skip", int),
    "FramesToBeEncoded": ("frames_to_be_encoded", int),
    "f": ("frames_to_be_encoded", int),
    "MaxCUWidth": ("max_cu_width", int),
    "MaxCUHeight": ("max_cu_height", int),
    "MaxCUSize": ("max_cu_size", int), "s": ("max_cu_size", int),
    "MaxPartitionDepth": ("max_partition_depth", int),
    "h": ("max_partition_depth", int),
    "QuadtreeTULog2MaxSize": ("qt_tu_log2_max", int),
    "QuadtreeTULog2MinSize": ("qt_tu_log2_min", int),
    "QuadtreeTUMaxDepthIntra": ("qt_tu_max_depth_intra", int),
    "QuadtreeTUMaxDepthInter": ("qt_tu_max_depth_inter", int),
    "IntraPeriod": ("intra_period", int), "ip": ("intra_period", int),
    "DecodingRefreshType": ("decoding_refresh_type", int),
    "GOPSize": ("gop_size", int), "g": ("gop_size", int),
    "ListCombination": ("use_lcomb", int),
    "FastSearch": ("fast_search", int),
    "SearchRange": ("search_range", int), "sr": ("search_range", int),
    "BipredSearchRange": ("bipred_search_range", int),
    "HadamardME": ("use_had_me", int),
    "ASR": ("use_asr", int),
    "QP": ("qp", float), "q": ("qp", float),
    "DeltaQpRD": ("delta_qp_rd", int), "dqr": ("delta_qp_rd", int),
    "MaxDeltaQP": ("max_delta_qp", int), "d": ("max_delta_qp", int),
    "MaxCuDQPDepth": ("max_cu_dqp_depth", int),
    "dqd": ("max_cu_dqp_depth", int),
    "CbQpOffset": ("cb_qp_offset", int), "cbqpofs": ("cb_qp_offset", int),
    "CrQpOffset": ("cr_qp_offset", int), "crqpofs": ("cr_qp_offset", int),
    "AdaptiveQpSelection": ("use_adapt_qp_select", int),
    "aqps": ("use_adapt_qp_select", int),
    "AdaptiveQP": ("use_adaptive_qp", int), "aq": ("use_adaptive_qp", int),
    "MaxQPAdaptationRange": ("qp_adaptation_range", int),
    "aqr": ("qp_adaptation_range", int),
    "dQPFile": ("dqp_file", str), "m": ("dqp_file", str),
    "RDOQ": ("use_rdoq", int),
    # extension beyond the HM surface: device-decided fast RD mode
    # (thevc_tpu/encoder/fast_intra.py); 0 = HM-exact full search
    "FastRD": ("fast_rd", int),
    "SBACRD": ("use_sbac_rd", int),
    "LoopFilterDisable": ("loop_filter_disable", int),
    "LoopFilterOffsetInPPS": ("loop_filter_offset_in_pps", int),
    "LoopFilterBetaOffset_div2": ("loop_filter_beta_offset_div2", int),
    "LoopFilterTcOffset_div2": ("loop_filter_tc_offset_div2", int),
    "DeblockingFilterControlPresent": ("dbf_control_present", int),
    "NSQT": ("enable_nsqt", int),
    "AMP": ("enable_amp", int),
    "LMChroma": ("use_lm_chroma", int),
    "TS": ("use_transform_skip", int),
    "TSFast": ("use_transform_skip_fast", int),
    "ALF": ("use_alf", int),
    "SAO": ("use_sao", int),
    "MaxNumOffsetsPerPic": ("max_num_offsets_per_pic", int),
    "SAOLcuBasedOptimization": ("sao_lcu_based_optimization", int),
    "SliceMode": ("slice_mode", int),
    "SliceArgument": ("slice_argument", int),
    "DependentSliceMode": ("dependent_slice_mode", int),
    "DependentSliceArgument": ("dependent_slice_argument", int),
    "CabacIndependentFlag": ("cabac_independent_flag", int),
    "SliceGranularity": ("slice_granularity", int),
    "LFCrossSliceBoundaryFlag": ("lf_cross_slice_boundary_flag", int),
    "ConstrainedIntraPred": ("constrained_intra_pred", int),
    "PCMEnabledFlag": ("use_pcm", int),
    "PCMLog2MaxSize": ("pcm_log2_max_size", int),
    "PCMLog2MinSize": ("pcm_log2_min_size", int),
    "PCMInputBitDepthFlag": ("pcm_input_bit_depth_flag", int),
    "PCMFilterDisableFlag": ("pcm_filter_disable_flag", int),
    "LosslessCuEnabled": ("use_lossless", int),
    "weighted_pred_flag": ("use_weighted_pred", int),
    "wpP": ("use_weighted_pred", int),
    "weighted_bipred_flag": ("use_weighted_bipred", int),
    "wpB": ("use_weighted_bipred", int),
    "Log2ParallelMergeLevel": ("log2_parallel_merge_level", int),
    "UniformSpacingIdc": ("uniform_spacing_idc", int),
    "NumTileColumnsMinus1": ("num_tile_columns_minus1", int),
    "ColumnWidthArray": ("column_width_array", str),
    "NumTileRowsMinus1": ("num_tile_rows_minus1", int),
    "RowHeightArray": ("row_height_array", str),
    "LFCrossTileBoundaryFlag": ("lf_cross_tile_boundary_flag", int),
    "WaveFrontSynchro": ("wavefront_synchro", int),
    "ScalingList": ("scaling_list", int),
    "ScalingListFile": ("scaling_list_file", str),
    "SignHideFlag": ("sign_hide_flag", int), "SBH": ("sign_hide_flag", int),
    "SEIpictureDigest": ("picture_digest", int),
    "TMVPMode": ("tmvp_mode", int),
    "FEN": ("use_fast_enc", int),
    "ECU": ("use_early_cu", int),
    "FDM": ("use_fast_decision_for_merge", int),
    "CFM": ("use_cbf_fast_mode", int),
    "ESD": ("use_early_skip_detection", int),
    "RateCtrl": ("use_rate_ctrl", int),
    "TargetBitrate": ("target_bitrate", int), "tbr": ("target_bitrate", int),
    "NumLCUInUnit": ("num_lcu_in_unit", int),
    "TransquantBypassEnableFlag": ("transquant_bypass_enable_flag", int),
    "CUTransquantBypassFlagValue": ("cu_transquant_bypass_flag_value", int),
    "CroppingMode": ("cropping_mode", int),
    "HorizontalPadding": ("pad_x", int), "pdx": ("pad_x", int),
    "VerticalPadding": ("pad_y", int), "pdy": ("pad_y", int),
    "CropLeft": ("crop_left", int),
    "CropRight": ("crop_right", int),
    "CropTop": ("crop_top", int),
    "CropBottom": ("crop_bottom", int),
    "RecalculateQPAccordingToLambda":
        ("recalculate_qp_according_to_lambda", int),
}


@dataclass
class EncoderCfg:
    """TAppEncCfg state with the reference defaults (TAppEncCfg.cpp:167+)."""
    input_file: str = ""
    bitstream_file: str = ""
    recon_file: str = ""
    # checkpoint/resume (no reference counterpart; all cross-frame encoder
    # state lives in an explicit serializable set — SURVEY.md section 5)
    checkpoint_file: str = ""
    checkpoint_every: int = 0
    resume_file: str = ""
    source_width: int = 0
    source_height: int = 0
    input_bit_depth: int = 8
    output_bit_depth: int = 0
    internal_bit_depth: int = 0
    frame_rate: int = 0
    frame_skip: int = 0
    frames_to_be_encoded: int = 0
    max_cu_width: int = 64
    max_cu_height: int = 64
    max_partition_depth: int = 4
    qt_tu_log2_max: int = 6
    qt_tu_log2_min: int = 2
    qt_tu_max_depth_intra: int = 1
    qt_tu_max_depth_inter: int = 2
    intra_period: int = -1
    decoding_refresh_type: int = 0
    gop_size: int = 1
    use_lcomb: int = 1
    fast_search: int = 1
    search_range: int = 96
    bipred_search_range: int = 4
    use_had_me: int = 1
    use_asr: int = 0
    qp: float = 30.0
    delta_qp_rd: int = 0
    max_delta_qp: int = 0
    max_cu_dqp_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    use_adapt_qp_select: int = 0
    use_adaptive_qp: int = 0
    qp_adaptation_range: int = 6
    dqp_file: str = ""
    use_rdoq: int = 1
    fast_rd: int = 0
    use_sbac_rd: int = 1
    loop_filter_disable: int = 0
    loop_filter_offset_in_pps: int = 0
    loop_filter_beta_offset_div2: int = 0
    loop_filter_tc_offset_div2: int = 0
    dbf_control_present: int = 0
    enable_nsqt: int = 0       # REMOVE_NSQT build: tool absent
    enable_amp: int = 1
    use_lm_chroma: int = 0     # REMOVE_LMCHROMA build: tool absent
    use_transform_skip: int = 0
    use_transform_skip_fast: int = 0
    use_alf: int = 0           # REMOVE_ALF build: tool absent
    use_sao: int = 1
    max_num_offsets_per_pic: int = 2048
    sao_lcu_based_optimization: int = 1
    slice_mode: int = 0
    slice_argument: int = 0
    dependent_slice_mode: int = 0
    dependent_slice_argument: int = 0
    cabac_independent_flag: int = 0
    slice_granularity: int = 0
    lf_cross_slice_boundary_flag: int = 1
    constrained_intra_pred: int = 0
    use_pcm: int = 0
    pcm_log2_max_size: int = 5
    pcm_log2_min_size: int = 3
    pcm_input_bit_depth_flag: int = 1
    pcm_filter_disable_flag: int = 0
    use_lossless: int = 0
    use_weighted_pred: int = 0
    use_weighted_bipred: int = 0
    log2_parallel_merge_level: int = 2
    uniform_spacing_idc: int = 0
    num_tile_columns_minus1: int = 0
    column_width_array: str = ""
    num_tile_rows_minus1: int = 0
    row_height_array: str = ""
    lf_cross_tile_boundary_flag: int = 1
    wavefront_synchro: int = 0
    scaling_list: int = 0
    scaling_list_file: str = ""
    sign_hide_flag: int = 1
    picture_digest: int = 0
    tmvp_mode: int = 1
    use_fast_enc: int = 0
    use_early_cu: int = 0
    use_fast_decision_for_merge: int = 1
    use_cbf_fast_mode: int = 0
    use_early_skip_detection: int = 0
    use_rate_ctrl: int = 0
    target_bitrate: int = 0
    num_lcu_in_unit: int = 0
    transquant_bypass_enable_flag: int = 0
    cu_transquant_bypass_flag_value: int = 0
    cropping_mode: int = 0
    pad_x: int = 0
    pad_y: int = 0
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    # LambdaModifier0-7 (-LM0..-LM7, TAppEncCfg.cpp:219-226), indexed by
    # temporal layer in initEncSlice (TEncSlice.cpp:315) and by depth in
    # xLamdaRecalculation (TEncSlice.cpp:476)
    lambda_modifier: List[float] = field(
        default_factory=lambda: [1.0] * 8)
    recalculate_qp_according_to_lambda: int = 0
    gop_list: List[GopEntry] = field(default_factory=list)
    extras: Dict[str, str] = field(default_factory=dict)

    # ---- derived (xCheckParameter) ----
    @property
    def bit_increment(self) -> int:
        internal = self.internal_bit_depth or self.input_bit_depth
        return internal - 8

    @property
    def max_temp_layer(self) -> int:
        m = 1
        for ge in self.gop_list[:self.gop_size]:
            m = max(m, ge.temporal_id + 1)
        return m

    def dpb_params(self):
        """numReorderPics / maxDecPicBuffering (TAppEncCfg.cpp:832-887)."""
        max_tl = 8
        num_reorder = [0] * max_tl
        max_dpb = [0] * max_tl
        gops = self.gop_list[:self.gop_size]
        for i, ge in enumerate(gops):
            max_dpb[ge.temporal_id] = max(max_dpb[ge.temporal_id],
                                          ge.num_ref_pics)
            highest = 0
            for j, gj in enumerate(gops):
                if gj.poc <= ge.poc:
                    highest = j
            reorder = sum(1 for j in range(highest)
                          if gops[j].temporal_id <= ge.temporal_id
                          and gops[j].poc > ge.poc)
            num_reorder[ge.temporal_id] = max(num_reorder[ge.temporal_id],
                                              reorder)
        for i in range(max_tl - 1):
            num_reorder[i + 1] = max(num_reorder[i + 1], num_reorder[i])
            max_dpb[i] = max(max_dpb[i], num_reorder[i])
            max_dpb[i + 1] = max(max_dpb[i + 1], max_dpb[i])
        max_dpb[-1] = max(max_dpb[-1], num_reorder[-1])
        return num_reorder, max_dpb

    def apply(self, key: str, value: str) -> None:
        if key == "MaxCUSize" or key == "s":
            self.max_cu_width = self.max_cu_height = int(value)
            return
        if (key.startswith("LambdaModifier") and key[14:].isdigit()) or \
                (key.startswith("LM") and key[2:].isdigit()):
            idx = int(key[14:] if key.startswith("LambdaModifier")
                      else key[2:])
            if 0 <= idx < 8:
                self.lambda_modifier[idx] = float(value)
                return
        if key.startswith("Frame") and key[5:].isdigit():
            idx = int(key[5:]) - 1
            while len(self.gop_list) <= idx:
                self.gop_list.append(GopEntry())
            self.gop_list[idx] = _parse_gop_entry(value)
            return
        opt = _OPTIONS.get(key)
        if opt is None:
            # program_options_lite.cpp:264 warns and continues; kept in
            # extras so tools can still inspect unconsumed keys
            import sys
            print("Unknown option: `%s' (value:`%s')" % (key, value),
                  file=sys.stderr)
            self.extras[key] = value
            return
        attr, cast = opt
        if cast is int:
            setattr(self, attr, int(value))
        elif cast is float:
            setattr(self, attr, float(value))
        else:
            setattr(self, attr, value)


def parse_cfg_file(path: str, cfg: Optional[EncoderCfg] = None) -> EncoderCfg:
    """program_options_lite::parseConfigFile syntax."""
    cfg = cfg or EncoderCfg()
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, value = line.split(":", 1)
            cfg.apply(key.strip(), value.strip())
    return cfg


def print_help(file=None) -> None:
    """Option table like program_options_lite doHelp
    (program_options_lite.cpp:141): long name, short alias, default."""
    import sys
    file = file or sys.stdout
    defaults = EncoderCfg()
    # group aliases (opt names of length <= 5 that share an attribute with
    # a long name) under their long form, like HM's `--Long,-short` rows
    longs: Dict[str, List[str]] = {}
    shorts: Dict[str, List[str]] = {}
    for name, (attr, _) in _OPTIONS.items():
        (shorts if name.islower() else longs).setdefault(attr, []).append(name)
    print("Options:", file=file)
    print("  -c <file>%sread options from a config file (repeatable)"
          % (" " * 27), file=file)
    print("  --help%sprint this usage text" % (" " * 30), file=file)
    for name, (attr, _) in sorted(_OPTIONS.items()):
        if name.islower():
            continue                      # short alias: shown with the long
        alias = ",".join("-" + s for s in shorts.get(attr, []))
        left = "  --%s%s" % (name, (" (%s)" % alias) if alias else "")
        dflt = getattr(defaults, attr, "")
        print("%-38s[%s]" % (left, dflt), file=file)
    print("  --LambdaModifier0..7 (-LM0..-LM7)     [1.0]", file=file)
    print("  --Frame1..N: <GOP entry>              []", file=file)


def parse_args(argv: List[str]) -> EncoderCfg:
    """Command line compatible with TAppEncoder: -c cfg, --Key=value,
    the short aliases (-i, -b, -o, -wdt, -hgt, -f, -fr, -q, ...), and
    --help / no-args usage printing (TAppEncCfg.cpp:168,344 doHelp)."""
    import sys
    if not argv or "--help" in argv:
        print_help()
        raise SystemExit(0 if argv else 1)

    def value_after(i: int, arg: str) -> str:
        if i + 1 >= len(argv):
            # program_options_lite scanArgv: option expects an argument
            raise SystemExit("Option `%s' expects an argument" % arg)
        return argv[i + 1]

    cfg = EncoderCfg()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "-c":
            parse_cfg_file(value_after(i, arg), cfg)
            i += 2
            continue
        if arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                key, value = body.split("=", 1)
            else:
                key, value = body, value_after(i, arg)
                i += 1
            cfg.apply(key, value)
            i += 1
            continue
        if arg.startswith("-"):
            key = arg[1:]
            cfg.apply(key, value_after(i, arg))
            i += 2
            continue
        raise ValueError(f"unhandled argument: {arg}")
    check_parameters(cfg)
    return cfg


def check_parameters(cfg: "EncoderCfg") -> None:
    """Subset of TAppEncCfg::xCheckParameter (TAppEncCfg.cpp:551-580)
    covering the partitioning-mode combinations, plus the cropping-mode
    source-size derivation (TAppEncCfg.cpp:365-393)."""
    if cfg.cropping_mode == 0:
        cfg.crop_left = cfg.crop_right = cfg.crop_top = cfg.crop_bottom = 0
        cfg.pad_x = cfg.pad_y = 0
    elif cfg.cropping_mode == 1:
        # automatic padding to the minimum CU size
        min_cu = cfg.max_cu_height >> (cfg.max_partition_depth - 1)
        cfg.crop_left = cfg.crop_top = 0
        cfg.pad_x = cfg.pad_y = 0
        if cfg.source_width % min_cu:
            cfg.pad_x = cfg.crop_right = \
                (cfg.source_width // min_cu + 1) * min_cu - cfg.source_width
            cfg.source_width += cfg.crop_right
        else:
            cfg.crop_right = 0
        if cfg.source_height % min_cu:
            cfg.pad_y = cfg.crop_bottom = \
                (cfg.source_height // min_cu + 1) * min_cu - cfg.source_height
            cfg.source_height += cfg.crop_bottom
        else:
            cfg.crop_bottom = 0
        if cfg.pad_x % 2 or cfg.pad_y % 2:   # 4:2:0 crop units
            raise ValueError("picture size not a multiple of the chroma "
                             "subsampling after padding")
    elif cfg.cropping_mode == 2:
        cfg.source_width += cfg.pad_x
        cfg.source_height += cfg.pad_y
        cfg.crop_right = cfg.pad_x
        cfg.crop_bottom = cfg.pad_y
        cfg.crop_left = cfg.crop_top = 0
    elif cfg.cropping_mode == 3:
        cfg.pad_x = cfg.pad_y = 0
    if not 0 <= cfg.slice_mode <= 3:
        raise ValueError("SliceMode exceeds supported range (0 to 3)")
    if cfg.slice_mode != 0 and cfg.slice_argument < 1:
        raise ValueError("SliceArgument should be larger than or equal to 1")
    if not 0 <= cfg.dependent_slice_mode <= 2:
        raise ValueError("DependentSliceMode exceeds supported range (0 to 2)")
    if cfg.dependent_slice_mode != 0 and cfg.dependent_slice_argument < 1:
        raise ValueError(
            "DependentSliceArgument should be larger than or equal to 1")
    tile_flag = cfg.num_tile_columns_minus1 > 0 or cfg.num_tile_rows_minus1 > 0
    if tile_flag and cfg.dependent_slice_mode:
        raise ValueError("Tile and Dependent Slice can not be applied "
                         "together")
    if tile_flag and cfg.wavefront_synchro:
        raise ValueError("Tile and Wavefront can not be applied together")
    if (cfg.use_weighted_pred or cfg.use_weighted_bipred) and \
            (cfg.slice_mode == 2 or cfg.dependent_slice_mode == 2):
        # TEncSlice.cpp:699-704 exits at runtime; rejected up front here
        raise ValueError("Weighted Prediction is not supported with slice "
                         "mode determined by max number of bins")


def expand_gop(cfg) -> int:
    """GOP verification + startup extra-RPS construction (the coding-order
    sweep in TAppEncCfg::xCheckParameter :633-821).  Appends the extra GOP
    entries to cfg.gop_list and returns the extra count."""
    import copy
    gop_size = cfg.gop_size
    gop = cfg.gop_list
    if getattr(cfg, "_gop_expanded", False):
        return cfg.extra_rpss
    verified = False
    error = False
    check_gop = 1
    ref_list = [0]
    is_ok = [False] * 64
    num_ok = 0
    extra = 0
    while not verified and not error:
        cur_gop = (check_gop - 1) % gop_size
        cur_poc = ((check_gop - 1) // gop_size) * gop_size + gop[cur_gop].poc
        if gop[cur_gop].poc < 0:
            error = True
            break
        before_i = False
        for i in range(gop[cur_gop].num_ref_pics):
            abs_poc = cur_poc + gop[cur_gop].reference_pics[i]
            if abs_poc < 0:
                before_i = True
            else:
                found = False
                for rp in ref_list:
                    if rp == abs_poc:
                        found = True
                        for k in range(gop_size):
                            if abs_poc % gop_size == gop[k].poc % gop_size:
                                gop[cur_gop].used_by_curr_pic[i] = \
                                    gop[k].temporal_id <= \
                                    gop[cur_gop].temporal_id
                if not found:
                    error = True
        if not before_i and not error:
            if not is_ok[cur_gop]:
                num_ok += 1
                is_ok[cur_gop] = True
                if num_ok == gop_size:
                    verified = True
        else:
            ge = copy.deepcopy(gop[cur_gop])
            new_refs = 0
            ge.reference_pics = []
            ge.used_by_curr_pic = []
            for i in range(gop[cur_gop].num_ref_pics):
                abs_poc = cur_poc + gop[cur_gop].reference_pics[i]
                if abs_poc >= 0:
                    ge.reference_pics.append(gop[cur_gop].reference_pics[i])
                    ge.used_by_curr_pic.append(
                        gop[cur_gop].used_by_curr_pic[i])
                    new_refs += 1
            num_pref = gop[cur_gop].num_ref_pics_active
            offset = -1
            while offset > -check_gop:
                off_gop = (check_gop - 1 + offset) % gop_size
                off_poc = ((check_gop - 1 + offset) // gop_size) * gop_size \
                    + gop[off_gop].poc
                if off_poc >= 0 and gop[off_gop].ref_pic and \
                        gop[off_gop].temporal_id <= \
                        gop[cur_gop].temporal_id:
                    new_ref = any(rp == off_poc for rp in ref_list)
                    for i in range(new_refs):
                        if ge.reference_pics[i] == off_poc - cur_poc:
                            new_ref = False
                    if new_ref:
                        insert = new_refs
                        for j in range(new_refs):
                            if ge.reference_pics[j] < off_poc - cur_poc or \
                                    ge.reference_pics[j] > 0:
                                insert = j
                                break
                        ge.reference_pics.insert(insert, off_poc - cur_poc)
                        ge.used_by_curr_pic.insert(
                            insert, gop[off_gop].temporal_id <=
                            gop[cur_gop].temporal_id)
                        new_refs += 1
                if new_refs >= num_pref:
                    break
                offset -= 1
            ge.num_ref_pics = new_refs
            ge.poc = cur_poc
            if extra == 0:
                ge.inter_rps_prediction = 0
                ge.num_ref_idc = 0
                ge.ref_idc = []
            else:
                ref_ge = gop[gop_size + extra - 1]
                ref_poc = ref_ge.poc
                ref_pics = ref_ge.num_ref_pics
                ge.ref_idc = []
                for i in range(ref_pics + 1):
                    delta = ref_ge.reference_pics[i] if i != ref_pics else 0
                    abs_ref = ref_poc + delta
                    idc = 0
                    for j in range(ge.num_ref_pics):
                        if abs_ref - cur_poc == ge.reference_pics[j]:
                            idc = 1 if ge.used_by_curr_pic[j] else 2
                    ge.ref_idc.append(idc)
                ge.inter_rps_prediction = 1
                ge.num_ref_idc = ref_pics + 1
                ge.delta_rps = ref_poc - cur_poc
            gop.append(ge)
            cur_gop = gop_size + extra
            extra += 1
        ref_list = []
        for i in range(gop[cur_gop].num_ref_pics):
            abs_poc = cur_poc + gop[cur_gop].reference_pics[i]
            if abs_poc >= 0:
                ref_list.append(abs_poc)
        ref_list.append(cur_poc)
        check_gop += 1
    assert not error, "invalid GOP structure"
    cfg.extra_rpss = extra
    cfg._gop_expanded = True
    return extra
