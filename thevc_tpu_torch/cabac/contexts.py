"""CABAC context set: flat state array with named offsets.

Mirrors the ContextModel3DBuffer members of TEncSbac/TDecSbac (TDecSbac.h:173+)
and their initialization in resetEntropy (TDecSbac.cpp:106).  Slice-type init
index: 0=B, 1=P, 2=I; cabac_init_flag swaps P<->B tables
(TDecSbac.cpp:111-124).
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from ..params import B_SLICE, I_SLICE, P_SLICE

# (name, count, init_table) in a fixed layout order
_LAYOUT = [
    ("SPLIT_FLAG", 3, T.INIT_SPLIT_FLAG),
    ("SKIP_FLAG", 3, T.INIT_SKIP_FLAG),
    ("MERGE_FLAG", 1, T.INIT_MERGE_FLAG_EXT),
    ("MERGE_IDX", 1, T.INIT_MERGE_IDX_EXT),
    ("PART_SIZE", 4, T.INIT_PART_SIZE),
    ("AMP", 1, T.INIT_CU_AMP_POS),
    ("PRED_MODE", 1, T.INIT_PRED_MODE),
    ("INTRA_PRED", 1, T.INIT_INTRA_PRED_MODE),
    ("CHROMA_PRED", 2, T.INIT_CHROMA_PRED_MODE),
    ("INTER_DIR", 5, T.INIT_INTER_DIR),
    ("MVD", 2, T.INIT_MVD),
    ("REF_PIC", 2, T.INIT_REF_PIC),
    ("DQP", 3, T.INIT_DQP),
    ("QT_CBF", 10, T.INIT_QT_CBF),           # [0:5] luma, [5:10] chroma
    ("QT_ROOT_CBF", 1, T.INIT_QT_ROOT_CBF),
    ("SIG_CG", 4, T.INIT_SIG_CG_FLAG),       # [0:2] luma, [2:4] chroma
    ("SIG", 42, T.INIT_SIG_FLAG),            # [0:27] luma, [27:42] chroma
    ("LAST_X", 30, T.INIT_LAST),             # [0:15] luma, [15:30] chroma
    ("LAST_Y", 30, T.INIT_LAST),
    ("ONE", 24, T.INIT_ONE_FLAG),            # [0:16] luma, [16:24] chroma
    ("ABS", 6, T.INIT_ABS_FLAG),             # [0:4] luma, [4:6] chroma
    ("MVP_IDX", 2, T.INIT_MVP_IDX),
    ("SAO_MERGE", 1, T.INIT_SAO_MERGE_FLAG),
    ("SAO_TYPE", 1, T.INIT_SAO_TYPE_IDX),
    ("TRANS_SUBDIV", 3, T.INIT_TRANS_SUBDIV_FLAG),
    ("TS_FLAG", 2, T.INIT_TRANSFORMSKIP_FLAG),  # [0] luma, [1] chroma
    ("TQ_BYPASS", 1, T.INIT_CU_TRANSQUANT_BYPASS_FLAG),
]

OFFSETS = {}
_off = 0
for _name, _count, _tbl in _LAYOUT:
    OFFSETS[_name] = _off
    _off += _count
NUM_CTX = _off

# module-level constants for fast access
O_SPLIT_FLAG = OFFSETS["SPLIT_FLAG"]
O_SKIP_FLAG = OFFSETS["SKIP_FLAG"]
O_MERGE_FLAG = OFFSETS["MERGE_FLAG"]
O_MERGE_IDX = OFFSETS["MERGE_IDX"]
O_PART_SIZE = OFFSETS["PART_SIZE"]
O_AMP = OFFSETS["AMP"]
O_PRED_MODE = OFFSETS["PRED_MODE"]
O_INTRA_PRED = OFFSETS["INTRA_PRED"]
O_CHROMA_PRED = OFFSETS["CHROMA_PRED"]
O_INTER_DIR = OFFSETS["INTER_DIR"]
O_MVD = OFFSETS["MVD"]
O_REF_PIC = OFFSETS["REF_PIC"]
O_DQP = OFFSETS["DQP"]
O_QT_CBF = OFFSETS["QT_CBF"]
O_QT_ROOT_CBF = OFFSETS["QT_ROOT_CBF"]
O_SIG_CG = OFFSETS["SIG_CG"]
O_SIG = OFFSETS["SIG"]
O_LAST_X = OFFSETS["LAST_X"]
O_LAST_Y = OFFSETS["LAST_Y"]
O_ONE = OFFSETS["ONE"]
O_ABS = OFFSETS["ABS"]
O_MVP_IDX = OFFSETS["MVP_IDX"]
O_SAO_MERGE = OFFSETS["SAO_MERGE"]
O_SAO_TYPE = OFFSETS["SAO_TYPE"]
O_TRANS_SUBDIV = OFFSETS["TRANS_SUBDIV"]
O_TS_FLAG = OFFSETS["TS_FLAG"]
O_TQ_BYPASS = OFFSETS["TQ_BYPASS"]

NUM_SIG_FLAG_CTX_LUMA = 27


def make_context_states(slice_type: int, qp: int,
                        cabac_init_flag: bool = False) -> np.ndarray:
    """Build the initialized flat context-state array for a slice."""
    init_type = slice_type
    if cabac_init_flag:
        if slice_type == P_SLICE:
            init_type = B_SLICE
        elif slice_type == B_SLICE:
            init_type = P_SLICE
        else:
            raise ValueError("cabac_init_flag on I slice")
    return make_context_states_idx(init_type, qp)


def make_context_states_idx(init_type: int, qp: int) -> np.ndarray:
    """Initialize directly from a table index (encoder side, where the
    init table is the PPS's encCABACTableIdx rather than the slice type)."""
    states = np.empty(NUM_CTX, dtype=np.uint8)
    off = 0
    for name, count, tbl in _LAYOUT:
        vals = tbl[init_type][:count]
        for i, v in enumerate(vals):
            states[off + i] = T.init_state(qp, v)
        off += count
    return states


# ContextModel3DBuffer::calcCost's state->LPS-probability map
_STATE_TO_PROB_LPS = (
    0.50000000, 0.47460857, 0.45050660, 0.42762859, 0.40591239, 0.38529900,
    0.36573242, 0.34715948, 0.32952974, 0.31279528, 0.29691064, 0.28183267,
    0.26752040, 0.25393496, 0.24103941, 0.22879875, 0.21717969, 0.20615069,
    0.19568177, 0.18574449, 0.17631186, 0.16735824, 0.15885931, 0.15079198,
    0.14313433, 0.13586556, 0.12896592, 0.12241667, 0.11620000, 0.11029903,
    0.10469773, 0.09938088, 0.09433404, 0.08954349, 0.08499621, 0.08067986,
    0.07658271, 0.07269362, 0.06900203, 0.06549791, 0.06217174, 0.05901448,
    0.05601756, 0.05317283, 0.05047256, 0.04790942, 0.04547644, 0.04316702,
    0.04097487, 0.03889405, 0.03691890, 0.03504406, 0.03326442, 0.03157516,
    0.02997168, 0.02844963, 0.02700488, 0.02563349, 0.02433175, 0.02309612,
    0.02192323, 0.02080991, 0.01975312, 0.01875000)


def determine_cabac_init_idx(states: np.ndarray, used: np.ndarray,
                             qp: int) -> int:
    """TEncSbac::determineCabacInitIdx (TEncSbac.cpp:175): choose the init
    table (B or P) whose states are cheapest under the slice-final context
    probabilities; only contexts that coded at least one bin count
    (ContextModel3DBuffer::calcCost)."""
    best_cost = None
    best_type = B_SLICE
    eb = T.ENTROPY_BITS
    for cand in (B_SLICE, P_SLICE):
        cost = 0
        off = 0
        for name, count, tbl in _LAYOUT:
            vals = tbl[cand][:count]
            for i, v in enumerate(vals):
                if not used[off + i]:
                    continue
                st = int(states[off + i])
                prob_lps = _STATE_TO_PROB_LPS[st >> 1]
                if st & 1:
                    p0, p1 = prob_lps, 1.0 - prob_lps
                else:
                    p1, p0 = prob_lps, 1.0 - prob_lps
                tmp = int(T.init_state(qp, v))
                cost += int(p0 * int(eb[tmp]) + p1 * int(eb[tmp ^ 1]))
            off += count
        if best_cost is None or cost < best_cost:
            best_cost = cost
            best_type = cand
    return best_type
