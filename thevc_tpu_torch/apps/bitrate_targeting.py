"""Bitrate-targeting tools (BitrateTargeting/).

Behavioral reference: source/App/utils/BitrateTargeting/ —
ExtractBitrates.cpp (average per-temporal-layer bitrates from encoder
logs), GuessLambdaModifiers.cpp (iterative lambda-modifier estimation:
extrapolation / secant interpolation + intra/inter dampening), and the
targetBitrates.sh driver loop.

CLI mirrors the two reference executables:
  python -m thevc_tpu_torch.apps.bitrate_targeting extract   < encoder.log
  python -m thevc_tpu_torch.apps.bitrate_targeting guess ADJ "R0 R1 ..." < metalog
The meta-log format is one line per iteration:
  -LM0 1.0 -LM1 1.0 ...;R0 R1 ...
"""

from __future__ import annotations

import math
import re
import sys
from typing import Dict, List, Sequence, Tuple


# ---------------------------------------------------------------------------
# ExtractBitrates
# ---------------------------------------------------------------------------

# "POC    1 TId: 0 ( P-SLICE, nQP 35 QP 35 )        192 bits ..."
# (the reference's char-level parse lands on the nQP value as the QP index)
_POC_RE = re.compile(
    r"^POC\s+\d+[^(]*\(\s+([A-Z])-SLICE,\s+nQP\s+(\d+)[^)]*\)\s+(\d+)\s+bits")


def extract_bitrates_for_qps(lines) -> Dict[int, float]:
    """extractBitratesForQPs (ExtractBitrates.cpp:46): average bits of the
    non-I POC lines, keyed by the QP-index column."""
    tally: Dict[int, List[float]] = {}
    for line in lines:
        m = _POC_RE.match(line)
        if not m:
            continue
        if m.group(1) == "I":
            continue
        qp_index = int(m.group(2))
        bits = int(m.group(3))
        tally.setdefault(qp_index, []).append(float(bits))
    return {k: sum(v) / len(v) for k, v in sorted(tally.items())}


def extract_bitrates_for_temporal_layers(lines) -> List[float]:
    """extractBitratesForTemporalLayers: the QP-index set must be
    contiguous (NonContiguousQPSetException otherwise)."""
    per_qp = extract_bitrates_for_qps(lines)
    result = []
    expected = None
    for qp, rate in per_qp.items():
        if expected is not None and qp != expected:
            raise ValueError("non-contiguous QP set in log")
        expected = qp + 1
        result.append(rate)
    return result


# ---------------------------------------------------------------------------
# GuessLambdaModifiers
# ---------------------------------------------------------------------------

def _increment_lambda_modifier(adj: float, target: float,
                               point: Tuple[float, float]) -> float:
    """incrementLambdaModifier: proportional extrapolation from one point."""
    lm, rate = point
    extrapolated = lm * target / rate
    return lm + adj * (extrapolated - lm)


def _polate_lambda_modifier(target: float, p1, p2) -> float:
    """polateLambdaModifier: secant through the last two points."""
    lm1, r1 = p1
    lm2, r2 = p2
    return lm1 + (lm1 - lm2) / (r1 - r2) * (target - r1)


def guess_lambda_modifier(adj: float, target: float,
                          points: Sequence[Tuple[float, float]],
                          inter_dampening: float) -> float:
    """guessLambdaModifier (GuessLambdaModifiers.cpp:80): secant step when
    two usable points exist, else proportional increment; then log-shaped
    intra dampening and halving inter dampening until positive."""
    if len(points) == 1:
        preliminary = _increment_lambda_modifier(adj, target, points[-1])
    else:
        p1, p2 = points[-1], points[-2]
        if p1[0] == p2[0] or p1[1] == p2[1]:
            preliminary = _increment_lambda_modifier(adj, target, points[-1])
        else:
            preliminary = _polate_lambda_modifier(target, p1, p2)

    previous = points[-1][0]
    intermediate = math.log(1.0 + abs(preliminary - previous) / previous)
    if preliminary - previous < 0.0:
        preliminary = previous * (1.0 - intermediate)
    else:
        preliminary = previous * (1.0 + intermediate)

    while True:
        result = previous + inter_dampening * (preliminary - previous)
        inter_dampening /= 2.0
        if result > 0.0:
            return result


def guess_lambda_modifiers(adj: float, targets: Sequence[float],
                           metalog) -> List[float]:
    """guessLambdaModifiers (vector form, GuessLambdaModifiers.cpp:166):
    metalog is a list of (lambda_modifiers, bitrates) tuples."""
    cumulative_delta = 0.0
    result = []
    for i, target in enumerate(targets):
        points = [(e[0][i], e[1][i]) for e in metalog[-2:]]
        damp = 1.0 / (50.0 * cumulative_delta + 1.0)
        new_lm = guess_lambda_modifier(adj, target, points, damp)
        result.append(new_lm)
        old_lm = points[-1][0]
        cumulative_delta += abs(new_lm - old_lm) / old_lm
    return result


def parse_metalog(stream) -> List[Tuple[List[float], List[float]]]:
    """Parse '-LM0 x -LM1 y ...;r0 r1 ...' lines."""
    entries = []
    for line in stream:
        line = line.strip()
        if not line:
            continue
        lm_part, _, rate_part = line.partition(";")
        lms = []
        for m in re.finditer(r"-LM(\d+)\s+([0-9.eE+-]+)", lm_part):
            lms.append((int(m.group(1)), float(m.group(2))))
        lms.sort()
        rates = [float(x) for x in rate_part.split()]
        if len(lms) != len(rates):
            raise ValueError("mismatched indexes in meta-log")
        entries.append(([v for _, v in lms], rates))
    if not entries:
        raise ValueError("empty meta-log")
    n = len(entries[0][0])
    if any(len(e[0]) != n or len(e[1]) != n for e in entries):
        raise ValueError("mismatched indexes in meta-log")
    return entries


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: bitrate_targeting extract|guess ...", file=sys.stderr)
        return 1
    if argv[0] == "extract":
        rates = extract_bitrates_for_temporal_layers(sys.stdin)
        print(" ".join(f"{r:.6e}".replace("e+0", "e").replace("e+", "e")
                       .replace("e0", "e") for r in rates))
        return 0
    if argv[0] == "guess":
        if len(argv) != 3:
            print("usage: bitrate_targeting guess <adj> \"R0 R1 ...\"",
                  file=sys.stderr)
            return 1
        adj = float(argv[1])
        targets = [float(x) for x in argv[2].split()]
        metalog = parse_metalog(sys.stdin)
        if len(metalog[0][0]) != len(targets):
            raise ValueError("mismatched indexes vs targets")
        result = guess_lambda_modifiers(adj, targets, metalog)
        print(" ".join(f"-LM{i} {v:.7f}" for i, v in enumerate(result)))
        return 0
    print(f"unknown subcommand {argv[0]}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
