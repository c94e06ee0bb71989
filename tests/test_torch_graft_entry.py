"""The port's graft entry (``thevc_tpu_torch.graft_entry``) against the
JAX package, on the CPU.

- ``entry("cpu")`` draws the inputs of ``__graft_entry__.entry`` and its
  step equals ``thevc_tpu.ops.jx.tu_recon_pipeline`` on them
  (tolerance 0).
- ``python -m thevc_tpu_torch.graft_entry --slots 8 --backend gloo
  --device cpu`` runs the entry and the 8-slot dry run (8 spawned
  processes, a gloo group): 16 pictures digest-OK, the frame-sharded
  decode covering both frames, the steering check holding, the QP history
  equal to the JAX ``MeshRatePool.frame_qps`` fed with the spends it
  reports, the clips, budget and base QPs of ``__graft_entry__.py``, and
  no slot with ``jax`` or the JAX package loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from thevc_tpu_torch import graft_entry

REPO = Path(__file__).resolve().parents[1]
SLOTS = 8


def _reference_inputs():
    """The arrays of ``__graft_entry__.py:33-37``."""
    rng = np.random.RandomState(0)
    pred = rng.randint(0, 255, (256, 8, 8))
    qcoeff = rng.randint(-50, 50, (256, 8, 8))
    return pred, qcoeff, np.full((256,), 32)


def _reference_clips(n_devices):
    """The clips of ``__graft_entry__.py:133-147``."""
    w = h = 48
    n_frames = 2
    rng = np.random.RandomState(7)
    clips = []
    for i in range(n_devices):
        yy, xx = np.mgrid[0:h, 0:w]
        planes = []
        for k in range(n_frames):
            y = ((xx * (3 + i) + yy * (2 + k)
                  + rng.randint(0, 25 + 60 * i, (h, w)))
                 % 220 + 16).astype(np.uint8)
            cb = np.full((h // 2, w // 2), 120 + i, np.uint8)
            cr = np.full((h // 2, w // 2), 124 - i, np.uint8)
            planes.append(y.tobytes() + cb.tobytes() + cr.tobytes())
        clips.append(b"".join(planes))
    return clips


def test_entry_cpu_equals_jx_tu_recon_pipeline():
    import jax.numpy as jnp
    from thevc_tpu.ops import jx

    step, args = graft_entry.entry("cpu")
    pred, qcoeff, qp = _reference_inputs()
    for got, want in zip(args, (pred, qcoeff, qp)):
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    out = step(*args)
    ref = jx.tu_recon_pipeline(jnp.asarray(pred, jnp.int32),
                               jnp.asarray(qcoeff, jnp.int32),
                               jnp.asarray(qp, jnp.int32), use_dst=False,
                               bit_increment=0, max_val=255)
    assert out.shape == (256, 8, 8) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_clips_budget_and_base_qps_are_the_references():
    assert graft_entry.make_clips(SLOTS) == _reference_clips(SLOTS)
    assert (graft_entry.CLIP_W, graft_entry.CLIP_H,
            graft_entry.N_FRAMES) == (48, 48, 2)
    assert graft_entry.BITS_PER_SLOT_FRAME == 12000
    assert [graft_entry.base_qp(i) for i in range(SLOTS)] == \
        [26 + i % 4 for i in range(SLOTS)]


@pytest.fixture(scope="module")
def cli_run():
    r = subprocess.run([sys.executable, "-m", "thevc_tpu_torch.graft_entry",
                        "--slots", str(SLOTS), "--backend", "gloo",
                        "--device", "cpu"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = r.stdout.splitlines()
    report = [ln for ln in lines if ln.startswith("dryrun_multichip report ")]
    assert len(report) == 1, r.stdout[-2000:]
    return lines, json.loads(report[0].split(" ", 2)[2])


def test_cli_prints_entry_and_dryrun_ok(cli_run):
    lines, report = cli_run
    assert "entry ok: (256, 8, 8) torch.int32" in lines
    assert lines[-1] == f"dryrun_multichip({SLOTS}) ok"
    assert report["slots"] == report["processes"] == SLOTS
    assert report["backend"] == "gloo"
    assert report["devices"] == ["cpu"] * SLOTS


def test_dryrun_decodes_every_picture_and_shards_both_frames(cli_run):
    _lines, report = cli_run
    assert report["pictures"] == report["digests_ok"] == 2 * SLOTS
    assert report["sharded_decoded"] == 2
    shares = [s["sharded_decoded"] for s in report["slot_reports"]]
    assert shares == [1, 1] + [0] * (SLOTS - 2)


def test_dryrun_qps_equal_the_jax_mesh_pool(cli_run):
    import jax
    from jax.sharding import Mesh
    from thevc_tpu.parallel.shared_rc import MeshRatePool

    _lines, report = cli_run
    base = np.array([26 + i % 4 for i in range(SLOTS)], np.int32)
    qps, spent = report["qp_history"], report["spent_history"]
    assert qps[0] == base.tolist()
    mesh = Mesh(np.array(jax.devices("cpu")[:SLOTS]), ("stream",))
    pool = MeshRatePool(mesh, total_bits=SLOTS * 2 * 12000, n_frames=2)
    want = pool.frame_qps(base, np.asarray(spent[0], np.int32), 1)
    assert qps[1] == want.tolist()
    # each slot's spend grows with each frame it encodes
    assert all(0 < a < b for a, b in zip(spent[0], spent[1]))


def test_dryrun_steering_check_holds(cli_run):
    _lines, report = cli_run
    spent_f0 = np.asarray(report["spent_history"][0], np.float64)
    # __graft_entry__.py:190-198: pools that see only their own slot
    local = []
    for i, s in enumerate(spent_f0):
        target = max(0.0, 2 * 12000 - s)
        ratio = s / max(1.0, target)
        d = 2 if ratio > 1.25 else 1 if ratio > 1.05 else \
            -2 if ratio < 0.8 else -1 if ratio < 0.95 else 0
        local.append(min(51, max(0, 26 + i % 4 + d)))
    assert report["local_qps"] == local
    assert report["qp_history"][1] != local
    for s in report["slot_reports"]:
        assert s["mesh_qps"] == report["qp_history"][1]
        assert len(s["allreduce_ms"]) == graft_entry.ALLREDUCE_ITERS
        assert s["allreduce_total"] == sum(report["spent_history"][1])


def test_no_slot_loads_jax_or_the_jax_package(cli_run):
    _lines, report = cli_run
    assert [s["foreign_modules"] for s in report["slot_reports"]] == \
        [[]] * SLOTS
