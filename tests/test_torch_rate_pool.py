"""The port's rate pool (``thevc_tpu_torch.parallel.shared_rc``) against
the JAX package's ``MeshRatePool``, and the layouts the dry run refuses.

Each of n gloo ranks (child processes on the CPU, a ``file://``
rendezvous) evaluates ``global_spent``, ``frame_targets`` and
``frame_qp`` for its own slot over seeded spend arrays; gathered, they
must equal the JAX pool's on an n-device CPU mesh, for n = 2, 4 and 8
(tolerance 0).  The cases cover every QP step of the rule (+-2, +-1,
0), the clip to 0..51, an exhausted pool and the last frame.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from thevc_tpu_torch import graft_entry

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = (2, 5)

_RANK = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from thevc_tpu_torch.parallel.shared_rc import MeshRatePool
    rank, n, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(f"{work}/cases.json") as fh:
        cases = json.load(fh)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            world_size=n, rank=rank)
    out = []
    for c in cases:
        pool = MeshRatePool(c["total_bits"], c["n_frames"])
        s, k = c["spent"][rank], c["frames_done"]
        out.append([pool.global_spent(s), pool.frame_targets(s, k),
                    pool.frame_qp(c["qps"][rank], s, k)])
    dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules if m == "jax"
                    or m.startswith("jax.") or m.startswith("thevc_tpu."))
    with open(f"{work}/rank{rank}.json", "w") as fh:
        json.dump({"out": out, "loaded": loaded}, fh)
""")


def _cases(n: int) -> list:
    rng = np.random.RandomState(100 + n)
    cases = []
    for n_frames in N_FRAMES:
        for frames_done in range(1, n_frames + 1):
            for budget in (12000, 12000, 12000, 60):   # 60: exhausted
                per = budget * frames_done
                # spends about each QP step's ratio to the even share
                ratio = rng.choice([0.4, 0.88, 1.0, 1.15, 1.8], n) \
                    * rng.uniform(0.97, 1.03, n)
                spent = (per * ratio).astype(np.int64)
                qps = rng.randint(0, 52, n)
                if len(cases) % 3 == 0:    # QPs at the ends of the clip
                    qps[0], qps[-1] = 0, 51
                cases.append({"total_bits": n * n_frames * budget,
                              "n_frames": n_frames,
                              "frames_done": frames_done,
                              "spent": spent.tolist(),
                              "qps": qps.tolist()})
    return cases


def _port(n: int, cases: list, work: Path) -> tuple:
    (work / "cases.json").write_text(json.dumps(cases))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(n),
                               str(work)], cwd=REPO, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    errs = []
    for p in procs:
        errs.append(p.communicate(timeout=300)[1])
    assert all(p.returncode == 0 for p in procs), errs
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(n)]
    return [r["out"] for r in ranks], [r["loaded"] for r in ranks]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_port_pool_equals_jax_mesh_pool(n, tmp_path):
    import jax
    from jax.sharding import Mesh
    from thevc_tpu.parallel.shared_rc import MeshRatePool

    cases = _cases(n)
    per_rank, loaded = _port(n, cases, tmp_path)
    assert loaded == [[]] * n
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("stream",))
    steps = set()
    for i, c in enumerate(cases):
        ref = MeshRatePool(mesh, c["total_bits"], c["n_frames"])
        spent = np.asarray(c["spent"], np.int32)
        k = c["frames_done"]
        got_total = [r[i][0] for r in per_rank]
        got_targets = np.array([r[i][1] for r in per_rank])
        got_qps = np.array([r[i][2] for r in per_rank])
        assert got_total == [ref.global_spent(spent)] * n
        np.testing.assert_array_equal(got_targets,
                                      ref.frame_targets(spent, k))
        want = ref.frame_qps(np.asarray(c["qps"], np.int32), spent, k)
        np.testing.assert_array_equal(got_qps, want)
        steps.update((want - np.asarray(c["qps"])).tolist())
    assert {-2, -1, 0, 1, 2} <= steps, steps


def test_nccl_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found 0"):
        graft_entry.check_layout(2, "nccl", ["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="--backend gloo"):
        graft_entry.main(["--slots", "8", "--device", "cpu"])


def test_nccl_with_fewer_cards_than_slots_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 8 CUDA cards.*found 1"):
        graft_entry.check_layout(8, "nccl",
                                 [f"cuda:{i}" for i in range(8)])


def test_nccl_with_slots_sharing_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="distinct"):
        graft_entry.check_layout(8, "nccl", ["cuda:0"] * 8)
    with pytest.raises(ValueError, match="distinct"):
        graft_entry.check_layout(2, "nccl", ["cpu", "cuda:1"])


def test_one_slot_raises():
    with pytest.raises(ValueError, match="at least 2 slots"):
        graft_entry.dryrun_multichip(1, "gloo", ["cpu"])
    with pytest.raises(ValueError, match="at least 2 slots"):
        graft_entry.main(["--slots", "1", "--backend", "gloo",
                          "--device", "cpu"])


def test_gloo_with_a_cuda_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.check_layout(2, "gloo", ["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry("cuda")


def test_unknown_backend_and_device_count_mismatch_raise():
    with pytest.raises(ValueError, match="unsupported backend"):
        graft_entry.check_layout(2, "mpi", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 devices for 2 slots"):
        graft_entry.check_layout(2, "gloo", ["cpu"] * 3)
