"""The port's collective byte model (``bigdl_tpu_torch/analysis/commcost.py``)
against the reference's algebra and against the bytes the port's
``parallel.mesh.COLLECTIVES`` counts.

- ``OPS``, ``wire_bytes`` and ``hbm_bytes`` equal the reference's, and
  ``predict_mode`` equals the reference's on every term whose algebra the
  port shares (``"ref": "same"``), at seeded bindings.
- Every mode's payload bytes by ``op/axis`` equal the counted bytes of a
  world-2 run on the CPU (gloo; ``tests/torch_parallel_worker.py``'s
  ``comm`` job: the dp modes, tp with and without sequence-parallel
  regions, dp x ep and the expert axis, the ring, GPipe, StagePipeline) on
  both ranks. The stated tolerance is 0 (exact): the model and the counter
  price the same tensors. Each mode's control, its first term dropped,
  fails it.
- ``bigdl_tpu_torch/analysis/comm_model.json`` is pinned against drift
  (regenerate with ``python -m bigdl_tpu_torch.analysis --comm-model
  bigdl_tpu_torch/analysis/comm_model.json``).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from bigdl_tpu.analysis import commcost as ref
from bigdl_tpu_torch.analysis import commcost as port

REPO = Path(__file__).resolve().parents[1]
RUNS = ("allreduce", "sharded", "fsdp", "tp", "tp_sp", "ep_data",
        "ep_expert", "cp_ring", "gpipe", "stage")
MODE_RTOL = 0.0


def test_op_algebra_equals_the_reference():
    assert port.OPS == ref.OPS
    rng = np.random.default_rng(23)
    for op in port.OPS:
        for _ in range(5):
            b = float(rng.integers(1, 1 << 30))
            s = int(rng.integers(2, 64))
            assert port.wire_bytes(op, b, s) == ref.wire_bytes(op, b, s)
            assert port.hbm_bytes(op, b, s) == ref.hbm_bytes(op, b, s)


def test_shared_terms_predict_as_the_reference():
    """Each port term marked ``"ref": "same"`` prices what the reference's
    term of the same mode, op and axis prices."""
    rng = np.random.default_rng(29)
    shared = 0
    for mode, terms in port.MODES.items():
        if mode not in ref.MODES:
            continue
        for _ in range(3):
            syms = {k: float(rng.integers(1, 1 << 20)) for k in (
                "P", "P_flat", "P_shd", "A", "T", "K", "M")}
            syms.update({f"S_{a}": int(rng.integers(2, 9)) for a in (
                "data", "tensor", "pipe", "seq", "expert")})
            syms.update(n_blk=int(rng.integers(1, 24)),
                        n_moe=int(rng.integers(1, 12)),
                        n_ring=int(rng.integers(1, 48)),
                        n_micro=int(rng.integers(1, 16)), k_ag=1.0,
                        k=2, E_x=8, M_send=4.0, M_recv=4.0)
            mine = port.predict_mode(mode, **syms)["terms"]
            theirs = ref.predict_mode(mode, **syms)["terms"]
            for t, spec in zip(mine, terms):
                if spec["ref"] != "same":
                    continue
                match = [r for r in theirs
                         if (r["op"], r["axis"]) == (t["op"], t["axis"])]
                assert match, (mode, t["op"], t["axis"])
                for key in ("payload_bytes", "wire_bytes", "hbm_bytes"):
                    assert t[key] == match[0][key], (mode, key)
                shared += 1
    assert shared >= 3 * 8


def test_every_mode_term_evaluates():
    syms = dict(S_data=8, S_tensor=4, S_pipe=4, S_seq=4, S_expert=4,
                P=1.0, P_flat=1.0, P_shd=1.0, A=1.0, n_blk=2, T=1.0,
                n_moe=2, K=1.0, n_ring=3, M=1.0, n_micro=8, k=2, E_x=8,
                M_send=1.0, M_recv=1.0)
    for mode in port.MODES:
        out = port.predict_mode(mode, **syms)
        assert out["payload_bytes"] > 0, mode
        assert out["hbm_bytes"] >= out["wire_bytes"] > 0, mode
        for t in port.MODES[mode]:
            assert t["ref"] in ("same", "port") and t["per"] in (
                "step", "run") and t["op"] in port.OPS


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """The worker's ``comm`` job at world 2 on the CPU: each run's
    snapshot and symbols, by rank."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_parallel_worker as worker
    out = tmp_path_factory.mktemp("comm")
    worker.wait(worker.spawn(str(out), 2, ["comm"]), str(out), timeout=300)
    return [json.loads((out / f"comm.{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("run", RUNS)
def test_mode_model_equals_the_counted_bytes(counted, run):
    for rank, runs in enumerate(counted):
        r = runs[run]
        got = port.counted_by_axis(r["snapshot"])
        res = port.compare(r["mode"], got, r["steps"], rtol=MODE_RTOL,
                           **r["symbols"])
        assert res["ok"], (rank, res["rows"])
        assert got, (rank, "the run counted no collective")
        # the control: the model with its first term dropped fails
        ctl = port.compare(r["mode"], got, r["steps"], rtol=MODE_RTOL,
                           drop=0, **r["symbols"])
        assert not ctl["ok"], (rank, ctl["rows"])


def test_counted_by_axis_folds_the_staged_shift():
    snap = {"bytes_by_axis": {"shift_staged/seq": 8, "shift/seq": 4,
                              "all_reduce/data": 16, "broadcast/world": 99,
                              "all_gather_object/world": 0}}
    assert port.counted_by_axis(snap) == {"shift/seq": 12.0,
                                          "all_reduce/data": 16.0}


def test_comm_model_drift_gate():
    pinned = json.loads((REPO / "bigdl_tpu_torch" / "analysis"
                         / "comm_model.json").read_text())
    built = json.loads(json.dumps(port.build_model(str(REPO))))
    assert pinned["version"] == built["version"]
    assert pinned["ops"] == built["ops"], \
        "op algebra drifted — regenerate comm_model.json"
    assert pinned["modes"] == built["modes"], \
        "mode models drifted — regenerate comm_model.json"
    assert pinned["sites"] == built["sites"], (
        "collective call sites drifted — regenerate comm_model.json "
        "(python -m bigdl_tpu_torch.analysis --comm-model "
        "bigdl_tpu_torch/analysis/comm_model.json)")


def test_site_scan_sees_the_data_plane():
    sites = port.scan_sites(str(REPO))
    files = {s["file"] for s in sites}
    assert "bigdl_tpu_torch/parallel/distri_optimizer.py" in files
    assert any(s["op"] == "all-reduce" and s["axis"] == "data"
               for s in sites)
    assert any(s["op"] == "region" and s["call"] == "copy_to_region"
               for s in sites)
    assert all(not s["file"].startswith("bigdl_tpu/") for s in sites)


def test_cli_writes_the_model(tmp_path):
    from bigdl_tpu_torch.analysis.__main__ import main
    path = tmp_path / "model.json"
    assert main(["--comm-model", str(path)]) == 0
    assert json.loads(path.read_text())["modes"] == port.MODES
    assert os.path.getsize(path) > 1000
