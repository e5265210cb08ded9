"""``tests/multihost_worker.py``'s checks on the port: a world of 4 gloo
ranks as 2 "hosts" of 2 ranks (``LOCAL_WORLD_SIZE=2``), spawned as separate
processes (``tests/torch_parallel_ranks.py``); ``python3 -m
gymca_torch.bench_scaling --smoke --device-cpu`` and ``python3 -m
gymca_torch.bench --smoke --device-cpu`` under ``torchrun`` with 2 ranks;
and ``tests/torch_multicard.py --device-cpu`` with 4.  Every value compared here is exact: integer counts, small-integer
sums, and reward sums of the same float32 rewards.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_parallel_ranks import run_world

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [("multihost", "multihost", {}),
             ("uneven", "uneven_hosts", {"local_world_size": 3}),
             ("backend", "backend_checks", {})]
    return run_world(4, cases, tmp_path_factory.mktemp("multihost"),
                     env={"LOCAL_WORLD_SIZE": "2"})


def test_host_device_mesh_and_a_sum_over_both_axes(ranks):
    """The mesh is {host: 2, device: 2}; the sum of the ranks 0..3 over both
    axes is 6 on every rank."""
    for r in ranks:
        assert r["multihost"]["mesh"] == {"host": 2, "device": 2}
        assert r["multihost"]["sum_hd"] == 6.0


def test_bulldozer_batch_over_ranks_equals_the_unsharded_step(ranks):
    """8 envs at 16² cut over the 4 ranks, stepped and reduced: the tree
    count equals the unsharded step's, the reward sum too (to float32
    reassociation), the same on every rank."""
    first = ranks[0]["multihost"]
    for r in ranks:
        m = r["multihost"]
        reward, trees = m["expect"]
        assert m["tree_total"] == trees > 0
        assert abs(m["reward_sum"] - reward) < 1e-5
        assert m["reward_sum"] == first["reward_sum"]


def test_coordinator_is_rank_zero_alone(ranks):
    assert [r["multihost"]["coordinator"] for r in ranks] == [True, False, False, False]


def test_uneven_hosts_raise_on_every_rank(ranks):
    for r in ranks:
        assert r["uneven"]["raised"] == "ValueError", r["uneven"]


def test_card_request_on_a_gloo_group_raises(ranks):
    """A card never runs on gloo: with a gloo group up, asking for the card
    raises on every rank, and asking for the CPU is a no-op."""
    for r in ranks:
        b = r["backend"]
        assert b["cpu"] is None
        assert b["cuda"]["raised"] == "RuntimeError", b
        assert "gloo process group exists" in b["cuda"]["message"], b


def test_bench_scaling_smoke_on_two_gloo_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "gymca_torch.bench_scaling", "--smoke", "--device-cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert [ln["devices"] for ln in lines[:-1]] == [1, 2]
    assert all(ln["steps_per_sec"] > 0 for ln in lines[:-1])
    assert lines[0]["efficiency"] == 1.0
    assert lines[-1]["metric"] == "bulldozer16_scaling_efficiency"


def test_bench_under_torchrun_prints_bench_pys_two_lines_from_rank_0():
    """``torchrun --nproc-per-node 2 -m gymca_torch.bench --smoke
    --device-cpu``: every rank exits 0, stdout holds exactly bench.py's two
    JSON lines (rank 0's alone), and stderr shows the 64 smoke envs sharded
    over both ranks, each rank's reps and rank 0's Advanced runs."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "gymca_torch.bench", "--smoke", "--device-cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={**os.environ, "GYMCA_BENCH_BASELINE_SPS": "1000"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert [ln["metric"] for ln in lines] == ["advanced64_env_steps_per_sec",
                                              "bulldozer64_env_steps_per_sec"], out.stdout
    for ln in lines:
        assert list(ln) == ["metric", "value", "unit", "vs_baseline"]
        assert ln["unit"] == "env-steps/s" and ln["value"] > 0
    assert lines[1]["vs_baseline"] == round(lines[1]["value"] / 1000, 2)
    err = out.stderr
    assert "[rank 0] [bench] sharding 64 envs over 2 ranks (32 a rank)" in err
    for r in (0, 1):
        assert f"[rank {r}] [bench] path=step_batched" in err
        assert err.count(f"[rank {r}] [bench] rep ") == 3
    assert "[rank 0] [bench] advanced rep 2" in err and "[rank 1] [bench] advanced" not in err


def test_multicard_check_on_four_gloo_ranks():
    """``tests/torch_multicard.py``, the check for a host of several cards,
    rehearsed on 4 gloo ranks at toy sizes: the windy and Bulldozer bands
    equal the whole grids, the (2, 2) mesh equals ``core.step``, the
    Advanced bands equal the CPU's, the PPO replicas agree,
    ``bench_scaling`` reports d = 1, 2 and 4, and the bench's windy batch
    sharded over the 4 ranks ends in the states of its run alone, K1 called
    ``(WARM + REPS) * steps`` times on each rank."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", str(ROOT / "tests" / "torch_multicard.py"), "--device-cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("MULTICARD ")]
    res = json.loads(lines[-1][len("MULTICARD "):])
    assert res["ok"] and res["world"] == 4 and res["bulldozer_batched_2x2_equal"], res
    assert [s["devices"] for s in res["scaling"]] == [1, 2, 4]
    assert res["bench_states_equal"] and res["bench_launches_exact_on_every_rank"], res
    b = res["bench"]
    assert (b["envs"], b["size"], b["steps"]) == (16, 48, 5)
    assert len(b["reps_ms_by_rank"]) == 4 and b["value"] > 0 and b["value_alone"] > 0
    assert b["reps_ms_slowest"] == [max(r[i] for r in b["reps_ms_by_rank"]) for i in range(3)]
    assert b["done_fraction"] == b["done_fraction_alone"]
