"""``step_graph_share.ppo``'s reader on synthetic program spans:
``{path: (calls, total_ns, child_ns)}`` as ``gymca_torch.utils.metrics.
snapshot`` gives them."""

from pathlib import Path

import pytest

from benchmark import run as bench_run

ROOT = Path(__file__).resolve().parents[2]
read = bench_run.Spec(ROOT).module("metrics", "step_graph_share.ppo").read


@pytest.mark.parametrize("spans,share", [
    ({}, None),
    ({"rollout": (1, 9, 8), "rollout/step_graph": (128, 5, 0)}, None),
    ({"rollout": (2, 9, 8), "rollout/policy": (256, 8, 4),
      "rollout/policy/policy_graph": (256, 4, 0), "rollout/stateless_step": (256, 5, 0),
      "rollout/conditional_reset": (256, 5, 0)}, 0.0),
    ({"rollout": (2, 9, 8), "rollout/policy": (256, 8, 4),
      "rollout/policy/policy_graph": (256, 4, 0), "rollout/step_graph": (256, 4, 0)}, 100.0),
    ({"rollout/policy": (128, 8, 4), "rollout/step_graph": (96, 4, 0),
      "rollout/stateless_step": (32, 2, 0)}, 75.0),
])
def test_the_share_of_rollout_steps_that_replayed_the_step_graph(spans, share):
    assert read({"program_spans": spans, "steps": 2}) == share


def test_a_run_without_program_spans_reads_nothing():
    assert read({"steps": 2}) is None
