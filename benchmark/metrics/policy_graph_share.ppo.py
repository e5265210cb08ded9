"""Share of the policy's calls (the program's span ``policy``,
``PPOTrainer.get_action_and_value``) that replayed its CUDA graph (the span
``policy_graph`` inside it) over the window, in %: 100 x the calls of the
span paths ending in ``policy_graph`` over those ending in ``policy``.  None
where the run has no ``policy`` span; 0 for a program whose policy has no
graph."""


def calls(spans: dict, name: str) -> int:
    return sum(v[0] for p, v in spans.items() if p.rsplit("/", 1)[-1] == name)


def read(run):
    spans = run.get("program_spans", {})
    policy = calls(spans, "policy")
    if not policy:
        return None
    return 100.0 * calls(spans, "policy_graph") / policy
