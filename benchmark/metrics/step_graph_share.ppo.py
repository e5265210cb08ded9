"""Share of the rollout's steps whose env half (``stateless_step``, the
episode statistics, ``conditional_reset`` and the storage row) replayed the
trainer's step graph (the program's span ``step_graph``) over the window,
in %: 100 x the calls of the span paths ending in ``step_graph`` over those
ending in ``policy``, which the trainer calls once a rollout step.  None
where the run has no ``policy`` span; 0 for a program whose env half has no
graph."""


def calls(spans: dict, name: str) -> int:
    return sum(v[0] for p, v in spans.items() if p.rsplit("/", 1)[-1] == name)


def read(run):
    spans = run.get("program_spans", {})
    policy = calls(spans, "policy")
    if not policy:
        return None
    return 100.0 * calls(spans, "step_graph") / policy
