"""Host ms an iteration in the program's span ``policy``
(``PPOTrainer.get_action_and_value``, once a rollout step) over the window:
its calls' total time, under whatever spans enclose it."""


def read(run):
    paths = [v for p, v in run.get("program_spans", {}).items()
             if p.rsplit("/", 1)[-1] == "policy"]
    if not paths or not run["steps"]:
        return None
    return sum(total for _, total, _ in paths) * 1e-6 / run["steps"]
