"""Training argument dataclasses: a copy of ``gymca_tpu/agents/args.py``, the
same fields, defaults and derived sizes (the port imports nothing of the JAX
package)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class PPOArgs:
    """PPO algorithm arguments (reference args.py:4-21)."""

    learning_rate: float = 2.5e-4
    anneal_lr: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    num_minibatches: int = 4
    update_epochs: int = 4
    norm_adv: bool = True
    clip_coef: float = 0.1
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    target_kl: Optional[float] = None
    # --- potential-based reward shaping (policy-invariant; Ng et al. 1999).
    # Both default 0.0 = off (reference parity).  Used for long-horizon
    # credit assignment at >=128^2 under modf CA semantics, where the useful
    # behavior (walk hundreds of cells to the fire, then douse the front) is
    # too many undiscounted steps from a random init (docs/learning_at_scale.md).
    # shape_tree_coef: phi += coef * trees_remaining_fraction  (dense signal
    #   for slowing fire loss); shape_dist_coef: phi -= coef *
    #   dist(agent, fire centroid)/diag  (dense signal for approach).
    shape_tree_coef: float = 0.0
    shape_dist_coef: float = 0.0
    # shape_douse_coef: phi += coef * |{doused cells with live fire inside
    #   their 5x5 suppression box}| / 100 — the dousing-side signal that the
    #   dist term alone lacks (dist shaping creates an "approach valley":
    #   policies learn to chase the fire centroid but score below random
    #   until they also douse; docs/learning_at_scale.md §5).  Still
    #   potential-based (a pure function of state), hence policy-invariant.
    shape_douse_coef: float = 0.0
    # --- kickstarting (Schmitt et al. 2018 style).  After a BC warm-start
    # (ExperimentArgs.bc_iters), naive PPO destroys the clone: the fresh
    # critic's advantages are noise and the entropy bonus pulls the heads
    # back to uniform (measured: eval -694 BC-only -> -1727 BC+PPO,
    # docs/learning_at_scale.md §5).  kickstart_coef adds an auxiliary
    # cross-entropy toward the greedy-fire demonstrator on the move/shoot
    # heads, annealed linearly to 0 over kickstart_decay_iters PPO
    # iterations (0 = decay across the whole run).  0.0 = off.
    kickstart_coef: float = 0.0
    kickstart_decay_iters: int = 0


@dataclass
class EnvArgs:
    """Environment configuration (reference args.py:23-34)."""

    env_id: str = "AdvancedBulldozer"
    num_envs: int = 8
    size: int = 256
    speed_move: float = 0.12
    speed_multiplier: float = 1.0
    use_hidden: bool = True
    enable_extensions: bool = False
    # CA time semantics: "single" = reference-JAX parity (one CA application
    # per agent step, repeat_ca_jax.py:61-69); "modf" = the classic
    # time-gated semantics (repeat_ca.py:40-43) under which the agent/fire
    # speed ratio is physical and large grids are controllable
    # (docs/learning_at_scale.md §2-3).
    ca_repeat_mode: str = "single"


@dataclass
class VisualizationArgs:
    """Recording arguments (reference args.py:36-45)."""

    gif: bool = False
    steps: int = 40
    duration: float = 80
    recording_times: int = 8
    frames_per_recording: int = 8


@dataclass
class ExperimentArgs:
    """Experiment setup (reference args.py:47-65)."""

    exp_name: str = "ppo"
    seed: int = 1
    track: bool = False
    device: int = 0
    profile: bool = False
    total_timesteps: int = 10_000_000
    num_ppo_steps: int = 128
    no_train: bool = False
    params_path: Optional[str] = None
    description: str = ""
    conv_count: int = 3
    maxpool_count: int = 2
    # Run the CNN torso in bfloat16 (params stay f32).  ~MXU-rate speedup on
    # the conv-heavy update at 256^2 obs; off by default for float32 parity
    # with the reference curves.
    bf16_compute: bool = False
    # Concatenate the agent's normalized (row/H, col/W) position to the CNN
    # hidden vector before the actor/critic MLPs.  The agent is a single
    # black pixel in the RGB obs; at >=128^2 the torso plausibly cannot
    # localize it.  Off by default (reference-parity model).
    position_features: bool = False
    # Also feed the agent->fire-centroid offset (+ fire-present flag),
    # computed from the TRUE grid.  This is a state feature, not a pixel
    # feature — used to isolate whether a learning failure is perception
    # (CNN can't localize small fires in blurred day obs) vs control.
    centroid_features: bool = False
    # Behavior-cloning warm-start iterations from the greedy-fire
    # demonstrator before PPO (PPOTrainer.bc_pretrain); 0 = off.
    bc_iters: int = 0
    # PPO iterations at the start of training during which ONLY the critic
    # head receives gradients (network torso + actor frozen).  Pairs with
    # bc_iters: the cloned policy collects on-policy rollouts while the
    # critic learns its value function, so PPO's first real advantages are
    # signal rather than fresh-critic noise.  0 = off.
    critic_warmup_iters: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: Optional[str] = None
    log_dir: Optional[str] = None


@dataclass
class Args:
    """Main container with derived batch sizes (reference args.py:67-85)."""

    ppo: PPOArgs = field(default_factory=PPOArgs)
    env: EnvArgs = field(default_factory=EnvArgs)
    viz: VisualizationArgs = field(default_factory=VisualizationArgs)
    exp: ExperimentArgs = field(default_factory=ExperimentArgs)

    batch_size: int = 0
    minibatch_size: int = 0
    num_iterations: int = 0

    def __post_init__(self):
        self.batch_size = self.env.num_envs * self.exp.num_ppo_steps
        self.minibatch_size = self.batch_size // self.ppo.num_minibatches
        self.num_iterations = self.exp.total_timesteps // max(self.batch_size, 1)
