"""Algorithm: the top-level RL training loop object.

Analog of the reference's Algorithm (reference:
rllib/algorithms/algorithm.py — a Tune Trainable driving an
EnvRunnerGroup for sampling and a LearnerGroup for updates).  Here:

    config = PPOConfig().environment("CartPole-v1").env_runners(2)
    algo = config.build()
    for _ in range(n):
        result = algo.train()      # sample -> update -> sync weights

Tune integration mirrors the reference (Algorithm IS the trainable):
``config.to_trainable()`` returns a function trainable that reports each
train() result through ``ray_tpu_torch.train.session.report``.

The port of ``ray_tpu/rl/algorithms/algorithm.py``.  ``device`` (set with
``.resources(device=...)``) is where the learners and runners compute:
the card unless the caller asks for the CPU; remote runners and learners
on the card share it (``num_gpus = 1 / n`` each).  ``save`` writes the
learners' numpy state, so a checkpoint restores on any device.
"""

from __future__ import annotations

import copy
import pickle
import time
from typing import Any, Callable, Dict, Optional

from ..env.env_runner import EnvRunnerGroup, gpu_share


class AlgorithmConfig:
    """Fluent config (reference: algorithm_config.py)."""

    def __init__(self):
        self.env_name: Optional[str] = None
        self.num_env_runners = 0          # 0 = local sampling
        self.num_envs_per_runner = 8
        self.runner_kind = "jax"          # "jax" | "gym"
        self.num_learners = 0             # 0 = local learner
        self.rollout_len = 128            # steps per env per iteration
        #: zero-arg factories for connector pipelines (reference:
        #: AlgorithmConfig.env_runners(env_to_module_connector=...))
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        self.lr = 3e-4
        self.gamma = 0.99
        self.seed = 0
        self.hidden = (64, 64)
        self.train_batch_size = 1024
        #: where learners and runners compute (None: the card)
        self.device = None
        self.extra: Dict[str, Any] = {}

    # -- fluent setters (reference naming) ---------------------------------

    def environment(self, env: str):
        self.env_name = env
        return self

    def env_runners(self, num_env_runners: int = 0, *,
                    num_envs_per_runner: int = 8,
                    runner_kind: str = "jax",
                    env_to_module_connector=None,
                    module_to_env_connector=None):
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        self.runner_kind = runner_kind
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def learners(self, num_learners: int = 0):
        self.num_learners = num_learners
        return self

    def resources(self, device=None):
        """Where learners and runners compute (reference:
        AlgorithmConfig.resources); None is the card."""
        self.device = device
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def debugging(self, seed: int = 0):
        self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    # -- build -------------------------------------------------------------

    algo_cls: Optional[type] = None

    def build(self) -> "Algorithm":
        if self.env_name is None:
            raise ValueError("config.environment(...) not set")
        return self.algo_cls(self)

    def to_trainable(self) -> Callable:
        """Function trainable for Tune: config dict entries override
        attributes (so Tune param_space can sweep lr etc.)."""
        base = self.copy()

        def rl_trainable(tune_config: Dict[str, Any]):
            from ...train.session import report

            cfg = base.copy()
            stop_iters = int(tune_config.pop("training_iterations", 10))
            cfg.training(**tune_config)
            algo = cfg.build()
            try:
                for _ in range(stop_iters):
                    report(algo.train())
            finally:
                algo.stop()

        return rl_trainable


def merge_batches(batches) -> Dict[str, Any]:
    """Concat same-keyed [T, B, ...] batches along B ([B...] tails like
    final_vf along axis 0) — the one batch-merge rule for runner results
    in single- and multi-agent algorithms."""
    import numpy as np

    merged = {}
    for k in batches[0]:
        arrs = [b[k] for b in batches]
        axis = 1 if arrs[0].ndim >= 2 else 0
        merged[k] = np.concatenate(arrs, axis=axis) if len(arrs) > 1 \
            else arrs[0]
    return merged


class Algorithm:
    """Base training loop; subclasses implement training_step()."""

    #: module kind for the runner group ("policy" | "q")
    module_kind = "policy"

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        # connector factories (reference: env_to_module_connector config
        # arg): built once here, pickled per remote runner — so stateful
        # connectors (NormalizeObs) end up with independent state per
        # runner actor
        e2m = config.env_to_module_connector
        m2e = config.module_to_env_connector
        self.runners = EnvRunnerGroup(
            env_name=config.env_name,
            module_spec={"kind": self.module_kind, "hidden": config.hidden,
                         "kwargs": self._module_kwargs()},
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            runner_kind=config.runner_kind,
            seed=config.seed,
            explore_kwargs=self._explore_kwargs(),
            env_to_module=e2m() if e2m else None,
            module_to_env=m2e() if m2e else None,
            device=config.device,
        )
        self.env_spec = self.runners.env_spec()
        self._setup()
        self._last_stats: Dict[str, Any] = {}

    # -- overridables ------------------------------------------------------

    def _explore_kwargs(self) -> Dict[str, Any]:
        return {}

    def _module_kwargs(self) -> Dict[str, Any]:
        """Extra ctor kwargs for the runner-side module — must match the
        learner's module so synced weights apply (e.g. Dreamer latent
        sizes)."""
        return {}

    def _setup(self):
        raise NotImplementedError

    def _learner_device(self) -> str:
        """The device string a learner factory builds on (in a remote
        learner actor on the card, that actor's card)."""
        from ..._device import resolve_device

        return resolve_device(self.config.device).type \
            if self.config.num_learners else str(
                resolve_device(self.config.device))

    def _learner_options(self) -> Dict[str, Any]:
        from ..._device import resolve_device

        return gpu_share(resolve_device(self.config.device),
                         self.config.num_learners)

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public API (reference: Algorithm.train/save/restore/stop) ---------

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        metrics = self.training_step()
        self.iteration += 1
        metrics["training_iteration"] = self.iteration
        metrics["time_this_iter_s"] = time.monotonic() - t0
        return metrics

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump({"iteration": self.iteration,
                         "learner_state": self.learner_group.state()}, f)

    def restore(self, path: str):
        with open(path, "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        self.learner_group.load_state(state["learner_state"])
        self.runners.sync_weights(self.learner_group.get_weights())

    def stop(self):
        self.runners.stop()
        if hasattr(self, "learner_group"):
            self.learner_group.stop()

    # -- helpers -----------------------------------------------------------

    def _merge_runner_results(self, results) -> Dict[str, Any]:
        """Concat [T,B] batches along B; merge episode stats."""
        import numpy as np

        merged = merge_batches([r["batch"] for r in results])
        stats: Dict[str, Any] = {}
        rets = [r["stats"].get("episode_return_mean") for r in results
                if r["stats"].get("episodes_this_iter", 0) > 0]
        stats["episodes_this_iter"] = sum(
            r["stats"].get("episodes_this_iter", 0) for r in results)
        if rets:
            stats["episode_return_mean"] = float(np.mean(rets))
        stats["env_steps_sampled"] = sum(
            r["stats"].get("env_steps_sampled", 0) for r in results)
        return merged, stats
