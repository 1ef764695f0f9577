"""RL library (reference: rllib/) — the port of ``ray_tpu/rl`` on the
port's runtime actors, in PyTorch.

New-API-stack shape mirrors the reference: RLModule (network), Learner /
LearnerGroup (updates), EnvRunner / EnvRunnerGroup (sampling), Algorithm
(the loop, also a Tune trainable).  Device-native twist: the ``jax_env``
environments are vectorized over device tensors, so a whole rollout is a
loop of device work with no host round-trip (see env/jax_env.py); the
Podracer (Anakin, Sebulba) builds on it.  Entry points run on the card
unless the caller asks for the CPU.

This package holds the on-policy half of the reference's RL library
(ROADMAP A.8a).  The value-based, offline and model-based algorithms,
the replay buffer and offline data (DQN, SAC, CQL, MARWIL/BC, DreamerV3,
``ReplayBuffer``, ``OfflineData``, ``record_rollouts``) are ROADMAP
A.8b: importing one of them raises ``ImportError``.
"""

from .algorithms.algorithm import Algorithm, AlgorithmConfig
from .algorithms.appo import APPO, APPOConfig
from .algorithms.impala import (IMPALA, Impala, ImpalaConfig,
                                make_impala_learner)
from .algorithms.ppo import PPO, PPOConfig
from .core.learner import Learner, LearnerGroup
from .core.rl_module import (DiscretePolicyModule, QModule, RLModule,
                             module_for_env)
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
from .core.multi_rl_module import MultiRLModule
from .env.env_runner import EnvRunnerGroup, GymEnvRunner, JaxEnvRunner
from .env.jax_env import CartPole, JaxEnv, make_env, register_env
from .env.multi_agent_env import (CooperativeMatchEnv, MultiAgentEnv,
                                  MultiAgentEnvRunner,
                                  MultiAgentEnvRunnerGroup)
from .env.multi_agent_env import register_env as register_multi_agent_env
from .podracer import (AnakinConfig, ChaosEvent, ChaosSchedule, Sebulba,
                       SebulbaConfig, run_anakin, run_sebulba)
from . import connectors

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig",
    "Impala", "IMPALA", "ImpalaConfig",
    "APPO", "APPOConfig",
    "Learner", "LearnerGroup", "RLModule", "DiscretePolicyModule", "QModule",
    "module_for_env", "EnvRunnerGroup", "JaxEnvRunner", "GymEnvRunner",
    "JaxEnv", "CartPole", "make_env", "register_env",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiRLModule",
    "CooperativeMatchEnv", "register_multi_agent_env",
    "connectors",
    "AnakinConfig", "ChaosEvent", "ChaosSchedule", "Sebulba",
    "SebulbaConfig", "make_impala_learner", "run_anakin", "run_sebulba",
]

#: the reference's exports that are ROADMAP A.8b, not ported yet
NOT_PORTED = ("DQN", "DQNConfig", "SAC", "SACConfig", "CQL", "CQLConfig",
              "MARWIL", "MARWILConfig", "BC", "BCConfig", "DreamerV3",
              "DreamerV3Config", "ReplayBuffer", "OfflineData",
              "record_rollouts")


def __getattr__(name):
    if name in NOT_PORTED:
        raise ImportError(
            f"ray_tpu_torch.rl.{name} is not ported yet: DQN, SAC, CQL, "
            f"MARWIL/BC, DreamerV3, the replay buffer and offline data are "
            f"ROADMAP A.8b")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
