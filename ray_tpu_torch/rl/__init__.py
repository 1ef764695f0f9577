"""RL library (reference: rllib/) — the port of ``ray_tpu/rl`` on the
port's runtime actors, in PyTorch.

New-API-stack shape mirrors the reference: RLModule (network), Learner /
LearnerGroup (updates), EnvRunner / EnvRunnerGroup (sampling), Algorithm
(the loop, also a Tune trainable).  Device-native twist: the ``jax_env``
environments are vectorized over device tensors, so a whole rollout is a
loop of device work with no host round-trip (see env/jax_env.py); the
Podracer (Anakin, Sebulba) builds on it.  Entry points run on the card
unless the caller asks for the CPU.

DQN, SAC, CQL, MARWIL/BC and DreamerV3 learn from the replay buffer
(``utils/replay_buffer.py``) or from logged experience (``offline/``, over
the port's Data).
"""

from .algorithms.algorithm import Algorithm, AlgorithmConfig
from .algorithms.appo import APPO, APPOConfig
from .algorithms.cql import CQL, CQLConfig
from .algorithms.dqn import DQN, DQNConfig
from .algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from .algorithms.impala import (IMPALA, Impala, ImpalaConfig,
                                make_impala_learner)
from .algorithms.marwil import BC, BCConfig, MARWIL, MARWILConfig
from .algorithms.ppo import PPO, PPOConfig
from .algorithms.sac import SAC, SACConfig
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
from .utils.replay_buffer import ReplayBuffer
from . import connectors
from .offline import OfflineData, record_rollouts

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "DQN", "DQNConfig",
    "Impala", "IMPALA", "ImpalaConfig", "SAC", "SACConfig",
    "MARWIL", "MARWILConfig", "BC", "BCConfig",
    "APPO", "APPOConfig", "CQL", "CQLConfig",
    "DreamerV3", "DreamerV3Config",
    "Learner", "LearnerGroup", "RLModule", "DiscretePolicyModule", "QModule",
    "module_for_env", "EnvRunnerGroup", "JaxEnvRunner", "GymEnvRunner",
    "JaxEnv", "CartPole", "make_env", "register_env", "ReplayBuffer",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiRLModule",
    "CooperativeMatchEnv", "register_multi_agent_env",
    "connectors", "OfflineData", "record_rollouts",
    "AnakinConfig", "ChaosEvent", "ChaosSchedule", "Sebulba",
    "SebulbaConfig", "make_impala_learner", "run_anakin", "run_sebulba",
]
