"""ray_tpu_torch.rl — reinforcement learning in PyTorch: the port of
``ray_tpu/rl`` (the RLlib equivalent).

Modules are pure functions of parameter trees (dicts of tensors with the
JAX package's keys and layouts), learners update them with optax's own
``clip_by_global_norm`` + ``adam`` (``ray_tpu_torch.optim``), and every
algorithm runs in one process on ``config.resources(device=...)`` (None:
the card).  Remote env runners, learner actors and IMPALA's async pipeline
raise ``NotImplementedError`` (ROADMAP Queue 1 item 6), and so do the
parquet and ``Dataset`` inputs of offline RL (item 3(c)).

Quick start::

    from ray_tpu_torch.rl import PPOConfig
    algo = (PPOConfig()
            .environment("CartPole-v1")
            .training(lr=3e-4)
            .build_algo())
    for _ in range(10):
        print(algo.train()["env_runners"]["episode_return_mean"])
"""

from .algorithm import Algorithm, AlgorithmConfig
from .connectors import (ClipActions, Connector, ConnectorPipeline,
                         ObsFlatten, RewardClip,
                         FrameStack, LambdaConnector, MeanStdFilter)
from .dqn import DQN, DQNConfig
from .env import (CartPole, Env, Pendulum, StatelessGuess, TargetReach,
                  VectorEnv, make_env, register_env)
from .env_runner import EnvRunner, EnvRunnerGroup
from .impala import (APPO, APPOConfig, IMPALA, IMPALAConfig,
                     vtrace)
from .torch_env import TorchCartPoleVector
from .learner import LearnerGroup, TorchLearner
from .models import (CNNPolicyModule, CNNPolicySpec, GRUPolicyModule,
                     RecurrentPolicySpec)
from .multi_agent import (MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO,
                          MultiAgentPPOConfig, MultiGuess)
from .iql import IQL, IQLConfig
from .offline import (BC, BCConfig, CQL, CQLConfig, MARWIL, MARWILConfig,
                      OfflineData, collect_from_env, save_parquet,
                      save_shard)
from .ppo import PPO, PPOConfig, compute_gae
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from .rl_module import (ContinuousModuleSpec, DiscretePolicyModule,
                        GaussianPolicyModule, QModule, RLModuleSpec,
                        TwinQModule)
from .sac import SAC, SACConfig
from .tqc import TQC, TQCConfig

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "DQN", "DQNConfig",
    "SAC", "SACConfig", "IMPALA", "IMPALAConfig", "vtrace",
    "APPO", "APPOConfig",
    "BC", "BCConfig", "MARWIL", "MARWILConfig", "CQL", "CQLConfig",
    "IQL", "IQLConfig", "TQC", "TQCConfig",
    "OfflineData", "collect_from_env", "save_shard", "save_parquet",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "MultiAgentPPOConfig", "MultiGuess",
    "Connector", "ConnectorPipeline", "MeanStdFilter", "FrameStack",
    "LambdaConnector", "ClipActions", "RewardClip", "ObsFlatten",
    "Env", "CartPole", "StatelessGuess", "Pendulum", "TargetReach",
    "VectorEnv", "TorchCartPoleVector", "make_env",
    "CNNPolicyModule", "CNNPolicySpec", "GRUPolicyModule",
    "RecurrentPolicySpec",
    "register_env", "EnvRunner", "EnvRunnerGroup", "TorchLearner",
    "LearnerGroup", "ReplayBuffer", "PrioritizedReplayBuffer",
    "DiscretePolicyModule", "GaussianPolicyModule", "TwinQModule",
    "ContinuousModuleSpec", "QModule", "RLModuleSpec", "compute_gae",
]
