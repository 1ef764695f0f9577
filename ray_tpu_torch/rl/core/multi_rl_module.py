"""MultiRLModule: one RLModule per policy id.

The port of ``ray_tpu/rl/core/multi_rl_module.py`` (reference:
rllib/core/rl_module/multi_rl_module.py): a dict of policy_id ->
RLModule whose params tree is {policy_id: module_params}, so a
multi-policy checkpoint is still one tree save and each policy's
forward passes stay independent.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from .rl_module import DiscretePolicyModule, make_generator
from ..._device import resolve_device


class MultiRLModule:
    def __init__(self, specs: Dict[str, Dict[str, int]],
                 hidden: Sequence[int] = (64, 64), device=None):
        self.specs = dict(specs)
        self.device = resolve_device(device)
        self.modules: Dict[str, DiscretePolicyModule] = {
            pid: DiscretePolicyModule(s["obs_dim"], s["num_actions"],
                                      hidden, device=self.device)
            for pid, s in specs.items()}

    def __getitem__(self, policy_id: str) -> DiscretePolicyModule:
        return self.modules[policy_id]

    def policy_ids(self):
        return list(self.modules)

    def init(self, rng) -> Dict[str, Any]:
        # one generator, the policies drawn in sorted order (the
        # reference splits one key per policy in that order)
        gen = make_generator(rng, self.device)
        return {pid: m.init(gen)
                for pid, m in sorted(self.modules.items())}

    def forward_exploration(self, policy_id: str, params, obs, rng):
        return self.modules[policy_id].forward_exploration(
            params[policy_id], obs, rng)

    def forward_inference(self, policy_id: str, params, obs):
        return self.modules[policy_id].forward_inference(
            params[policy_id], obs)

    def value(self, policy_id: str, params, obs):
        return self.modules[policy_id].value(params[policy_id], obs)
