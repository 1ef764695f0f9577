"""Environments as pure functions over batched device tensors.

The port of ``ray_tpu/rl/env/jax_env.py``.  The name stays: these are
the JAX package's ``jax_env`` environments, here vectorized over a batch
dimension of device tensors instead of ``vmap``.  An environment is a
pair of functions

    reset(rng, num_envs)  -> (state, obs)
    step(state, action)   -> (state, obs, reward, done)

over a state of ``[num_envs]`` tensors on one device, so a whole rollout
is a loop of device ops with no host sync in it: sampling stays on the
card (the gymnax/brax pattern).  Gymnasium envs remain supported
host-side via env_runner.GymEnvRunner for API parity.

Randomness: the state carries a ``torch.Generator`` (``rng``) that draws
the reset values of auto-resetting envs.  Its stream is not
``jax.random``'s, so reset states differ from the JAX package's; the
dynamics (constants, order of operations, termination, auto-reset) are
its own.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..core.rl_module import make_generator


class JaxEnv:
    """Stateless env description; state is an explicit tuple of batched
    tensors."""

    #: dict with obs_dim / num_actions / max_episode_steps
    spec: Dict[str, Any]

    def reset(self, rng, num_envs: int) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step(self, state, action) -> Tuple[Any, torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
        raise NotImplementedError


def _uniform(rng: torch.Generator, shape, low, high):
    u = torch.rand(shape, generator=rng, device=rng.device,
                   dtype=torch.float32)
    return low + (high - low) * u


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor
    rng: torch.Generator


class CartPole(JaxEnv):
    """CartPole-v1 dynamics (matches gymnasium classic_control cartpole:
    same constants, Euler integration, termination bounds)."""

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSCART + MASSPOLE
    LENGTH = 0.5
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4

    spec = {"obs_dim": 4, "num_actions": 2, "max_episode_steps": 500}

    def reset(self, rng, num_envs: int, device=None):
        rng = make_generator(rng, device)
        vals = _uniform(rng, (num_envs, 4), -0.05, 0.05)
        state = CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3],
                              torch.zeros(num_envs, dtype=torch.int32,
                                          device=rng.device), rng)
        return state, self._obs(state)

    def _obs(self, s: CartPoleState):
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def step(self, s: CartPoleState, action):
        force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = torch.cos(s.theta)
        sintheta = torch.sin(s.theta)
        temp = (force + self.POLEMASS_LENGTH * s.theta_dot ** 2 * sintheta) \
            / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASSPOLE * costheta ** 2 / self.TOTAL_MASS))
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta \
            / self.TOTAL_MASS
        x = s.x + self.TAU * s.x_dot
        x_dot = s.x_dot + self.TAU * xacc
        theta = s.theta + self.TAU * s.theta_dot
        theta_dot = s.theta_dot + self.TAU * thetaacc
        t = s.t + 1
        done = (
            (torch.abs(x) > self.X_LIMIT)
            | (torch.abs(theta) > self.THETA_LIMIT)
            | (t >= self.spec["max_episode_steps"])
        )
        # auto-reset on done (vectorized envs never sit idle)
        reset_vals = _uniform(s.rng, (x.shape[0], 4), -0.05, 0.05)
        new = CartPoleState(
            torch.where(done, reset_vals[:, 0], x),
            torch.where(done, reset_vals[:, 1], x_dot),
            torch.where(done, reset_vals[:, 2], theta),
            torch.where(done, reset_vals[:, 3], theta_dot),
            torch.where(done, 0, t), s.rng)
        return new, self._obs(new), torch.ones_like(x), done


class PendulumState(NamedTuple):
    th: torch.Tensor
    thdot: torch.Tensor
    t: torch.Tensor
    rng: torch.Generator


class Pendulum(JaxEnv):
    """Pendulum-v1 dynamics (gymnasium classic_control pendulum: same
    constants, semi-implicit Euler, ±8 rad/s speed clip).  The canonical
    continuous-control benchmark: obs [cos th, sin th, thdot], one torque
    action in [-2, 2], reward -(angle^2 + 0.1 thdot^2 + 0.001 u^2);
    200-step episodes (truncation only, auto-reset)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    # time_limit_only: done is truncation, never a terminal state —
    # value-based learners must not cut bootstrap targets on it
    spec = {"obs_dim": 3, "action_dim": 1,
            "action_low": -2.0, "action_high": 2.0,
            "max_episode_steps": 200, "time_limit_only": True}

    def _reset_vals(self, rng, n):
        th = _uniform(rng, (n,), -math.pi, math.pi)
        thdot = _uniform(rng, (n,), -1.0, 1.0)
        return th, thdot

    def reset(self, rng, num_envs: int, device=None):
        rng = make_generator(rng, device)
        th, thdot = self._reset_vals(rng, num_envs)
        state = PendulumState(th, thdot,
                              torch.zeros(num_envs, dtype=torch.int32,
                                          device=rng.device), rng)
        return state, self._obs(state)

    def _obs(self, s: PendulumState):
        return torch.stack([torch.cos(s.th), torch.sin(s.th), s.thdot],
                           dim=-1)

    def step(self, s: PendulumState, action):
        u = torch.clip(action.reshape(s.th.shape[0]).to(torch.float32),
                       -self.MAX_TORQUE, self.MAX_TORQUE)
        th_norm = ((s.th + math.pi) % (2 * math.pi)) - math.pi
        cost = th_norm ** 2 + 0.1 * s.thdot ** 2 + 0.001 * u ** 2
        thdot = s.thdot + (3 * self.G / (2 * self.L) * torch.sin(s.th)
                           + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thdot = torch.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED)
        th = s.th + thdot * self.DT
        t = s.t + 1
        done = t >= self.spec["max_episode_steps"]
        reset_th, reset_thdot = self._reset_vals(s.rng, th.shape[0])
        new = PendulumState(
            torch.where(done, reset_th, th),
            torch.where(done, reset_thdot, thdot),
            torch.where(done, 0, t), s.rng)
        return new, self._obs(new), -cost, done


_REGISTRY: Dict[str, Callable[[], JaxEnv]] = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
}


def register_env(name: str, ctor: Callable[[], JaxEnv]):
    _REGISTRY[name] = ctor


def make_env(name: str) -> JaxEnv:
    if name not in _REGISTRY:
        raise KeyError(f"unknown jax env {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def rollout(env: JaxEnv, policy_fn, params, carry, num_steps: int):
    """Vectorized on-device rollout: ``num_steps`` steps of every env.

    policy_fn(params, obs, rng) -> (action, extras) — typically
    RLModule.forward_exploration.  carry = (env_states, obs, rng) from a
    previous call (or ``init_carry``), so sampling is continuous across
    batch boundaries like the reference's EnvRunner.  The loop issues
    device work only: nothing in it reads a tensor back to the host.

    Returns (new_carry, batch) where batch tensors are [T, B, ...]:
    obs, action, reward, done, plus whatever extras policy_fn emits.
    """
    states, obs, rng = carry
    steps = []
    with torch.no_grad():
        for _ in range(num_steps):
            action, extras = policy_fn(params, obs, rng)
            states, next_obs, reward, done = env.step(states, action)
            steps.append({"obs": obs, "action": action, "reward": reward,
                          "done": done, **extras})
            obs = next_obs
        batch = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return (states, obs, rng), batch


def init_carry(env: JaxEnv, rng: int, num_envs: int, device=None):
    """(states, obs, policy_rng) for ``num_envs`` fresh envs from the key
    ``rng`` (an int): the envs' resets draw from one generator, the
    policy from another, both derived from the key."""
    from ..core.rl_module import fold_in

    states, obs = env.reset(make_generator(fold_in(rng, 1), device), num_envs)
    return states, obs, make_generator(fold_in(rng, 0), device)
