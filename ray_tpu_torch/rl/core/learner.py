"""Learner: gradient updates over an RLModule.

The port of ``ray_tpu/rl/core/learner.py`` (reference:
rllib/core/learner/learner.py): owns params + optimizer state, applies a
loss over batches.  The update (loss, gradient, clip, Adam, metrics) is
one function of tensors on the learner's device with no host sync in it,
so Anakin (``rl/podracer.py``) chains it on the card; ``Learner.update``
reads its metrics back as floats.

The optimizer is the reference's ``optax.chain(clip_by_global_norm(
grad_clip), adam(lr))`` written out: optax's clip scales by
``max_norm / norm`` only when ``norm >= max_norm`` (``torch.nn.utils.
clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)`` always, which
is not the same update), and Adam in optax's order of operations.  Its
state keeps optax's fields: ``count``, ``mu`` and ``nu`` (one per leaf of
the trainable tree, in the tree's leaf order).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..._device import resolve_device
from .rl_module import (RLModule, make_generator, to_device_params,
                        to_numpy_params, tree_flatten, tree_unflatten)

# ---------------------------------------------------------------------------
# optax's clip_by_global_norm and adam, on flat lists of tensors
# ---------------------------------------------------------------------------


class GradientTransformation(NamedTuple):
    """optax's (init, update) pair over flat lists of leaves:
    ``init(leaves) -> state``, ``update(grads, state) -> (updates,
    state)``."""

    init: Callable
    update: Callable


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's sum of squares."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(leaves):
        return ()

    def update(grads, state):
        g_norm = global_norm(grads)
        trigger = g_norm < max_norm
        return [torch.where(trigger, g, (g / g_norm) * max_norm)
                for g in grads], state

    return GradientTransformation(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam(lr): the moments, their bias corrections at the
    incremented count, ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by
    ``-lr``.  The count lives on the host, so an update reads nothing
    back from the card."""

    def init(leaves):
        return {"count": 0,
                "mu": [torch.zeros_like(x) for x in leaves],
                "nu": [torch.zeros_like(x) for x in leaves]}

    def update(grads, state):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * n for g, n in zip(grads, state["nu"])]
        count = state["count"] + 1
        # optax forms 1 - decay**count in f32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        updates = [-lr * ((m / bc1) / (torch.sqrt(n / bc2) + eps))
                   for m, n in zip(mu, nu)]
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(leaves):
        return tuple(tx.init(leaves) for tx in txs)

    def update(grads, state):
        new = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


def _state_to_numpy(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, dict):
        return {k: _state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_state_to_numpy(v) for v in state)
    return state


def _state_to_device(state, device):
    if isinstance(state, np.ndarray):
        return torch.as_tensor(state, device=device)
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, dict):
        return {k: _state_to_device(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_state_to_device(v, device) for v in state)
    return state


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Numpy (or tensor) batch columns as tensors on ``device``; float64
    columns become f32 (the reference's jnp.asarray does the same)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            t = v.to(device)
        else:
            a = np.asarray(v)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            elif not a.flags.writeable:     # e.g. from the object store
                a = a.copy()
            t = torch.as_tensor(a, device=device)
        out[k] = t
    return out


class Learner:
    """Single-device learner.  Subclasses define compute_loss(params,
    batch, rng) -> (loss, metrics)."""

    def __init__(self, module: RLModule, *, lr: float = 3e-4,
                 grad_clip: Optional[float] = 0.5, seed: int = 0,
                 optimizer: Optional[GradientTransformation] = None,
                 device=None):
        self.module = module
        self.device = resolve_device(device if device is not None
                                     else module.device)
        tx = optimizer or adam(lr)
        if grad_clip is not None:
            tx = chain(clip_by_global_norm(grad_clip), tx)
        self.tx = tx
        self.params = module.init(seed)
        self.opt_state = tx.init(tree_flatten(
            self._trainable(self.params))[0])
        self.rng = make_generator(seed + 17, self.device)
        self._update_fn = self._update

    # -- overridables ------------------------------------------------------

    def compute_loss(self, params, batch, rng) -> Tuple[torch.Tensor,
                                                        Dict[str, Any]]:
        raise NotImplementedError

    def _trainable(self, params):
        """Subset of params the optimizer touches (e.g. excludes DQN's
        target net, which moves by polyak/periodic copy instead)."""
        return params

    def _merge(self, params, trained):
        """Inverse of _trainable."""
        return trained

    def extra_update(self, params, metrics):
        """Post-gradient param surgery (target-net sync etc.)."""
        return params

    # -- the update: tensors in, tensors out, no host sync -----------------

    def _update(self, params, opt_state, batch, rng):
        leaves, tdef = tree_flatten(self._trainable(params))
        with torch.enable_grad():
            live = [x.detach().requires_grad_(True) for x in leaves]
            full = self._merge(params, tree_unflatten(tdef, live))
            loss, metrics = self.compute_loss(full, batch, rng)
            grads = list(torch.autograd.grad(loss, live))
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, opt_state)
            trained = [p + u for p, u in zip(leaves, updates)]
            params = self._merge(params, tree_unflatten(tdef, trained))
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["loss"] = loss.detach()
            metrics["grad_norm"] = global_norm(grads)
        return params, opt_state, metrics

    def update(self, batch: Dict[str, Any],
               rng=None) -> Dict[str, float]:
        """One update on ``batch``.  ``rng`` replaces the learner's
        generator for this update: another generator, or a dict of
        pre-drawn noise tensors by draw name (``rl_module.draw``)."""
        batch = batch_to_device(batch, self.device)
        self.params, self.opt_state, metrics = self._update_fn(
            self.params, self.opt_state, batch,
            self.rng if rng is None else rng)
        self.params = self.extra_update(self.params, metrics)
        return {k: float(v) for k, v in metrics.items()}

    # -- weights -----------------------------------------------------------

    def get_weights(self):
        return self.params

    def set_weights(self, params):
        self.params = to_device_params(params, self.device)

    def state(self) -> Dict[str, Any]:
        """Params and optimizer state as numpy trees: picklable, and
        loadable on any device."""
        return {"params": to_numpy_params(self.params),
                "opt_state": _state_to_numpy(self.opt_state)}

    def load_state(self, state: Dict[str, Any]):
        self.params = to_device_params(state["params"], self.device)
        self.opt_state = _state_to_device(state["opt_state"], self.device)


class _LearnerActor:
    """A learner in a runtime actor; weights cross as numpy trees.  Its
    torch computes with the ``num_cpus`` its lease grants."""

    def __init__(self, factory, shard_idx: int, num_cpus: float = 1):
        from ..env.env_runner import use_cpu_threads

        use_cpu_threads(num_cpus)
        self.learner = factory()
        self.shard_idx = shard_idx

    def update(self, batch):
        return self.learner.update(batch)

    def get_weights(self):
        return to_numpy_params(self.learner.get_weights())

    def set_weights(self, w):
        self.learner.set_weights(w)

    def state(self):
        return self.learner.state()

    def load_state(self, s):
        self.learner.load_state(s)


class LearnerGroup:
    """1..N learners (reference: rllib/core/learner/learner_group.py:80,
    built on Train's BackendExecutor :54,:151).

    local mode: one in-process learner.  remote mode: N learner actors;
    each update shards the batch, learners compute grads on their shard,
    and weights are averaged on the host (numpy), as the reference does.
    ``actor_options`` go to every learner actor (``{"num_gpus": 1 / n}``
    puts n learners on one card).
    """

    def __init__(self, learner_factory: Callable[[], Learner],
                 num_learners: int = 0,
                 actor_options: Optional[Dict[str, Any]] = None):
        self.local = num_learners == 0
        if self.local:
            self.learner = learner_factory()
            self.actors = []
        else:
            import ray_tpu_torch as rt

            opts = {"num_cpus": 1, **(actor_options or {})}
            remote_cls = rt.remote(_LearnerActor).options(**opts)
            self.actors = [remote_cls.remote(learner_factory, i,
                                             opts["num_cpus"])
                           for i in range(num_learners)]

    def update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        if self.local:
            return self.learner.update(batch)
        import ray_tpu_torch as rt

        n = len(self.actors)
        shards = [
            {k: v[i::n] for k, v in batch.items()} for i in range(n)
        ]
        metrics = rt.get([a.update.remote(s)
                          for a, s in zip(self.actors, shards)])
        # average weights across learners (grad-mean equivalent for equal
        # shards under identical init)
        weights = rt.get([a.get_weights.remote() for a in self.actors])
        leaves = [tree_flatten(w)[0] for w in weights]
        tdef = tree_flatten(weights[0])[1]
        mean_w = tree_unflatten(tdef, [np.mean(np.stack(xs), axis=0)
                                       for xs in zip(*leaves)])
        rt.get([a.set_weights.remote(mean_w) for a in self.actors])
        out = {}
        for k in metrics[0]:
            out[k] = float(np.mean([m[k] for m in metrics]))
        return out

    def get_weights(self):
        if self.local:
            return self.learner.get_weights()
        import ray_tpu_torch as rt

        return rt.get(self.actors[0].get_weights.remote())

    def set_weights(self, w):
        if self.local:
            self.learner.set_weights(w)
        else:
            import ray_tpu_torch as rt

            w = to_numpy_params(w)
            rt.get([a.set_weights.remote(w) for a in self.actors])

    def state(self):
        if self.local:
            return self.learner.state()
        import ray_tpu_torch as rt

        return rt.get(self.actors[0].state.remote())

    def load_state(self, s):
        if self.local:
            self.learner.load_state(s)
        else:
            import ray_tpu_torch as rt

            rt.get([a.load_state.remote(s) for a in self.actors])

    def stop(self):
        if self.local:
            return
        import ray_tpu_torch as rt

        for a in self.actors:
            try:
                rt.kill(a)
            except Exception:
                pass
