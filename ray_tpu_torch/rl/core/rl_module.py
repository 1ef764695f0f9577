"""RLModule: the neural-network policy/value container.

The port of ``ray_tpu/rl/core/rl_module.py`` (reference:
rllib/core/rl_module/rl_module.py).  A module is a bundle of pure
functions over a params tree of tensors, so no framework Module object
crosses a process boundary, only tensors (or their numpy copies), and
checkpointing is a tree save.  The tree keeps the JAX package's layout:
``{"pi": [{"w": [in, out], "b": [out]}, ...], "vf": [...]}``, f32, tanh
between layers.

Three forward passes mirror the reference's contract:
  forward_exploration(params, obs, rng) -> action, extras (sampling)
  forward_inference(params, obs)        -> deterministic action
  forward_train(params, batch)          -> dists/values for the loss

Randomness: a *key* is a Python int and ``rng`` a ``torch.Generator`` on
the module's device (``make_generator``).  ``torch.Generator`` and
``jax.random`` draw different streams, so sampled actions and initial
weights differ from the JAX package's for the same seed; the parity
tests carry weights across with ``from_jax_params``.  ``fold_in`` is a
stable function of its integers (no salted ``hash``), so a key made in
one process is the same key in every other.
"""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._device import resolve_device

# ---------------------------------------------------------------------------
# Keys and generators
# ---------------------------------------------------------------------------


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and ``data`` (``jax.random.fold_in``'s
    role): a stable 63-bit hash of the two integers."""
    h = hashlib.blake2b(struct.pack("<qq", int(key) & (2 ** 63 - 1),
                                    int(data) & (2 ** 63 - 1)),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def make_generator(key, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key`` (an int);
    a generator passes through unchanged."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(key) & (2 ** 63 - 1))
    return gen


# ---------------------------------------------------------------------------
# Params trees (nested dicts / lists / tuples of tensors or arrays)
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in the JAX tree order (dict keys sorted, then list order)
    and the structure to rebuild the tree with ``tree_unflatten``."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if isinstance(x, (list, tuple)):
            return ("list" if isinstance(x, list) else "tuple", None,
                    [walk(v) for v in x])
        leaves.append(x)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves: Sequence[Any]):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, kids = d
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(keys, vals))
        return vals if kind == "list" else tuple(vals)

    return build(treedef)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree):
    leaves, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [fn(x) for x in leaves])


def to_numpy_params(params):
    """Host copy of a params tree: numpy leaves, the JAX package's
    layout (what ``params_digest`` hashes and the object plane carries)."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x),
                    params)


def to_device_params(params, device):
    """A params tree with f32 tensor leaves on ``device`` (numpy or
    tensor leaves in; a leaf already there is kept as it is)."""
    dev = torch.device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x if x.device == dev and x.dtype == torch.float32 \
                else x.to(device=dev, dtype=torch.float32)
        a = np.asarray(x, np.float32)
        if not a.flags.writeable:       # e.g. from the object store
            a = a.copy()
        return torch.as_tensor(a, device=dev)

    return tree_map(leaf, params)


def _check_like(tree, like, path="params"):
    if isinstance(like, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{path}: expected a dict, got "
                             f"{type(tree).__name__}")
        missing = sorted(set(like) - set(tree))
        extra = sorted(set(tree) - set(like))
        if missing or extra:
            raise ValueError(f"{path}: missing leaves {missing}, extra "
                             f"leaves {extra}")
        for k in like:
            _check_like(tree[k], like[k], f"{path}[{k!r}]")
    elif isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{path}: expected {len(like)} entries, got "
                             f"{len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__}")
        for i, (a, b) in enumerate(zip(tree, like)):
            _check_like(a, b, f"{path}[{i}]")
    else:
        shape = tuple(np.shape(tree))
        want = tuple(like.shape)
        if shape != want:
            raise ValueError(f"{path}: shape {shape}, expected {want}")


def from_jax_params(tree, like=None, device=None):
    """A JAX RL module's params (its numpy tree, e.g. ``jax.tree.map(
    np.asarray, params)``) as the port's tree on ``device``.  With
    ``like`` (a port tree, e.g. ``module.init(0)``) every leaf is checked:
    a missing, extra or misshapen leaf raises ``ValueError``."""
    if like is not None:
        _check_like(tree, like)
    return to_device_params(tree, resolve_device(device))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def _init_linear(rng: torch.Generator, n_in: int, n_out: int,
                 scale: float = None):
    scale = scale if scale is not None else math.sqrt(2.0 / n_in)
    return {
        "w": torch.randn((n_in, n_out), generator=rng, device=rng.device,
                         dtype=torch.float32) * scale,
        "b": torch.zeros((n_out,), dtype=torch.float32, device=rng.device),
    }


def _linear(p, x):
    return x @ p["w"] + p["b"]


def _mlp_init(rng: torch.Generator, sizes: Sequence[int],
              out_scale: float = 0.01):
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        params.append(_init_linear(rng, a, b, out_scale if last else None))
    return params


def _mlp_apply(params, x):
    for i, p in enumerate(params):
        x = _linear(p, x)
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def take_action_logp(logp_all: torch.Tensor,
                     action: torch.Tensor) -> torch.Tensor:
    """``logp_all[..., action]`` as a one-hot product: its backward is a
    product too, never the ``scatter_add_`` of a gather's backward, whose
    atomics add in no fixed order on CUDA (the bitwise Sebulba check
    rests on that)."""
    classes = torch.arange(logp_all.shape[-1], device=logp_all.device)
    onehot = (action.long()[..., None] == classes).to(logp_all.dtype)
    return (logp_all * onehot).sum(-1)


# ---------------------------------------------------------------------------
# Random draws, with a seam for pre-drawn noise
# ---------------------------------------------------------------------------


def gumbel(rng: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of ``shape`` from ``rng``,
    ``u`` uniform and at least the dtype's smallest normal number."""
    u = torch.rand(shape, generator=rng, device=rng.device, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def categorical(rng, logits: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A sample of softmax(logits) over the last axis by Gumbel-max: no
    host sync.  ``noise`` is the Gumbel draw at ``logits``' shape and
    replaces the draw from ``rng`` (``jax.random.categorical(key,
    logits)`` is ``argmax(gumbel(key, logits.shape) + logits)``, so the
    parity tests feed both packages JAX's draw)."""
    if noise is None:
        noise = gumbel(rng, logits.shape, logits.dtype)
    return torch.argmax(logits + noise, dim=-1)


def draw(rng, name: str, make: Callable[[torch.Generator], torch.Tensor]):
    """The noise of a loss's draw ``name``: ``rng[name]`` when ``rng``
    maps draw names to pre-drawn noise tensors (the seam the parity
    tests feed the JAX package's draws through), else ``make(rng)``."""
    if isinstance(rng, dict):
        return rng[name]
    return make(rng)


class RLModule:
    """Base: subclasses define init() and the forward fns as pure fns."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), device=None):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.device = resolve_device(device)

    def init(self, rng) -> Any:
        raise NotImplementedError

    def forward_exploration(self, params, obs, rng):
        raise NotImplementedError

    def forward_inference(self, params, obs):
        raise NotImplementedError


class DiscretePolicyModule(RLModule):
    """Separate policy and value MLP heads over a shared input
    (reference: rllib default MLP RLModule for PG algorithms)."""

    def init(self, rng):
        gen = make_generator(rng, self.device)
        sizes = (self.obs_dim, *self.hidden)
        pi = _mlp_init(gen, (*sizes, self.num_actions))
        vf = _mlp_init(gen, (*sizes, 1), out_scale=1.0)
        return {"pi": pi, "vf": vf}

    # -- pure functions ------------------------------------------------------

    def logits(self, params, obs):
        return _mlp_apply(params["pi"], obs)

    def value(self, params, obs):
        return _mlp_apply(params["vf"], obs)[..., 0]

    def forward_exploration(self, params, obs, rng):
        """Sample a ~ softmax(logits) by Gumbel-max with ``rng``: no host
        sync, and the same generator state gives the same actions."""
        logits = self.logits(params, obs)
        action = categorical(rng, logits)
        logp = torch.log_softmax(logits, dim=-1)
        logp_a = take_action_logp(logp, action)
        return action, {"logp": logp_a, "vf": self.value(params, obs)}

    def forward_inference(self, params, obs):
        return torch.argmax(self.logits(params, obs), dim=-1)


class QModule(RLModule):
    """State-action value net for DQN-family algorithms
    (reference: rllib/algorithms/dqn/ default module)."""

    def init(self, rng):
        gen = make_generator(rng, self.device)
        sizes = (self.obs_dim, *self.hidden, self.num_actions)
        q = _mlp_init(gen, sizes, out_scale=0.01)
        return {"q": q, "target_q": tree_map(torch.clone, q)}

    def q_values(self, params, obs, target: bool = False):
        return _mlp_apply(params["target_q" if target else "q"], obs)

    def forward_exploration(self, params, obs, rng, epsilon: float = 0.05):
        q = self.q_values(params, obs)
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, self.num_actions, greedy.shape,
                                 generator=rng, device=q.device)
        explore = torch.rand(greedy.shape, generator=rng,
                             device=q.device) < epsilon
        return torch.where(explore, random_a, greedy), {}

    def forward_inference(self, params, obs):
        return torch.argmax(self.q_values(params, obs), dim=-1)


# algorithm-owned module kinds register here (e.g. SAC's policy+twin-Q)
MODULE_REGISTRY: Dict[str, type] = {}


def module_for_env(env_spec: Dict[str, Any], kind: str = "policy",
                   hidden: Sequence[int] = (64, 64), device=None,
                   **kwargs) -> RLModule:
    if "action_dim" in env_spec and "num_actions" not in env_spec:
        # continuous (Box) action space: dispatch to the kind's
        # continuous-action module (e.g. sac -> sac_continuous)
        cls = MODULE_REGISTRY.get(f"{kind}_continuous")
        if cls is None:
            raise ValueError(
                f"algorithm kind {kind!r} has no continuous-action "
                f"module registered (env spec: {sorted(env_spec)})")
        return cls(env_spec["obs_dim"], env_spec["action_dim"], hidden,
                   low=env_spec.get("action_low", -1.0),
                   high=env_spec.get("action_high", 1.0), device=device,
                   **kwargs)
    cls = MODULE_REGISTRY.get(kind) or (
        DiscretePolicyModule if kind == "policy" else QModule)
    return cls(env_spec["obs_dim"], env_spec["num_actions"], hidden,
               device=device, **kwargs)
