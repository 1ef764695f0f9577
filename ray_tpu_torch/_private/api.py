"""Public API objects: @remote functions, actor classes, handles, options.

Mirrors the reference's decorator machinery (reference:
python/ray/remote_function.py:266 RemoteFunction._remote,
python/ray/actor.py ActorClass/ActorHandle).  The port's copy of
``ray_tpu/_private/api.py``, which asks for chips with ``num_tpus``; the
port asks for cards with ``num_gpus`` (resource "GPU"), as Ray does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from . import common
from .core import ObjectRef, current_core


def _build_resources(num_cpus=None, num_gpus=None, resources=None,
                     default_cpus: float = 1.0) -> Dict[str, float]:
    out: Dict[str, float] = dict(resources or {})
    out[common.CPU] = float(default_cpus if num_cpus is None else num_cpus)
    if num_gpus is not None and num_gpus > 0:
        out[common.GPU] = float(num_gpus)
    if out.get(common.CPU) == 0:
        out.pop(common.CPU, None)
    return out


def _strategy_to_wire(scheduling_strategy) -> tuple:
    """Returns (strategy_dict, pg_id, bundle_index)."""
    if scheduling_strategy is None or scheduling_strategy == "DEFAULT":
        return None, None, -1
    if scheduling_strategy == "SPREAD":
        return {"kind": "spread"}, None, -1
    kind = type(scheduling_strategy).__name__
    if kind == "PlacementGroupSchedulingStrategy":
        pg = scheduling_strategy.placement_group
        return None, pg.id, scheduling_strategy.placement_group_bundle_index
    if kind == "NodeAffinitySchedulingStrategy":
        return {"kind": "node_affinity",
                "node_id": scheduling_strategy.node_id,
                "soft": scheduling_strategy.soft}, None, -1
    if kind == "NodeLabelSchedulingStrategy":
        return scheduling_strategy.to_wire(), None, -1
    raise ValueError(f"unknown scheduling strategy: {scheduling_strategy!r}")


class RemoteFunction:
    def __init__(self, fn, **opts):
        self._fn = fn
        self._opts = opts
        functools.update_wrapper(self, fn)

    def options(self, **opts):
        merged = {**self._opts, **opts}
        return RemoteFunction(self._fn, **merged)

    def remote(self, *args, **kwargs):
        core = current_core()
        o = self._opts
        strategy, pg, bidx = _strategy_to_wire(o.get("scheduling_strategy"))
        if pg is None and o.get("placement_group") is not None:
            pg = o["placement_group"].id
            bidx = o.get("placement_group_bundle_index", -1)
        nr = o.get("num_returns", 1)
        refs = core.submit_task(
            self._fn, args, kwargs,
            num_returns=nr,
            resources=_build_resources(o.get("num_cpus"), o.get("num_gpus"),
                                       o.get("resources")),
            max_retries=o.get("max_retries", 3),
            strategy=strategy, pg=pg, bundle_index=bidx,
            name=o.get("name", ""),
            runtime_env=o.get("runtime_env"),
            generator_backpressure=o.get(
                "_generator_backpressure_num_objects", 0) or 0,
        )
        # streaming tasks return one ObjectRefGenerator
        return refs[0] if nr == 1 or nr == "streaming" else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._fn.__name__} cannot be called directly; "
            f"use .remote()")

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of executing (reference: python/ray/dag
        function_node.py) — used by interpreted DAGs and workflows."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 generator_backpressure: int = 0):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._generator_backpressure = generator_backpressure

    def options(self, num_returns: int = 1,
                _generator_backpressure_num_objects: int = 0):
        return ActorMethod(self._handle, self._name, num_returns,
                           _generator_backpressure_num_objects or 0)

    def remote(self, *args, **kwargs):
        core = current_core()
        refs = core.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns,
            generator_backpressure=self._generator_backpressure)
        # streaming methods return one ObjectRefGenerator
        return refs[0] if self._num_returns in (1, "streaming") else refs

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of executing (reference:
        python/ray/dag — actor.method.bind)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: str, class_name: str = "Actor",
                 is_owner: bool = False, owner_addr=None,
                 _register_borrow: bool = False,
                 _transit_nonce: Optional[str] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._is_owner = is_owner
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._borrow_registered = False
        if _register_borrow and not is_owner:
            # deserialized handle: register as a borrower with the owner
            # so the actor outlives the owner's handles while we exist
            # (reference: distributed actor-handle reference counting);
            # the nonce retires the specific transit hold this pickle took
            try:
                core = current_core()
                if core is not None and not core._shutdown:
                    self._borrow_registered = core.on_actor_handle_borrowed(
                        actor_id, self._owner_addr, nonce=_transit_nonce)
            except Exception:
                pass

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id})"

    def _actor_call(self, fn, *args, **kwargs):
        """Run `fn(actor_instance, *args)` inside the actor (reference:
        ActorHandle.__ray_call__) — returns an ObjectRef."""
        return ActorMethod(self, "__apply__").remote(fn, *args, **kwargs)

    def __reduce__(self):
        # deserialized handles are borrowed: they don't own the lifetime
        # but DO extend it (the serializing core takes a per-pickle
        # transit hold so the actor survives the pickling->registration
        # gap; the nonce rides the pickle so the receiver retires exactly
        # this hold)
        nonce = None
        try:
            core = current_core()
            if core is not None and not core._shutdown:
                nonce = core.on_actor_handle_serialized(self._actor_id,
                                                        self._owner_addr)
        except Exception:
            pass
        return (ActorHandle, (self._actor_id, self._class_name, False,
                              self._owner_addr, True, nonce))

    def __del__(self):
        # the last owner handle going out of scope terminates the actor
        # gracefully — queued behind in-flight calls, so
        # `Actor.remote().method.remote()` temporaries don't kill the
        # actor under their own call (reference semantics: actors are
        # GC'd when no handle remains, via a __ray_terminate__ marker
        # task); borrowed handles deregister with the owner instead
        if getattr(self, "_is_owner", False):
            try:
                core = current_core()
                if not core._shutdown:
                    core.release_actor(self._actor_id)
            except Exception:
                pass
        elif getattr(self, "_borrow_registered", False):
            try:
                core = current_core()
                if core is not None and not core._shutdown:
                    core.on_actor_handle_dropped(self._actor_id)
            except Exception:
                pass


class ActorClass:
    def __init__(self, cls, **opts):
        self._cls = cls
        self._opts = opts

    def options(self, **opts):
        return ActorClass(self._cls, **{**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = current_core()
        o = self._opts
        if o.get("get_if_exists"):
            # idempotent get-or-create for named actors (reference:
            # actor options get_if_exists) — fetch first; creation races
            # fall through to the name-collision fetch below
            if not o.get("name"):
                raise ValueError("get_if_exists requires a name")
            view = core.get_actor_by_name(o["name"],
                                          namespace=o.get("namespace"))
            if view is not None and view["state"] != "DEAD":
                return ActorHandle(view["actor_id"], self._cls.__name__,
                                   is_owner=False)
            try:
                return self.options(get_if_exists=False).remote(
                    *args, **kwargs)
            except Exception as e:
                if "already taken" not in str(e):
                    raise
                view = core.get_actor_by_name(o["name"],
                                              namespace=o.get("namespace"))
                if view is None:
                    raise
                return ActorHandle(view["actor_id"], self._cls.__name__,
                                   is_owner=False)
        strategy, pg, bidx = _strategy_to_wire(o.get("scheduling_strategy"))
        if pg is None and o.get("placement_group") is not None:
            pg = o["placement_group"].id
            bidx = o.get("placement_group_bundle_index", -1)
        aid = core.create_actor(
            self._cls, args, kwargs,
            resources=_build_resources(o.get("num_cpus"), o.get("num_gpus"),
                                       o.get("resources")),
            name=o.get("name"),
            max_restarts=o.get("max_restarts", 0),
            max_task_retries=o.get("max_task_retries", 0),
            max_concurrency=o.get("max_concurrency", 1),
            pg=pg, bundle_index=bidx,
            detached=o.get("lifetime") == "detached",
            runtime_env=o.get("runtime_env"),
            namespace=o.get("namespace"),
            strategy=strategy,
        )
        return ActorHandle(aid, self._cls.__name__,
                           is_owner=o.get("lifetime") != "detached",
                           owner_addr=core.addr)

    def __call__(self, *a, **k):
        raise TypeError(f"actor class {self._cls.__name__} cannot be "
                        f"instantiated directly; use .remote()")


def remote(*args, **opts):
    """@ray_tpu_torch.remote decorator for functions and classes."""

    def wrap(obj):
        if isinstance(obj, type):
            return ActorClass(obj, **opts)
        return RemoteFunction(obj, **opts)

    if len(args) == 1 and not opts and (callable(args[0]) or isinstance(args[0], type)):
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return wrap


def get_actor(name: str, namespace: str = None) -> ActorHandle:
    """Named-actor lookup.  The returned handle is WEAK (owner_addr-less):
    it neither owns nor extends the actor's lifetime, matching the
    reference — a named non-detached actor still dies when its creator's
    handles drop; use lifetime="detached" to outlive the creator."""
    core = current_core()
    view = core.get_actor_by_name(name, namespace=namespace)
    if view is None or view["state"] == "DEAD":
        raise ValueError(f"no alive actor named {name!r}")
    return ActorHandle(view["actor_id"], view.get("class_name") or "Actor")


def kill(handle: ActorHandle, no_restart: bool = True):
    current_core().kill_actor(handle._actor_id, no_restart=no_restart)
