"""ConnectorV2 base + pipeline (reference:
rllib/connectors/connector_v2.py ConnectorV2,
rllib/connectors/connector_pipeline_v2.py ConnectorPipeline).

A connector is a small callable transforming a batch (obs on the way
into the module, actions on the way out); a pipeline composes them in
order and supports insertion/removal by class — the reference's key
property, letting users splice custom preprocessing into the default
stack without forking the runner.

Device note: connectors on the JaxEnvRunner rollout path run inside
``jax_env.rollout``'s loop on device tensors, so they must be
"traceable": pure tensor ops with no host sync and no Python state.
``traceable`` declares that; the stateful ones
(NormalizeObs) are host-side only and the runner enforces it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Type


class ConnectorV2:
    """One transformation step; subclasses override __call__."""

    #: safe to run inside the device rollout loop (a pure function of
    #: its inputs, no host sync)
    traceable: bool = True

    def __call__(self, data: Any, ctx: Optional[dict] = None) -> Any:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class ConnectorPipeline(ConnectorV2):
    """Ordered composition of connectors (reference:
    connector_pipeline_v2.py — prepend/append/insert_after/remove)."""

    def __init__(self, *connectors: ConnectorV2):
        self.connectors: List[ConnectorV2] = list(connectors)

    @property
    def traceable(self) -> bool:  # type: ignore[override]
        return all(c.traceable for c in self.connectors)

    def __call__(self, data: Any, ctx: Optional[dict] = None) -> Any:
        for c in self.connectors:
            data = c(data, ctx)
        return data

    # -- mutation (reference API names) ---------------------------------

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def append(self, connector: ConnectorV2) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def _index_of(self, cls: Type[ConnectorV2]) -> int:
        for i, c in enumerate(self.connectors):
            if isinstance(c, cls):
                return i
        raise ValueError(f"no {cls.__name__} in pipeline {self}")

    def insert_after(self, cls: Type[ConnectorV2],
                     connector: ConnectorV2) -> "ConnectorPipeline":
        self.connectors.insert(self._index_of(cls) + 1, connector)
        return self

    def insert_before(self, cls: Type[ConnectorV2],
                      connector: ConnectorV2) -> "ConnectorPipeline":
        self.connectors.insert(self._index_of(cls), connector)
        return self

    def remove(self, cls: Type[ConnectorV2]) -> "ConnectorPipeline":
        del self.connectors[self._index_of(cls)]
        return self

    def __repr__(self):
        inner = " -> ".join(repr(c) for c in self.connectors)
        return f"ConnectorPipeline[{inner}]"
