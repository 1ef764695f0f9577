"""CUDA peer memory for the fused int8 reduce-scatter (K7).

The reference's fused kernel writes each peer its rows by remote DMA
(``ray_tpu/ops/quantize.py:316``).  On CUDA the same exchange is a store
into the peer's memory: every rank ``cudaMalloc``s one receive region,
exports it with ``cudaIpcGetMemHandle``, and maps its peers' regions with
``cudaIpcOpenMemHandle``; K7 (``csrc/fused_rs.cu``) gets the table of the
world regions and stores each row straight into its destination's region.

``PeerBuffers.for_group`` sets this up for an NCCL group (every member
calls it at the same point: ``collective.init_collective_group`` does,
after the rendezvous) and registers it under the process group, where
``lookup``/``require`` find it.  A group gets none, and its collectives
take the staged path, when a pair of members cannot map each other's
memory: two members on one card (their kernels would not run side by
side), a card some member cannot see (every rank must see every card:
masking ``CUDA_VISIBLE_DEVICES`` per rank breaks the mapping), or no P2P
access between two cards.  ``PeerBuffers.loopback`` hosts all ranks'
regions on one card for one cooperative launch (a test of the protocol).

A region grows when a chunk does not fit.  Growth is collective: every
rank reaches it at the same call, because every rank lays its chunks out
alike; the new regions are zeroed and the epoch (the call counter K7's
flags hold) restarts at 1.  ``close`` frees everything
(``collective.destroy_collective_group`` calls it).

A launch that waits past ``timeout_s`` for a peer writes an error code to
a word in mapped host memory and ends; the next K7 call on these buffers
and ``check()`` raise it, so a missing peer fails the run instead of
hanging it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import _kernels

TIMEOUT_S = 10.0
_MIN_DATA_BYTES = 1 << 20
_ERRORS = {1: "a destination was still reading the previous call's rows",
           2: "a peer's rows did not arrive"}

_registry: Dict[int, Tuple[object, "PeerBuffers"]] = {}


def _align(n: int, a: int = 16) -> int:
    return n + (-n) % a


def _gather(pg, obj) -> list:
    out = [None] * dist.get_world_size(pg)
    dist.all_gather_object(out, obj, group=pg)
    return out


def _card_id(index: int) -> str:
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"{props.name}#{index}"


class PeerBuffers:
    """The receive regions of one group's ranks and K7's state over them:
    the device table of region pointers, the epoch, the grid cap, the
    error word."""

    def __init__(self, device: torch.device, world: int, rank: int,
                 loopback: bool, group, grid_cap: int, timeout_s: float):
        data_off, max_world, self._max_ctas = _kernels.fused_rs_layout()
        if not 1 <= world <= max_world:
            raise ValueError(f"K7 takes a world of 1..{max_world}, got "
                             f"{world}")
        self.device, self.world, self.rank = device, world, rank
        self.loopback, self.group = loopback, group
        self.timeout_s = float(timeout_s)
        self.epoch = 0
        self.data_bytes = 0
        self.table: Optional[torch.Tensor] = None
        self._data_off = data_off
        self._grid_cap = max(1, grid_cap)
        self._own: List[int] = []       # regions this process allocated
        self._opened: List[int] = []    # peers' regions it mapped
        with torch.cuda.device(device):
            self._err_host, self.error_device_ptr = _kernels.host_word()

    @classmethod
    def for_group(cls, pg, device: torch.device,
                  timeout_s: float = TIMEOUT_S) -> Optional["PeerBuffers"]:
        """Peer memory for the NCCL group ``pg``, this rank on ``device``;
        None (on every member alike) when some pair cannot map each
        other's memory.  Collective: every member calls it."""
        world, rank = dist.get_world_size(pg), dist.get_rank(pg)
        with torch.cuda.device(device):
            local = {_card_id(i): i for i in range(torch.cuda.device_count())}
            cards = _gather(pg, _card_id(device.index))
            ok = (len(set(cards)) == world and all(c in local for c in cards)
                  and all(_kernels.can_access_peer(device.index, local[c])
                          for c in cards if local[c] != device.index))
            _, sms = _kernels.fused_rs_residency()
            agreed = _gather(pg, (ok, sms))
        if not all(a for a, _ in agreed):
            return None
        # at most one CTA per SM: every spinning CTA stays co-resident with
        # its peers' and with the NCCL kernels of other streams
        buf = cls(device, world, rank, False, pg, min(s for _, s in agreed),
                  timeout_s)
        buf._allocate(_MIN_DATA_BYTES)
        return buf

    @classmethod
    def loopback(cls, world: int, device=None,
                 timeout_s: float = TIMEOUT_S) -> "PeerBuffers":
        """``world`` ranks' regions on one card, for one cooperative launch
        hosting them all (``ops.quantize.fused_reduce_scatter_loopback``)."""
        device = torch.device(device or "cuda")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with torch.cuda.device(device):
            resident, _ = _kernels.fused_rs_residency()
        buf = cls(device, world, 0, True, None, resident, timeout_s)
        buf._allocate(_MIN_DATA_BYTES)
        return buf

    def _release_regions(self) -> None:
        for p in self._opened:
            _kernels.ipc_close(p)
        for p in self._own:
            _kernels.peer_free(p)
        self._opened, self._own = [], []
        self.table = None

    def _allocate(self, data_bytes: int) -> None:
        """(Re)allocate every region with room for ``data_bytes`` of rows;
        collective for a group.  Waits for this card's work first: once
        this rank's last K7 call has finished, no peer touches its old
        region again (their stores into it preceded the flags that call
        waited for)."""
        nbytes = self._data_off + data_bytes
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            self._release_regions()
            if self.loopback:
                self._own = [_kernels.peer_alloc(nbytes)
                             for _ in range(self.world)]
                ptrs = list(self._own)
            else:
                mine = _kernels.peer_alloc(nbytes)
                self._own = [mine]
                handles = (_gather(self.group, _kernels.ipc_handle(mine))
                           if self.world > 1 else [None])
                ptrs = [mine if r == self.rank else _kernels.ipc_open(h)
                        for r, h in enumerate(handles)]
                self._opened = [p for r, p in enumerate(ptrs)
                                if r != self.rank]
            self.table = torch.tensor(ptrs, dtype=torch.int64,
                                      device=self.device)
        self.data_bytes = data_bytes
        self.epoch = 0

    def prepare(self, sub: int, block: int,
                nranks: int = 1) -> Tuple[int, int, int]:
        """Before a K7 launch over [world, sub] rows of ``block``: raise a
        failed earlier launch, grow the regions if the rows do not fit,
        take the next epoch.  Returns (epoch, byte offset of the scales in
        a region, grid)."""
        if self.table is None:
            raise RuntimeError("these peer buffers are closed")
        self.check_error()
        nblk = sub // block
        scales_rel = _align(self.world * sub)
        need = scales_rel + 4 * self.world * nblk
        if need > self.data_bytes:
            self._allocate(max(need, 2 * self.data_bytes))
        self.epoch = (self.epoch + 1) & 0xFFFFFFFF
        cap = self._grid_cap // nranks if self.loopback else self._grid_cap
        grid = max(1, min(_kernels.fused_rs_units(sub, block), cap,
                          self._max_ctas))
        return self.epoch, self._data_off + scales_rel, grid

    def check_error(self) -> None:
        """Raise if a K7 launch on these buffers timed out (reads the
        mapped host word; waits for nothing)."""
        code = ctypes.c_int.from_address(self._err_host).value
        if code:
            raise RuntimeError(
                f"fused reduce-scatter: {_ERRORS.get(code, code)} within "
                f"{self.timeout_s:g} s; the group's peer memory is unusable")

    def check(self) -> None:
        """Wait for this card's work, then raise a timed-out launch."""
        torch.cuda.synchronize(self.device)
        self.check_error()

    def close(self) -> None:
        if self._err_host is None:
            return
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            self._release_regions()
            _kernels.host_free(self._err_host)
        self._err_host = None


def register(pg, buffers: PeerBuffers) -> None:
    _registry[id(pg)] = (pg, buffers)


def unregister(pg) -> Optional[PeerBuffers]:
    entry = _registry.pop(id(pg), None)
    return entry[1] if entry is not None and entry[0] is pg else None


def lookup(group=None) -> Optional[PeerBuffers]:
    """The peer buffers of ``group`` (None: the default group), if it has
    any."""
    if group is None:
        if not dist.is_initialized():
            return None
        group = dist.group.WORLD
    entry = _registry.get(id(group))
    return entry[1] if entry is not None and entry[0] is group else None


def require(group=None) -> PeerBuffers:
    buf = lookup(group)
    if buf is None:
        raise RuntimeError(
            "the fused reduce-scatter (K7) needs the group's CUDA peer "
            "memory, and this group has none: it is not an NCCL group "
            "made by collective.init_collective_group, or some pair of its "
            "ranks cannot map each other's memory (one card twice, a card "
            "a rank cannot see, no P2P access)")
    return buf
