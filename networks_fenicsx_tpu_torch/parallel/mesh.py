"""The single-controller shard mesh: the counterpart of ``jax.sharding.Mesh``
with ``psum``/``pmin`` and the host pull of sharded outputs.

A mesh holds the D shards of one edge axis in order, each with its
``torch.device``.  A device may repeat: ``["cuda:0"] * 8`` runs eight
shards on one card, ``["cpu"] * 8`` is what the tests use.  Without a
``torch.distributed`` process group the process owns every shard; under one
(:func:`.multihost.ensure_distributed`) rank ``r`` of ``W`` owns the
contiguous shards ``[r·D/W, (r+1)·D/W)`` and the collectives run over the
group (CPU tensors under gloo).

* :meth:`ShardMesh.stack` puts the owned shards' partials in one
  ``(n_owned, n)`` tensor on the first owned shard's device (peer copies
  when the devices differ);
* :meth:`ShardMesh.reduce`, :meth:`ShardMesh.reduce_placed` — K22-reduce
  (:mod:`..kernels.shard_top`) over them, then, under a process group, one
  ``all_reduce``: the ``psum``;
* :meth:`ShardMesh.all_finite` — the finiteness ``pmin``;
* :meth:`ShardMesh.replicate` — a replicated stage, run once per distinct
  device of the owned shards (so once per rank under a process group);
* :meth:`ShardMesh.gather` — the shards' outputs on the host, all-gathered
  across ranks (the counterpart of ``process_allgather``, ``_to_host``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import shard_top

__all__ = ["ShardMesh", "default_devices"]


def _group():
    """``(rank, world size)`` of the active process group, or None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def default_devices() -> list[torch.device]:
    """Every visible CUDA device (per process under a process group); raise
    without one — the sharded solver never carries on on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=['cpu'] * D to shard over the CPU "
            "with the kernels' plain PyTorch versions"
        )
    local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    group = _group()
    return local if group is None else local * group[1]


class ShardMesh:
    """D shards over ``devices`` along one named axis (see the module docs)."""

    def __init__(self, devices, axis_name: str = "edges"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        for dev in self.devices:
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available for the mesh's CUDA devices")
            if dev.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {dev}")
        self.axis_name = axis_name
        D = len(self.devices)
        group = _group()
        if group is None:
            self.rank, self.world = 0, 1
        else:
            self.rank, self.world = group
            if D % self.world:
                raise ValueError(f"{D} shards do not divide over {self.world} processes")
        per = D // self.world
        self.owned = range(self.rank * per, (self.rank + 1) * per)

    # -------------------------------------------------------------- layout
    @property
    def D(self) -> int:
        return len(self.devices)

    @property
    def distributed(self) -> bool:
        return self.world > 1

    @property
    def home(self) -> torch.device:
        """The first owned shard's device: where the reduces run."""
        return self.devices[self.owned[0]]

    @property
    def local_devices(self) -> tuple:
        """The distinct devices of the owned shards, in shard order."""
        return tuple(dict.fromkeys(self.devices[d] for d in self.owned))

    # ---------------------------------------------------------- collectives
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        if dist.get_backend() == "gloo" and t.device.type != "cpu":
            host = t.cpu()
            dist.all_reduce(host, op=op)
            return host.to(t.device)
        dist.all_reduce(t, op=op)
        return t

    def stack(self, parts) -> torch.Tensor:
        """The owned shards' ``(n,)`` partials as one ``(n_owned, n)`` tensor
        on :attr:`home`."""
        home = self.home
        return torch.stack([p.to(home) for p in parts])

    def reduce(self, stacked: torch.Tensor, n: int | None = None, offset: int = 0,
               plain: bool = False) -> torch.Tensor:
        """``Σ_d`` over all D shards of columns ``[offset, offset + n)``."""
        fn = shard_top.reduce_plain if plain else shard_top.reduce
        out = fn(stacked, n, offset)
        if self.distributed:
            import torch.distributed as dist

            out = self._all_reduce(out, dist.ReduceOp.SUM)
        return out

    def reduce_placed(self, stacked: torch.Tensor, C: int, h: int, nx: int, ny: int,
                      plain: bool = False) -> torch.Tensor:
        """The strip windows of all D shards placed and summed: ``(C, ny, nx)``."""
        fn = shard_top.reduce_placed_plain if plain else shard_top.reduce_placed
        out = fn(stacked, self.owned.start, C, h, nx, ny)
        if self.distributed:
            import torch.distributed as dist

            out = self._all_reduce(out, dist.ReduceOp.SUM)
        return out

    def all_finite(self, flags, plain: bool = False) -> bool:
        """Whether every shard's finiteness flag holds (the ``pmin``)."""
        st = torch.stack([torch.as_tensor(f).to(self.home).to(torch.int32).reshape(())
                          for f in flags])
        m = (shard_top.all_finite_plain if plain else shard_top.all_finite)(st)
        if self.distributed:
            import torch.distributed as dist

            m = self._all_reduce(m.reshape(1), dist.ReduceOp.MIN)
        return bool(int(m.reshape(-1)[0]) > 0)

    def replicate(self, fn, *tensors) -> dict:
        """``{device: fn(*tensors on device)}`` over :attr:`local_devices`: a
        replicated stage, run once per distinct device."""
        return {dev: fn(*(t.to(dev) for t in tensors)) for dev in self.local_devices}

    def gather(self, parts) -> np.ndarray:
        """The owned shards' equally shaped outputs, all D of them on the host
        as ``(D, ...)`` (all-gathered under a process group)."""
        local = torch.stack([p.detach().cpu() for p in parts])
        if not self.distributed:
            return local.numpy()
        import torch.distributed as dist

        if dist.get_backend() != "gloo":  # NCCL gathers device tensors
            local = local.to(self.home)
        out = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(out, local)
        return torch.cat(out).cpu().numpy()
