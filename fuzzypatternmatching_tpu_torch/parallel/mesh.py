"""A 1-D mesh of shards in one process, and the collectives over it.

The counterpart of ``jax.sharding.Mesh(devices, ("x",))`` together with the
``lax`` collectives the multi-device plane uses (``all_to_all``, ``psum``,
``pmax``, ``pmin``, ``all_gather``). The JAX package runs one ``shard_map``
program per shard from one controller; here the same per-shard code runs shard after shard in one
Python process, and the collectives are tensor moves between the shards'
tensors. A shard lives on a torch device, and several shards may share one
(the counterpart of the virtual CPU devices the JAX tests use): n shards on
one card run the plane with its real halo lists.

This class is the one place a multi-process backend (``torch.distributed``,
one process per card) would replace.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch


class Mesh:
    """``devices``: the torch device of each shard, in shard order (a device
    may repeat)."""

    def __init__(self, devices: Sequence[torch.device | str]):
        if len(devices) == 0:
            raise ValueError("a mesh needs at least one shard")
        self.devices = [torch.device(d) for d in devices]
        for d in self.devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {d}: no CUDA device is available")
        self.n = len(self.devices)
        # every shard on one device: a batch of sends is one tensor and the
        # exchange one transpose
        self.one_device = len(set(self.devices)) == 1

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def all_to_all(self, sends: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``sends[s]`` is shard s's [n, K, ...] buffer, row d bound for
        shard d. Shard d receives row d of every shard, stacked in shard
        order: ``out[d][s] == sends[s][d]`` (``jax.lax.all_to_all`` with
        split_axis = concat_axis = 0)."""
        n = self.n
        if len(sends) != n or any(x.shape[0] != n for x in sends):
            raise ValueError(f"all_to_all: needs {n} buffers of leading size {n}")
        if self.one_device:
            return list(torch.stack(list(sends)).transpose(0, 1).contiguous().unbind(0))
        return [
            torch.stack([sends[s][d].to(self.devices[d]) for s in range(n)])
            for d in range(n)
        ]

    def all_to_all_ragged(
        self, sends: Sequence[Sequence[torch.Tensor]]
    ) -> list[torch.Tensor]:
        """Ragged exchange: ``sends[s][d]`` is what shard s sends to shard
        d, any length along dim 0. Shard d receives the concatenation of
        ``sends[s][d]`` over s, in shard order (the token routing of the
        mesh NLCC; the JAX package pads each to a fixed capacity for one
        ``all_to_all``)."""
        n = self.n
        if len(sends) != n or any(len(x) != n for x in sends):
            raise ValueError(f"all_to_all_ragged: needs {n} lists of {n} tensors")
        return [
            torch.cat([sends[s][d].to(self.devices[d]) for s in range(n)])
            for d in range(n)
        ]

    def _reduce(self, values: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
        if len(values) != self.n:
            raise ValueError(f"collective: needs {self.n} values")
        total = values[0]
        for v in values[1:]:
            total = op(total, v.to(total.device))
        if self.one_device:
            return [total] * self.n
        return [total.to(d) for d in self.devices]

    def psum(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The sum of the shards' values, on every shard."""
        return self._reduce(values, torch.add)

    def pmax(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise maximum of the shards' values, on every shard."""
        return self._reduce(values, torch.maximum)

    def pmin(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise minimum of the shards' values, on every shard."""
        return self._reduce(values, torch.minimum)

    def all_gather(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard's value concatenated in shard order along dim 0, on
        every shard (``jax.lax.all_gather(..., tiled=True)``)."""
        if len(values) != self.n:
            raise ValueError(f"all_gather: needs {self.n} values")
        if self.one_device:
            return [torch.cat(list(values))] * self.n
        return [torch.cat([v.to(d) for v in values]) for d in self.devices]
