"""A 1-D mesh of shards, and the collectives over it.

The counterpart of ``jax.sharding.Mesh(devices, ("x",))`` together with the
``lax`` collectives the multi-device plane uses (``all_to_all``, ``psum``,
``pmax``, ``pmin``, ``all_gather``). The JAX package runs one ``shard_map``
program per shard; here the same per-shard code runs shard after shard in
each Python process, and every collective takes and returns the lists of
this process's own (local) shards' tensors.

* **One process** (``group=None``): the process holds every shard, and the
  collectives are tensor moves between the shards' tensors. A shard lives
  on a torch device, and several shards may share one (the counterpart of
  the virtual CPU devices the JAX tests use): n shards on one card run the
  plane with its real halo lists.
* **Several processes** (a ``torch.distributed`` group of P processes): each
  process holds a contiguous run of the global shards, in process order
  (host-major, as the JAX package's ``build_mesh`` sorts its devices by
  ``(process_index, id)``), all on one device of its own. Within the process
  the shards' tensors are moved as above; across processes each collective
  is one ``torch.distributed`` call on the process's concatenated shards:
  ``all_to_all_single`` (the ragged form after an exchange of sizes),
  ``all_reduce`` and ``all_gather`` (padded to the longest process). The
  backend is the group's: gloo for CPU shards and for processes that share
  one card (gloo takes CUDA tensors in every one of these calls), NCCL for
  one process per card (it refuses two processes on one card).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.distributed as dist


class Mesh:
    """``devices``: the torch device of each of this process's shards, in
    shard order (a device may repeat). ``group``: the process group the
    mesh spans; None, or a group of one process, keeps every shard in this
    process. ``two_d``: label the shards as the JAX package's ("host",
    "chip") grid, one row per process (the collectives are the same)."""

    def __init__(
        self, devices: Sequence[torch.device | str], group=None, two_d: bool = False,
    ):
        if len(devices) == 0:
            raise ValueError("a mesh needs at least one shard")
        self.devices = [torch.device(d) for d in devices]
        for d in self.devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {d}: no CUDA device is available")
        # every local shard on one device: a batch of sends is one tensor
        # and the exchange one transpose
        self.one_device = len(set(self.devices)) == 1
        self.group = group if group is not None and dist.get_world_size(group) > 1 else None
        # bytes of this process's data that the collectives delivered to
        # other processes, once per receiving process
        self.cross_bytes = 0
        if self.group is None:
            self.processes, self.process_index = 1, 0
            self.counts = [len(self.devices)]
        else:
            if not self.one_device:
                raise ValueError(
                    f"a mesh across processes keeps each process's shards on one "
                    f"device, not {sorted(set(map(str, self.devices)))}"
                )
            self.processes = dist.get_world_size(self.group)
            self.process_index = dist.get_rank(self.group)
            self.counts = self._gather_sizes(len(self.devices))
        # this process's shards are the global shards [first, first + local)
        self.first = sum(self.counts[: self.process_index])
        self.local = len(self.devices)
        self.n = sum(self.counts)
        if two_d:
            if len(set(self.counts)) != 1:
                raise ValueError(f"a 2-D mesh needs as many shards in every process: {self.counts}")
            self.axis_names, self.shape = ("host", "chip"), (self.processes, self.counts[0])
        else:
            self.axis_names, self.shape = ("x",), (self.n,)

    def __repr__(self) -> str:
        if self.group is None:
            return f"Mesh({[str(d) for d in self.devices]})"
        return (f"Mesh(process {self.process_index} of {self.processes}: shards "
                f"{self.first}..{self.first + self.local - 1} of {self.n} on {self.devices[0]}, "
                f"{dist.get_backend(self.group)})")

    @property
    def spans_processes(self) -> bool:
        """Whether the mesh's shards are held by more than one process."""
        return self.group is not None

    @property
    def shard_ids(self) -> range:
        """The global ids of this process's shards, in ``devices`` order."""
        return range(self.first, self.first + self.local)

    # ------------------------------------------------------ across processes

    def _gather_sizes(self, size: int) -> list[int]:
        """Every process's ``size``, in process order."""
        t = torch.tensor([size], dtype=torch.int64, device=self.devices[0])
        out = [torch.empty_like(t) for _ in range(self.processes)]
        dist.all_gather(out, t, group=self.group)
        self.cross_bytes += t.nbytes * (self.processes - 1)
        return torch.cat(out).tolist()

    def _exchange(self, x: torch.Tensor, in_rows: list[int], out_rows: list[int]) -> torch.Tensor:
        """``all_to_all_single``: ``x``'s rows in consecutive runs of
        ``in_rows[q]`` to process q; returns the runs of ``out_rows[p]``
        rows from each process p, in process order."""
        out = x.new_empty((sum(out_rows),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), out_rows, in_rows, group=self.group)
        row_bytes = x[:1].nbytes if x.shape[0] else 0
        self.cross_bytes += row_bytes * (sum(in_rows) - in_rows[self.process_index])
        return out

    # ------------------------------------------------------------ collectives

    def all_to_all(self, sends: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``sends[s]`` is local shard s's [n, K, ...] buffer, row d bound
        for global shard d. Local shard d receives row d of every shard,
        stacked in global shard order: ``out[d][s] == sends[s][d]``
        (``jax.lax.all_to_all`` with split_axis = concat_axis = 0)."""
        n, loc = self.n, self.local
        if len(sends) != loc or any(x.shape[0] != n for x in sends):
            raise ValueError(f"all_to_all: needs {loc} buffers of leading size {n}")
        if self.group is not None:
            # rows grouped by destination shard (so by process), then source
            x = torch.stack(list(sends)).transpose(0, 1).reshape((n * loc,) + sends[0].shape[1:])
            # loc rows to each of process q's c shards, and loc from each of them
            rows = [loc * c for c in self.counts]
            blocks = self._exchange(x, rows, rows).split(rows)
            return list(torch.cat(
                [b.view((loc, c) + b.shape[1:]) for b, c in zip(blocks, self.counts)], dim=1
            ).unbind(0))
        if self.one_device:
            return list(torch.stack(list(sends)).transpose(0, 1).contiguous().unbind(0))
        return [
            torch.stack([sends[s][d].to(self.devices[d]) for s in range(n)])
            for d in range(n)
        ]

    def all_to_all_ragged(
        self, sends: Sequence[Sequence[torch.Tensor]]
    ) -> list[torch.Tensor]:
        """Ragged exchange: ``sends[s][d]`` is what local shard s sends to
        global shard d, any length along dim 0. Local shard d receives the
        concatenation of ``sends[s][d]`` over the global s, in shard order
        (the token routing of the mesh NLCC; the JAX package pads each to a
        fixed capacity for one ``all_to_all``)."""
        n, loc = self.n, self.local
        if len(sends) != loc or any(len(x) != n for x in sends):
            raise ValueError(f"all_to_all_ragged: needs {loc} lists of {n} tensors")
        if self.group is not None:
            dev = self.devices[0]
            sizes = [torch.tensor([t.shape[0] for t in x], dtype=torch.int64, device=dev)
                     for x in sends]
            # got[d][s]: the length shard s sends to local shard d
            got = torch.stack(self.all_to_all(sizes)).tolist()
            # runs to process q: for each local source, its pieces for q's shards
            pieces, in_rows, lo = [], [], 0
            for c in self.counts:
                pieces += [x[d] for x in sends for d in range(lo, lo + c)]
                in_rows.append(sum(int(x[d].shape[0]) for x in sends for d in range(lo, lo + c)))
                lo += c
            out_rows, lo = [], 0
            for c in self.counts:
                out_rows.append(sum(got[d][s] for s in range(lo, lo + c) for d in range(loc)))
                lo += c
            out = self._exchange(torch.cat(pieces), in_rows, out_rows)
            # the run from process p is ordered (source s of p, local d)
            order = [(s, d) for s in range(n) for d in range(loc)]
            parts = dict(zip(order, out.split([got[d][s] for s, d in order])))
            return [torch.cat([parts[s, d] for s in range(n)]) for d in range(loc)]
        return [
            torch.cat([sends[s][d].to(self.devices[d]) for s in range(n)])
            for d in range(n)
        ]

    def _reduce(self, values: Sequence[torch.Tensor], op, dist_op) -> list[torch.Tensor]:
        if len(values) != self.local:
            raise ValueError(f"collective: needs {self.local} values")
        total = values[0]
        for v in values[1:]:
            total = op(total, v.to(total.device))
        if self.group is not None:
            # all_reduce works in place: one local shard's total is its own tensor
            total = total.clone() if self.local == 1 else total
            dist.all_reduce(total, op=dist_op, group=self.group)
            self.cross_bytes += total.nbytes * (self.processes - 1)
        if self.one_device:
            return [total] * self.local
        return [total.to(d) for d in self.devices]

    def psum(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The sum of the shards' values, on every local shard."""
        return self._reduce(values, torch.add, dist.ReduceOp.SUM)

    def pmax(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise maximum of the shards' values, on every local shard."""
        return self._reduce(values, torch.maximum, dist.ReduceOp.MAX)

    def pmin(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The elementwise minimum of the shards' values, on every local shard."""
        return self._reduce(values, torch.minimum, dist.ReduceOp.MIN)

    def all_gather(self, values: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard's value concatenated in global shard order along dim
        0, on every local shard (``jax.lax.all_gather(..., tiled=True)``)."""
        if len(values) != self.local:
            raise ValueError(f"all_gather: needs {self.local} values")
        if self.group is not None:
            mine = torch.cat([v.to(self.devices[0]) for v in values])
            rows = self._gather_sizes(mine.shape[0])
            top = max(rows)
            if mine.shape[0] < top:  # ragged: pad every process to the longest
                mine = torch.cat([mine, mine.new_zeros((top - mine.shape[0],) + mine.shape[1:])])
            out = [torch.empty_like(mine) for _ in range(self.processes)]
            dist.all_gather(out, mine.contiguous(), group=self.group)
            self.cross_bytes += mine.nbytes * (self.processes - 1)
            return [torch.cat([blk[:r] for blk, r in zip(out, rows)])] * self.local
        if self.one_device:
            return [torch.cat(list(values))] * self.n
        return [torch.cat([v.to(d) for v in values]) for d in self.devices]
