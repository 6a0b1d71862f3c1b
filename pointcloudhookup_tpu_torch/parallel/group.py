"""The collectives of the sharded step, over a torch.distributed group.

Counterpart of the mesh axis that ``pointcloudhookup_tpu/parallel/
sharded.py`` names in ``shard_map`` (``AXIS``, the functions'
``axis_name``): each JAX collective is one call on a ``Group``.

  ==================  ==========================================
  JAX                 Group
  ==================  ==========================================
  ``lax.psum``        ``all_reduce(t, "sum")`` (``all_reduce``)
  ``lax.pmin/pmax``   ``all_reduce(t, "min" / "max")``
  ``lax.all_gather``  ``all_gather(t)`` -> [size, *t.shape]
  ``lax.ppermute``    ``shift(t, +1 / -1)``: send to the ring
                      neighbour, receive from the other one
                      (``batch_isend_irecv``); zeros where no rank
                      sends, as ppermute gives unpaired devices
  ``lax.axis_index``  ``rank``
  ==================  ==========================================

Every call carries a fixed-shape tensor and returns a new one, as the JAX
collectives do.  Boolean tensors travel as uint8.  Over gloo every
collective on a CUDA tensor is staged through host memory inside the call
(gloo's send/recv of a CUDA tensor aborts the rank: it writes the device
pointer to its socket), so several ranks can share one card over gloo
while every kernel still runs on it.  Each call adds one to the tracer's
counter ``collective.<name>`` (``utils/trace.py``; name ``psum``, ``pmin``,
``pmax``, ``all_gather`` or ``ppermute``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pointcloudhookup_tpu_torch.utils import trace

_REDUCE = {
    "sum": ("psum", dist.ReduceOp.SUM),
    "min": ("pmin", dist.ReduceOp.MIN),
    "max": ("pmax", dist.ReduceOp.MAX),
}


class Group:
    """A process group with the sharded step's collectives (see the module
    docstring).  ``pg`` defaults to the default (world) group."""

    def __init__(self, pg=None):
        self.pg = dist.group.WORLD if pg is None else pg
        self.rank = dist.get_rank(self.pg)
        self.size = dist.get_world_size(self.pg)
        self.backend = str(dist.get_backend(self.pg))

    def all_reduce(self, t, op: str):
        """psum / pmin / pmax of ``t`` over the ranks (op "sum", "min" or
        "max")."""
        name, red = _REDUCE[op]

        def run(x):
            x = x.clone()
            dist.all_reduce(x, red, group=self.pg)
            return x

        return self._call(name, t, run)

    def all_gather(self, t):
        """Every rank's ``t``, stacked in rank order: [size, *t.shape]."""

        def run(x):
            x = x.reshape(-1).contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.pg)
            return torch.stack(parts).reshape((self.size,) + tuple(t.shape))

        return self._call("all_gather", t, run)

    def shift(self, t, offset: int):
        """ppermute over the ring: rank r sends ``t`` to r + offset and
        receives from r - offset; a rank that no rank sends to gets zeros."""

        def run(x):
            x = x.contiguous()
            out = torch.zeros_like(x)
            ops = []
            dst, src = self.rank + offset, self.rank - offset
            if 0 <= dst < self.size:
                ops.append(dist.P2POp(dist.isend, x, self._peer(dst), self.pg))
            if 0 <= src < self.size:
                ops.append(dist.P2POp(dist.irecv, out, self._peer(src), self.pg))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return out

        return self._call("ppermute", t, run)

    def _peer(self, group_rank: int) -> int:
        """The global rank that P2P calls address."""
        if self.pg is dist.group.WORLD:
            return group_rank
        return dist.get_global_rank(self.pg, group_rank)

    def _call(self, name: str, t, run):
        trace.count("collective." + name)
        is_bool = t.dtype == torch.bool
        x = t.to(torch.uint8) if is_bool else t
        staged = x.is_cuda and self.backend == "gloo"
        out = run(x.cpu()).to(x.device) if staged else run(x)
        return out.to(torch.bool) if is_bool else out
