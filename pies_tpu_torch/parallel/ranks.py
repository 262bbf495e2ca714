"""Ranks: the port's counterpart of the JAX package's device mesh
(``pies_tpu/parallel/ensemble.py:77`` ``make_mesh``) over
``torch.distributed`` processes, and the collectives that the domain
decomposition and the sharded ensembles issue across them.

* :func:`make_mesh` reads this process's rank, the world size and the
  backend of a process group into a :class:`Mesh`, with the rank's device:
  ``cuda:{local_rank % device_count}`` unless the caller names one.
* :func:`launch` starts R processes (``torch.multiprocessing``, start
  method ``spawn``), each of which joins one group at a ``FileStore`` under a
  directory the caller gives (never a TCP port: test workers run side by
  side), runs ``fn`` and leaves its result in that directory.
* :class:`Transport` moves the values of one exchange: the halo bands
  between neighbouring ranks (``batch_isend_irecv``), the CG's block
  partials gathered in rank order (``all_gather_into_tensor``, in place),
  and the latch and the fleet's diagnostics (``all_reduce``).  Every rank
  issues the same collectives in the same order; none of them depends on a
  value read back from the device.

The transport is picked by the group's backend.  NCCL takes CUDA tensors
and orders its collectives on the stream.  Gloo takes CPU tensors, and on
CUDA tensors (one card, several ranks: NCCL refuses two ranks on one
device) it takes ``all_gather_into_tensor`` and ``all_reduce`` but refuses
point-to-point sends (``scripts/gloo_cuda_probe.py`` on an H100), so the
bands alone are staged through pinned host buffers there: the device's
stream is synchronised, the bands copied to the host, exchanged, and copied
back on the stream.  Nothing falls back at run time.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's place in a process group: the JAX ``Mesh`` of one axis,
    read from ``torch.distributed``."""

    rank: int
    world: int
    group: object  # the ProcessGroup, or None for the default group
    device: torch.device
    backend: str

    @property
    def left(self) -> int | None:
        """The rank before this one, None for rank 0."""
        return self.rank - 1 if self.rank > 0 else None

    @property
    def right(self) -> int | None:
        """The rank after this one, None for the last."""
        return self.rank + 1 if self.rank + 1 < self.world else None

    def share(self, n: int, what: str) -> slice:
        """This rank's contiguous share of ``n`` items (members, slabs);
        raises unless the world size divides ``n``, as a JAX mesh axis
        must divide the axis it shards."""
        if n % self.world:
            raise ValueError(f"{self.world} ranks do not divide {n} {what}")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)


def make_mesh(group=None, device=None) -> Mesh:
    """This process's :class:`Mesh` in ``group`` (the default group when
    None), after ``torch.distributed.init_process_group``.  The device is
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``, else the rank)
    unless ``device`` is given (``"cpu"`` for the plain twins); a CUDA
    device becomes the process's current one, whose stream the kernels
    launch on."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(rank=rank, world=world, group=group, device=device,
                backend=str(dist.get_backend(group)))


def _entry(index, fn, world, backend, store, out, timeout, args):
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=index,
                            world_size=world, timeout=timedelta(seconds=timeout))
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out, f"result.{index}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, backend: str, *args, store_dir: str, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes (start method
    ``spawn``), each rank of one ``backend`` group whose rendezvous is a
    new ``FileStore`` file under ``store_dir``; returns the ranks' results
    in rank order (each saved with ``torch.save`` under ``store_dir``).
    ``fn`` must be importable by name (a module's function).  A rank that
    raises ends the others, and the error is raised here
    (``torch.multiprocessing.ProcessRaisedException``)."""
    import torch.multiprocessing as mp

    tag = uuid.uuid4().hex
    store = os.path.join(store_dir, f"rendezvous.{tag}")
    out = os.path.join(store_dir, f"results.{tag}")
    os.makedirs(out)
    mp.start_processes(_entry, args=(fn, world, backend, store, out, timeout, args),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(out, f"result.{r}.pt"), weights_only=False)
            for r in range(world)]


class Transport:
    """The collectives of one :class:`Mesh` (see the module docstring):
    ``exchange`` for the halo bands, ``gather_``/``gather`` for the block
    partials and the ensemble's members, ``all_reduce_`` for the latch and
    the diagnostics.  ``calls`` counts the collectives issued."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.rank, self.world = mesh, mesh.rank, mesh.world
        # Gloo refuses point-to-point sends of CUDA tensors (and takes its
        # gathers and reductions: scripts/gloo_cuda_probe.py), so there the
        # bands go through the host.
        self.stage = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self._host: dict = {}
        self.calls = 0

    def _peer(self, r: int) -> int:
        g = self.mesh.group
        return r if g is None else dist.get_global_rank(g, r)

    def _buffer(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped as ``like``, kept for reuse (every
        staged exchange starts by synchronising the stream, so the last
        one's copies out of it have finished)."""
        buf = self._host.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def _sync(self):
        torch.cuda.current_stream(self.mesh.device).synchronize()

    def exchange(self, to_left: torch.Tensor, to_right: torch.Tensor):
        """Send ``to_left`` to the rank before and ``to_right`` to the rank
        after; returns ``(from_left, from_right)``, what they sent this way
        (each shaped as the band sent the other way), None where there is
        no neighbour: the two ``ppermute``s of ``_halo_refresh`` and
        ``_halo_reduce`` between ranks."""
        m = self.mesh
        if m.world == 1:
            return None, None
        self.calls += 1
        stage = self.stage
        if stage:
            self._sync()
        sends, recvs = [], []
        for side, peer, band in (("left", m.left, to_left), ("right", m.right, to_right)):
            if peer is None:
                recvs.append(None)
                continue
            out = band.contiguous()
            into = torch.empty_like(out)
            if stage:
                out = self._buffer(("send", side), out).copy_(out)
                into = self._buffer(("recv", side), into)
            sends.append(dist.P2POp(dist.isend, out, self._peer(peer), m.group))
            sends.append(dist.P2POp(dist.irecv, into, self._peer(peer), m.group))
            recvs.append(into)
        for req in dist.batch_isend_irecv(sends):
            req.wait()
        if stage:
            recvs = [None if h is None else h.to(m.device, non_blocking=True) for h in recvs]
        return recvs[0], recvs[1]

    def gather_(self, buf: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's ``n`` leading-axis rows of ``buf`` (R·n rows, this
        rank's at ``rank·n``) gathered in place, in rank order."""
        if self.world == 1:
            return buf
        self.calls += 1
        mine = slice(self.rank * n, (self.rank + 1) * n)
        dist.all_gather_into_tensor(buf, buf[mine], group=self.mesh.group)
        return buf

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along the leading axis, in rank
        order (a new tensor)."""
        if self.world == 1:
            return t
        out = torch.empty((self.world * t.shape[0],) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        out[self.rank * t.shape[0]:(self.rank + 1) * t.shape[0]] = t
        return self.gather_(out, t.shape[0])

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ranks by ``op``, in place."""
        if self.world == 1:
            return t
        self.calls += 1
        dist.all_reduce(t, op, group=self.mesh.group)
        return t
