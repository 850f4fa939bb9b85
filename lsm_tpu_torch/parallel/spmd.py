"""An in-process mesh of torch devices: the counterpart of ``jax.shard_map``
and of the three collectives the JAX package's sharded paths use.

JAX drives a mesh of devices from one controller; its test suite runs the
mesh as 8 virtual CPU devices in one process. The port does the same with a
:class:`Mesh` of ``torch.device`` entries, where a device may repeat: four
shards on one card, ``["cuda:0"] * 4``, or eight on the CPU,
``["cpu"] * 8``. Distinct cards work the same way; a slab that moves between
them is a peer copy (``Tensor.to``), which PyTorch orders after the
sender's stream.

:func:`run` calls a local function once per shard, each in its own Python
thread, with :func:`axis_index`, :func:`ppermute` and :func:`pmin` working
inside it. A collective posts this shard's value and waits for the posts it
reads: its peer's (``ppermute``) or its group's (``pmin``), each behind its
own event. So the general path (terms and integrators that reach ghosts
through ``phi.pad``) runs unchanged per shard, in lockstep, each shard
blocking in its pad until its neighbours have posted. (A global barrier per
collective costs far more here: every wake-up is a hand-over of the
interpreter lock.)

- Grad mode is thread-local: :func:`run` copies the caller's into each
  shard's thread. A slab moves by ``clone`` (or ``to`` another device), so
  autograd's graph spans the shards and a backward needs no collective.
- Threads issue to one device's current stream, so a receiver's reads come
  after the sender's copy in stream order; a posted slab is a copy and is
  never written again.
- A shard that raises aborts the run: the others stop at their next wait,
  and :func:`run` re-raises the first shard's error in the caller. Every
  wait has a timeout (``timeout`` seconds for a post; after an abort, as
  long again for the shards still computing), so a shard that never
  arrives cannot hang the caller.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "run", "axis_index", "ppermute", "pmin", "DEFAULT_TIMEOUT"]

#: seconds a shard waits for a post at a collective before the run is aborted
DEFAULT_TIMEOUT = 600.0


class Mesh:
    """Devices laid out on named axes: ``devices`` a numpy object array of
    ``torch.device`` (its shape the mesh's), ``axis_names`` one name per
    axis. A device may appear more than once."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {devices.shape} needs {devices.ndim} axis names, "
                             f"got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names must differ, got {axis_names}")
        self.devices = np.empty(devices.shape, dtype=object)
        for c in np.ndindex(devices.shape):
            self.devices[c] = torch.device(devices[c])
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name to size, in order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every shard's coordinates, in row-major order."""
        return list(np.ndindex(self.devices.shape))

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def __repr__(self):
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({axes}; devices {devs})"


class _Aborted(RuntimeError):
    """Raised in a shard waiting at a collective when another shard has
    failed: the run is over."""


class _Comm:
    """The mailbox of one :func:`run`: the ``k``-th collective of every shard
    posts into slot ``k``; a shard waits only for the posts it reads (its
    peer's, or its group's), each behind its own event, and the last shard
    done with a slot frees it."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh, self.timeout = mesh, timeout
        self.lock = threading.Lock()
        self.slots: Dict[int, dict] = {}
        self.aborted = False

    def _slot(self, seq: int, what) -> dict:
        with self.lock:
            slot = self.slots.setdefault(seq, {"what": what, "posts": {}, "events": {},
                                               "done": 0})
            if slot["what"] != what:
                raise RuntimeError(f"shards issued different collectives at step {seq}: "
                                   f"{slot['what']} and {what}")
            return slot

    def _event(self, slot: dict, coord) -> threading.Event:
        with self.lock:
            ev = slot["events"].setdefault(coord, threading.Event())
            if self.aborted:
                ev.set()
            return ev

    def abort(self):
        with self.lock:
            self.aborted = True
            for slot in self.slots.values():
                for ev in slot["events"].values():
                    ev.set()

    def exchange(self, seq: int, coord, what, value, sources) -> dict:
        """Post ``value`` as ``coord``'s entry of collective ``seq`` (``what``
        names it) and return the entries of the shards ``sources``, waiting
        for each."""
        slot = self._slot(seq, what)
        slot["posts"][coord] = value
        self._event(slot, coord).set()
        got = {}
        for src in sources:
            if not self._event(slot, src).wait(self.timeout):
                self.abort()
                raise TimeoutError(f"shard {coord} waited {self.timeout} s for shard {src} "
                                   f"at collective {seq} ({what[0]})")
            if self.aborted:
                raise _Aborted("another shard failed")
            got[src] = slot["posts"][src]
        with self.lock:
            slot["done"] += 1
            if slot["done"] == self.mesh.size:
                del self.slots[seq]
        return got


_CTX = threading.local()


def _ctx():
    comm = getattr(_CTX, "comm", None)
    if comm is None:
        raise RuntimeError("a collective was called outside lsm_tpu_torch.parallel.spmd.run")
    return _CTX


def _axis(mesh: Mesh, name: str) -> int:
    if name not in mesh.axis_names:
        raise ValueError(f"unknown mesh axis {name!r}; the mesh has {mesh.axis_names}")
    return mesh.axis_names.index(name)


def _collective(what, value, sources):
    ctx = _ctx()
    seq = ctx.seq
    ctx.seq += 1
    return ctx.comm.exchange(seq, ctx.coord, what, value, sources)


def axis_index(name: str) -> int:
    """This shard's index along the mesh axis ``name`` (inside :func:`run`)."""
    ctx = _ctx()
    return ctx.coord[_axis(ctx.comm.mesh, name)]


def ppermute(x: torch.Tensor, name: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: along the mesh axis ``name``, the shard at index
    ``src`` sends ``x`` to the shard at ``dst`` for each ``(src, dst)`` of
    ``perm``; returns what this shard receives, on its device (zeros when
    nothing is sent to it)."""
    ctx = _ctx()
    mesh = ctx.comm.mesh
    a = _axis(mesh, name)
    me = ctx.coord
    src = [s for s, d in perm if d == me[a]]
    peers = [me[:a] + (s,) + me[a + 1:] for s in src[:1]]
    posts = _collective(("ppermute", name, tuple(perm)),
                        x.clone() if me[a] in dict(perm) else None, peers)
    dev = mesh.device(me)
    if not peers:
        return torch.zeros_like(x, device=dev)
    return posts[peers[0]].to(dev)


def pmin(x: torch.Tensor, names) -> torch.Tensor:
    """``jax.lax.pmin``: the elementwise minimum of ``x`` over the shards
    that differ from this one only along the mesh axes ``names``, on this
    shard's device (the same value on each of them)."""
    ctx = _ctx()
    mesh = ctx.comm.mesh
    names = (names,) if isinstance(names, str) else tuple(names)
    axes = {_axis(mesh, n) for n in names}
    me = ctx.coord
    group = [c for c in mesh.coords()
             if all(c[k] == me[k] for k in range(len(me)) if k not in axes)]
    posts = _collective(("pmin", names), x, group)
    dev = mesh.device(me)
    group = [posts[c] for c in group]
    out = group[0].to(dev)
    for v in group[1:]:
        out = torch.minimum(out, v.to(dev))
    return out


def run(mesh: Mesh, fn: Callable, timeout: Optional[float] = None) -> np.ndarray:
    """``fn(coord)`` once per shard of ``mesh``, each in its own thread, with
    the collectives of this module working inside it; returns the results
    in a numpy object array of the mesh's shape. The caller's grad mode
    holds in every shard. A shard's error is raised here (the first one, a
    note naming its shard); a shard that waits ``timeout`` seconds (default
    :data:`DEFAULT_TIMEOUT`) for a post aborts the run with
    ``TimeoutError``, also raised when a shard has not finished ``timeout``
    seconds after an abort."""
    timeout = DEFAULT_TIMEOUT if timeout is None else float(timeout)
    comm = _Comm(mesh, timeout)
    results = np.empty(mesh.devices.shape, dtype=object)
    errors = []
    done = threading.Condition()
    finished = [0]
    grad = torch.is_grad_enabled()

    def body(coord):
        _CTX.comm, _CTX.coord, _CTX.seq = comm, coord, 0
        try:
            with torch.set_grad_enabled(grad):
                results[coord] = fn(coord)
        except BaseException as e:  # handed to the caller below
            with done:
                errors.append((coord, e))
            comm.abort()
        finally:
            _CTX.comm = None
            with done:
                finished[0] += 1
                done.notify_all()

    threads = [threading.Thread(target=body, args=(c,), name=f"lsm-shard-{c}", daemon=True)
               for c in mesh.coords()]
    for th in threads:
        th.start()
    with done:
        while finished[0] < len(threads):
            if not done.wait(timeout) and (errors or comm.aborted):
                stuck = [th.name for th in threads if th.is_alive()]
                raise TimeoutError(f"shards {stuck} did not finish {timeout} s after the run "
                                   "was aborted")
    for th in threads:
        th.join()
    if errors:
        first = [(c, e) for c, e in errors if not isinstance(e, (_Aborted, TimeoutError))]
        coord, err = (first or [(c, e) for c, e in errors if not isinstance(e, _Aborted)]
                      or errors)[0]
        err.add_note(f"raised in shard {coord} of {mesh}")
        raise err
    return results
