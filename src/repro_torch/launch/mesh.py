"""Device meshes over ``torch.distributed`` ranks: the port of
``repro.launch.mesh`` and of the JAX package's ambient ``with mesh:``.

A ``Mesh`` is a grid of ranks with named axes, ("data", "model") or
("pod", "data", "model"); rank r sits at the row-major coordinates of r
(``rank = d * model + m`` on a 2-D mesh, the order of ``jax.make_mesh``'s
devices).  Each rank builds the same ``Mesh``: the process group of every
axis and of the data axes together (``dist.new_subgroups_by_enumeration``,
each with the mesh's timeout), its own coordinates and its device,
``cuda:{rank % device_count}`` or the CPU when asked.  ``MeshShape`` is
the same grid without ranks, which is all the sharding rules read.

The collectives the sharded ops place (``distributed/shard_fused.py``) go
through the mesh's methods, which count them and their host seconds
(``stats``).  A cross-shard sum is ``ordered_sum``: an all-gather of the
partials, added in rank order, so it is bitwise the k-split oracle on any
backend and at any world size (no backend ``all_reduce(SUM)`` fixes its
order).

The backend is ``nccl`` when every rank owns a card of its own, and
``gloo`` when ranks share a card (NCCL refuses two ranks of one
communicator on one device) or run on the CPU.  gloo takes CUDA tensors
in every collective the port uses (``GLOO_CUDA_COLLECTIVES``, checked on
torch 2.11 with CUDA 12.8 on an H100), so no collective is staged through
the host.  ``spawn`` starts the ranks with ``torch.multiprocessing`` and a
``FileStore`` (a file in a temporary directory; gloo's pairs connect over
the loopback device), joins them against a deadline and kills the rest
when one fails or the deadline passes.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")
# The collectives the port calls, each taking CUDA tensors under gloo.
GLOO_CUDA_COLLECTIVES = ("all_gather", "all_reduce")

_CURRENT: list = []     # the ambient meshes, innermost last


class MeshShape:
    """Axis names and sizes of a mesh, without ranks: what the sharding
    rules read (``shape``, ``axis_names``, ``size``)."""

    def __init__(self, sizes, axis_names=None):
        sizes = tuple(int(s) for s in sizes)
        if axis_names is None:
            axis_names = AXES_3D if len(sizes) == 3 else AXES_2D
        if len(axis_names) != len(sizes) or "model" not in axis_names:
            raise ValueError(f"mesh axes {axis_names} for sizes {sizes}: want ('data', "
                             f"'model') or ('pod', 'data', 'model')")
        self.axis_names = tuple(axis_names)
        self.sizes = sizes

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def data_axes(self) -> tuple:
        """The non-"model" axes, in order."""
        return tuple(a for a in self.axis_names if a != "model")

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _as_tuple(axes))

    @property
    def data_size(self) -> int:
        return self.axes_size(self.data_axes)

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    def coords_of(self, rank: int) -> dict:
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % size
            rank //= size
        return {a: out[a] for a in self.axis_names}

    def __repr__(self):
        return "Mesh(" + ", ".join(f"{a} {s}" for a, s in self.shape.items()) + ")"


def _as_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def choose_backend(world: int, device: str) -> tuple[str, str]:
    """(backend, why): ``nccl`` when every rank owns a card of its own, else
    ``gloo``."""
    if device == "cpu":
        return "gloo", f"{world} ranks on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} ranks, a card each of {cards}"
    return "gloo", (f"{world} ranks share {cards} card(s) (NCCL refuses two ranks of one "
                    f"communicator on one device); gloo takes CUDA tensors in "
                    f"{', '.join(GLOO_CUDA_COLLECTIVES)}, so nothing is staged through the host")


class Mesh(MeshShape):
    """This rank's view of a mesh over the initialised default process
    group: its coordinates, its device, and the process group of each
    axis set the collectives run over.  ``with mesh:`` makes it the ambient
    mesh (``current_mesh``), with the batch split over the data axes (a
    mesh of one data rank, (1, M), is pure tensor parallelism)."""

    def __init__(self, sizes, axis_names=None, *, device=None,
                 timeout: float = 600.0):
        super().__init__(sizes, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised process group (launch.mesh.spawn)")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"{self!r} needs {self.size} ranks, the world has "
                               f"{dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        if device is None:
            device = (f"cuda:{self.rank % torch.cuda.device_count()}"
                      if torch.cuda.is_available() else "cpu")
        self.device = torch.device(device)
        self.timeout = timeout
        self._groups = {}
        wanted = [(a,) for a in self.axis_names]
        if len(self.data_axes) > 1:
            wanted.append(self.data_axes)
        for axes in wanted:
            self._groups[axes] = self._new_group(axes)
        self.reset_stats()

    def _new_group(self, axes):
        """Every rank calls this for every axis set, in the same order."""
        others = [a for a in self.axis_names if a not in axes]
        parts = {}
        for r in range(self.size):
            c = self.coords_of(r)
            parts.setdefault(tuple(c[a] for a in others), []).append(r)
        group, _ = dist.new_subgroups_by_enumeration(
            list(parts.values()), timeout=datetime.timedelta(seconds=self.timeout))
        return group

    def group(self, axes):
        axes = tuple(a for a in self.axis_names if a in _as_tuple(axes))
        return self._groups[axes]

    def index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (its group rank)."""
        i = 0
        for a in self.axis_names:
            if a in _as_tuple(axes):
                i = i * self.shape[a] + self.coords[a]
        return i

    # ------------------------------------------------------------ context
    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()

    def model_group(self) -> "Mesh":
        """This rank's "model" group as a mesh of its own: the same ranks
        along "model", every data axis of size 1.  A computation inside it
        runs on this data rank's ranks alone (a prefill of one request
        while the other data ranks do other work); it shares the model
        group and the counts (``stats``) with this mesh."""
        sub = object.__new__(Mesh)
        sub.__dict__.update(self.__dict__)
        sub.sizes = tuple(s if a == "model" else 1 for a, s in zip(self.axis_names, self.sizes))
        sub.coords = {a: (c if a == "model" else 0) for a, c in self.coords.items()}
        return sub

    # -------------------------------------------------------- collectives
    def reset_stats(self):
        """Zero the counts, in place (a ``model_group`` shares them)."""
        if not hasattr(self, "stats"):
            self.stats = {}
        self.stats.update(collectives=0, seconds=0.0, bytes=0)

    def _count(self, t: torch.Tensor, t0: float):
        self.stats["collectives"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        self.stats["bytes"] += t.numel() * t.element_size()

    def all_gather(self, t: torch.Tensor, axes, dim: int | None = None):
        """The blocks of ``t`` of every rank along ``axes``, in rank order:
        a list, or concatenated along ``dim``."""
        if self.axes_size(axes) == 1:
            return [t] if dim is None else t
        t0 = time.perf_counter()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.axes_size(axes))]
        dist.all_gather(parts, t, group=self.group(axes))
        self._count(t, t0)
        return parts if dim is None else torch.cat(parts, dim=dim)

    def ordered_sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes``, added in rank
        order, ((p0 + p1) + p2) + ...: the k-split oracle's order."""
        parts = self.all_gather(t, axes)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.MAX) -> torch.Tensor:
        """A backend all-reduce, in place, for the order-free ops: MAX, and
        SUM of integers."""
        if self.axes_size(axes) == 1:
            return t
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group(axes))
        self._count(t, t0)
        return t

    def block(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of a full ``t`` along ``dim`` split over
        ``axes``."""
        n = self.axes_size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {axes} ({n})")
        size = t.shape[dim] // n
        return t.narrow(dim, self.index(axes) * size, size)


def current_mesh() -> Mesh | None:
    """The ambient mesh (``with mesh:``) when it has more than one rank."""
    if _CURRENT and _CURRENT[-1] is not None and _CURRENT[-1].size > 1:
        return _CURRENT[-1]
    return None


@contextlib.contextmanager
def single_device():
    """No ambient mesh inside: a rank runs the single-device path (a
    reference on whole tensors)."""
    _CURRENT.append(None)
    try:
        yield
    finally:
        _CURRENT.pop()


def make_debug_mesh(data: int = 2, model: int = 2, *, device=None) -> Mesh:
    """The ("data", "model") mesh of the running ranks, data x model of them."""
    return Mesh((data, model), AXES_2D, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(16, 16) = ("data", "model") on one pod; (2, 16, 16) = ("pod", "data",
    "model") on two, 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}, have {have} — spawn that many "
                           f"ranks (launch.mesh.spawn)")
    return Mesh(shape, AXES_3D if multi_pod else AXES_2D, device=device)


# ---------------------------------------------------------------- spawn
class RankFailed(RuntimeError):
    """A rank of a spawned mesh raised, died or outlived the deadline."""


def _rank_main(rank, fn, sizes, axis_names, device, backend, store, outdir, timeout, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    world = math.prod(sizes)
    if device == "cpu":
        # one thread a rank: every collective waits for the slowest rank, and
        # intra-op threads that contend with the other ranks' cost more than
        # they give (a reduced mesh training run 3.7 s with one, 6.0 with two)
        torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout))
        dev = device if device == "cpu" else f"cuda:{rank % torch.cuda.device_count()}"
        if dev != "cpu":
            torch.cuda.set_device(dev)
        mesh = Mesh(sizes, axis_names, device=dev, timeout=timeout)
        with mesh:
            out = fn(mesh, *args)
        torch.save(out, os.path.join(outdir, f"{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"{rank}.err"), "w") as f:
            f.write(f"{time.time_ns()}\n{traceback.format_exc()}")
        os._exit(1)


def _failure(procs, tmp) -> str:
    """The report of a failed run: the rank that failed first (the earliest
    traceback; the others then fail in their collectives), its traceback,
    and the rest."""
    time.sleep(0.5)         # let the ranks the failure takes down write theirs
    failed = {}
    for r, p in enumerate(procs):
        if p.exitcode not in (None, 0):
            err = os.path.join(tmp, f"{r}.err")
            stamp, _, text = (open(err).read().partition("\n") if os.path.exists(err)
                              else (str(time.time_ns()), "", "(no traceback: killed)"))
            failed[r] = (int(stamp), p.exitcode, text)
    first = min(failed, key=lambda r: failed[r][0])
    _, code, text = failed[first]
    rest = sorted(set(failed) - {first})
    return (f"rank {first} of {len(procs)} exited with code {code}:\n{text}"
            + (f"\nthen ranks {rest} failed too" if rest else ""))


def spawn(fn, sizes, *, device: str = "cuda", timeout: float = 600.0, args=(),
          axis_names=None, log=print) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a mesh of ``sizes`` and
    return each rank's result, in rank order.

    ``fn`` must be importable by name (a module-level function): the ranks
    are new processes (``spawn``).  Their backend is ``choose_backend``'s,
    printed through ``log`` before they start.  Every group has the
    ``timeout``; the join has the same deadline, and a rank that fails, or
    the deadline, kills the others and raises ``RankFailed`` naming the
    rank and carrying its traceback."""
    import torch.multiprocessing as mp

    world = math.prod(sizes)
    backend, why = choose_backend(world, device)
    log(f"mesh {MeshShape(sizes, axis_names)!r}: backend {backend} ({why})")
    tmp = tempfile.mkdtemp(prefix="repro_mesh_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, tuple(sizes), axis_names, device, backend,
                               os.path.join(tmp, "store"), tmp, timeout, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            if any(p.exitcode not in (None, 0) for p in procs):
                raise RankFailed(_failure(procs, tmp))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                late = [r for r, p in enumerate(procs) if p.exitcode is None]
                raise RankFailed(f"ranks {late} of {world} still running after the "
                                 f"{timeout:.0f} s deadline")
            time.sleep(0.05)
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
