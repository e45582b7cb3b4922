"""Process groups of the multi-device solvers — the torch counterpart of
gardenia_tpu/parallel/mesh.py.

JAX runs shard_map from one process over n devices.  Here the idiom is
SPMD: one process a rank, `torch.distributed` collectives, and every
`*_dist` solver is called on every rank with the same host graph; each
rank builds only its own shard and returns the assembled global result.

`make_mesh(n, device=...)` joins the process group that is already
running (one that torchrun started, or `run_on_ranks`), from the usual
environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE).  `run_on_ranks(fn, n, device, *args)` starts n local
ranks (torch.multiprocessing's spawn context), runs fn(mesh, *args) on
each and returns their results in rank order.

Backends and devices are chosen openly, never by fallback:
  device "cpu"                      -> gloo, CPU tensors;
  device "cuda", a card a rank      -> nccl, rank r on cuda:r;
  device "cuda", fewer cards than   -> gloo with CUDA tensors, rank r on
    ranks (several ranks a card)       cuda:(r % cards): NCCL refuses two
                                       ranks on one device.
With torch 2.11 on an NVIDIA H100, gloo took all_gather_into_tensor and
all_reduce (sum, max, min) of f32, int32 and int64 CUDA tensors directly
(scripts/probe_dist.py), so the mesh stages nothing itself (gloo copies
CUDA tensors through host memory inside the collective); a collective
gloo refuses raises.  "cuda" without a card raises, as
resolve_device does.
Every rank pins its device, and the group has a timeout, so a rank that
dies fails the run instead of leaving the others in a collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import socket
import traceback
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gardenia_tpu_torch import resolve_device

TIMEOUT_S = 600
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclasses.dataclass
class Mesh:
    """This rank's view of a 1D group: its rank, the group's size, the
    device it computes on, the backend, and this rank's calls and bytes
    by collective (an all_gather counts the bytes it returns, an
    all_reduce those of the tensor it reduces)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    calls: dict = dataclasses.field(
        default_factory=lambda: {"all_gather": 0, "all_reduce": 0})
    bytes: dict = dataclasses.field(
        default_factory=lambda: {"all_gather": 0, "all_reduce": 0})
    # the (r, c) mesh over this group, once make_mesh2d has made it
    mesh2d: Optional["Mesh2D"] = dataclasses.field(default=None, repr=False)

    def describe(self) -> str:
        return describe(self.size, self.device.type)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped t concatenated along dim 0 in rank
        order (JAX's all_gather(..., tiled=True))."""
        t = t.contiguous()
        self.calls["all_gather"] += 1
        self.bytes["all_gather"] += t.numel() * t.element_size() * self.size
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t)
        return out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: t reduced elementwise over the ranks by op
        ('sum', 'max' or 'min'); t itself is left as it was."""
        self.calls["all_reduce"] += 1
        self.bytes["all_reduce"] += t.numel() * t.element_size()
        buf = t.detach().clone()
        dist.all_reduce(buf, op=_OPS[op])
        return buf

    def all_gather_cols(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' (m, c) t side by side, (m, size * c), in rank order."""
        g = self.all_gather(t[None])                 # (size, m, c)
        return g.permute(1, 0, 2).reshape(t.shape[0], -1)


def mesh2d_shape(n: int) -> Tuple[int, int]:
    """The near-square (r, c) factorisation of n ranks, r <= c
    (gardenia_tpu/parallel/two_d.py:41-48)."""
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


@dataclasses.dataclass
class Mesh2D:
    """This rank's view of an (r, c) mesh laid over a 1D group: rank
    i * c + k sits at (i, k), as JAX reshapes its device list.  Axis "r"
    joins the ranks of one column k (varying i), axis "c" those of one row
    i.  Collectives over an axis run on its subgroup and are counted, as
    Mesh counts them, in the world Mesh's calls and bytes."""
    world: Mesh
    shape: Tuple[int, int]
    coords: Tuple[int, int]
    groups: dict

    @property
    def device(self) -> torch.device:
        return self.world.device

    def _count(self, kind: str, nbytes: int) -> None:
        self.world.calls[kind] += 1
        self.world.bytes[kind] += nbytes

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The equal-shaped t of the ranks along `axis` concatenated along
        dim 0 in their order on the axis (all_gather(..., tiled=True))."""
        t = t.contiguous()
        k = self.shape[0] if axis == "r" else self.shape[1]
        self._count("all_gather", t.numel() * t.element_size() * k)
        out = t.new_empty((k * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.groups[axis])
        return out

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """A new tensor: t reduced over the ranks along `axis` by op."""
        self._count("all_reduce", t.numel() * t.element_size())
        buf = t.detach().clone()
        dist.all_reduce(buf, op=_OPS[op], group=self.groups[axis])
        return buf


def make_mesh2d(n: Optional[int] = None, *, device="cuda",
                mesh: Optional[Mesh] = None) -> Mesh2D:
    """This rank's Mesh2D over the running group (or over `mesh`, the 1D
    Mesh of it): the near-square (r, c) shape of mesh2d_shape, a row and
    a column subgroup on the world group's backend.  Every rank creates
    every subgroup in the same order, as torch.distributed requires, so
    every rank calls this at the same point; the Mesh2D is kept on the 1D
    Mesh and made once."""
    if mesh is None:
        mesh = make_mesh(n, device=device)
    if getattr(mesh, "mesh2d", None) is not None:
        return mesh.mesh2d
    r, c = mesh2d_shape(mesh.size)
    backend = dist.get_backend()
    groups = {}
    for k in range(c):                      # axis "r": one column k
        grp = dist.new_group([i * c + k for i in range(r)], backend=backend)
        if mesh.rank % c == k:
            groups["r"] = grp
    for i in range(r):                      # axis "c": one row i
        grp = dist.new_group([i * c + k for k in range(c)], backend=backend)
        if mesh.rank // c == i:
            groups["c"] = grp
    mesh.mesh2d = Mesh2D(mesh, (r, c), divmod(mesh.rank, c), groups)
    return mesh.mesh2d


def _env_int(name: str, default: Optional[int] = None) -> int:
    val = os.environ.get(name)
    if val is None:
        if default is None:
            raise RuntimeError(f"${name} is not set: start the ranks with "
                               "torchrun or run_on_ranks")
        return default
    return int(val)


def plan(n: int, device: str):
    """(backend, device of each rank) for n local ranks on `device`."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    devs = [torch.device("cuda", r % cards) for r in range(n)]
    return ("nccl" if n <= cards else "gloo"), devs


def describe(n: int, device) -> str:
    """'<n> ranks (<backend>, <device> x<ranks on it>, ...)' of n local
    ranks on `device`."""
    backend, devs = plan(n, str(torch.device(device).type))
    names = [str(d) for d in devs]
    on = ", ".join(f"{d} x{names.count(d)}" for d in dict.fromkeys(names))
    return f"{n} ranks ({backend}, {on})"


def make_mesh(n: Optional[int] = None, *, device="cuda") -> Mesh:
    """This rank's Mesh of the running group of n ranks (all of them when
    n is None), initialising the process group from the environment when
    it is not yet."""
    world = _env_int("WORLD_SIZE") if not dist.is_initialized() \
        else dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks asked for in a group of "
                         f"{world}")
    local = _env_int("LOCAL_WORLD_SIZE", world)
    local_rank = _env_int("LOCAL_RANK", _env_int("RANK"))
    backend, devs = plan(local, device)
    dev = devs[local_rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", world_size=world,
            rank=_env_int("RANK"),
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(dist.get_rank(), world, dev, dist.get_backend())


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(obj):
    """obj with every tensor in it moved to the CPU (dataclasses, tuples,
    lists and dicts are walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*map(to_host, obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map(to_host, obj))
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, n, port, device, fn, args, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    if device == "cpu":
        # the ranks share the host's cores: n ranks of all of them each
        # spin against one another in every small op
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        mesh = make_mesh(n, device=device)
        # pickled here, by value: a tensor put on the queue as it is would
        # travel as a shared-memory handle that dies with this process
        results.put((rank, True, pickle.dumps(to_host(fn(mesh, *args)))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def call_each(mesh: Mesh, calls):
    """[fn(*args, mesh=mesh, **kwargs) for fn, args, kwargs in calls]:
    several solves in one group (for run_on_ranks)."""
    return [fn(*args, mesh=mesh, **kwargs) for fn, args, kwargs in calls]


def time_each(mesh: Mesh, calls):
    """[(result, seconds)] of call_each's calls, each timed by
    utils/timer.time_op (one warm-up solve, then one timed)."""
    from gardenia_tpu_torch.utils.timer import time_op
    return [time_op(lambda: fn(*args, mesh=mesh, **kwargs),
                    device=mesh.device) for fn, args, kwargs in calls]


def run_on_ranks(fn, n: int, device, *args, timeout: float = 3600):
    """[fn(mesh, *args) on rank r for r in range(n)]: n local ranks in a
    fresh group on `device` ("cpu" or "cuda"), each a spawned process.
    fn must be importable (pickled by name) and so must args; what fn
    returns comes back with its tensors on the CPU.  A rank that raises or
    dies fails the whole run (RuntimeError with its traceback) and the
    other ranks are stopped; none is left running."""
    import torch.multiprocessing as mp
    device = str(resolve_device(device))
    if device.startswith("cuda"):
        # one build of the kernel library before the ranks load it
        from gardenia_tpu_torch.ops import _build
        _build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, device, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        while len(out) + len(errors) < n:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    errors.append(f"rank {procs.index(dead[0])} exited with "
                                  f"code {dead[0].exitcode} and no result")
                if errors or datetime.datetime.now() > deadline:
                    break
                continue
            if ok:
                out[rank] = pickle.loads(val)
            else:
                errors.append(f"rank {rank} failed:\n{val}")
                break
    finally:
        for p in procs:
            if errors or len(out) < n:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError(f"{n}-rank run on {device} failed: {errors[0]}")
    if len(out) < n:
        raise RuntimeError(f"{n}-rank run on {device} timed out after "
                           f"{timeout} s ({len(out)} ranks returned)")
    return [out[r] for r in range(n)]
