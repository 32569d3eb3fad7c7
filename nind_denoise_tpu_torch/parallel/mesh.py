"""Device lists, process groups and the per-device runner of the parallel
engines.

Counterpart of ``nind_denoise_tpu/parallel/mesh.py``. JAX's ``make_mesh(n)``
takes the first ``n`` local devices; here a "mesh" is a list of
``torch.device``:

* on CUDA, ``n`` devices are the first ``n`` of this process's GPUs
  (``local_gpus``: ``cuda:0 .. cuda:n-1`` on one process) and ``need n
  devices, have m`` is raised when it has fewer; ``n`` None (or 0) means
  all of them;
* on the CPU (``device="cpu"``), ``n`` logical devices that are all the
  CPU, as the JAX tests run on eight virtual host devices; None means 1;
* an explicit list (``[cuda:0, cuda:0]`` rehearses two devices on one
  card) is taken as it is.

``shard_batch``/``replicate_tree``/``data_sharding`` have no counterpart
here: the inference engines put one copy of the model on each distinct
device (``replicate``) and hand each device its own rows or images, and
data-parallel training runs one process a device
(``parallel/data_parallel.py``).

Processes: ``init_distributed`` joins a ``torch.distributed`` process group
on ``gloo`` (the inference front ends shard files across processes and
gather per-set sums on the host; data-parallel training opens its own
``nccl`` group where it can, ``data_parallel.start``). It reads torchrun's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
where JAX reads ``JAX_COORDINATOR_ADDRESS``, or JAX's three flags
(``--coordinator host:port --num_processes N --process_id i``).
``rank_device`` is a training rank's device, and the small collectives
(``all_reduce_`` in place, ``all_reduce``, ``all_min``/``all_max``,
``broadcast0``, ``broadcast_object``, ``gather_rows``) take tensors on
that device: a ``gloo`` group moves a CUDA tensor through the host, an
``nccl`` group takes no CPU tensor.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import datetime
import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.device import resolve_device

Devices = Union[None, int, Sequence[Union[str, torch.device]]]


def make_devices(n: Devices = None, device=None) -> List[torch.device]:
    """The device list of ``n`` (see the module doc); ``device`` is the
    front ends' ``--device`` (CUDA unless ``cpu``)."""
    if n is not None and not isinstance(n, int):
        devs = [torch.device(d) for d in n]
        if not devs:
            raise ValueError("an empty device list")
        for d in devs:
            resolve_device(d)
        return devs
    base = resolve_device(device)
    if base.type == "cpu":
        return [base] * (n or 1)
    gpus = local_gpus()
    n = n or len(gpus)
    if len(gpus) < n:
        raise ValueError(f"need {n} devices, have {len(gpus)}")
    if n == 1 and base.index is not None:
        return [base]
    return [torch.device("cuda", i) for i in gpus[:n]]


def local_gpus() -> List[int]:
    """This process's GPUs, JAX's local devices: every visible one, or
    under torchrun (``LOCAL_WORLD_SIZE`` > 1) the ``LOCAL_RANK``-th equal
    share of them (one GPU shared round-robin when there are fewer GPUs
    than processes)."""
    have = torch.cuda.device_count()
    procs = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    if procs <= 1 or have == 0:
        return list(range(have))
    per = have // procs
    return [rank % have] if per == 0 else list(range(rank * per, (rank + 1) * per))


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """The devices of a list without repeats, in first-seen order."""
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def replicate(make: Callable[[torch.device], object],
              devices: Sequence[torch.device]) -> list:
    """``make(device)`` once per distinct device; one entry per listed
    device (a repeated device shares its copy)."""
    built = {d: make(d) for d in distinct(devices)}
    return [built[d] for d in devices]


# -- processes ----------------------------------------------------------------

def _coordinator(address: Optional[str]) -> Optional[str]:
    if address is None:
        if not os.environ.get("MASTER_ADDR"):
            return None
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return address if "://" in address else f"tcp://{address}"


def planned_world(num_processes: Optional[int] = None) -> int:
    """The world size a join would take: ``num_processes``, else
    ``WORLD_SIZE``, else 1 (readable before anything joins)."""
    return int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None \
        else int(num_processes)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join a process group on ``gloo``; True when one is (now) joined.

    Joins when ``coordinator`` ("host:port" or "tcp://host:port") is passed
    or torchrun's ``MASTER_ADDR`` is set, with ``num_processes`` /
    ``process_id`` defaulting to ``WORLD_SIZE`` / ``RANK``. A single
    process (world size 1) is a no-op returning False, as is a call with
    neither a coordinator nor ``MASTER_ADDR``; ``num_processes`` > 1
    without a coordinator raises. Idempotent."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    world = planned_world(num_processes)
    rank = int(os.environ.get("RANK", "0")) if process_id is None else int(process_id)
    addr = _coordinator(coordinator)
    if world <= 1:
        return False
    if addr is None:
        raise ValueError(f"init_distributed: {world} processes need a coordinator "
                         f"address (pass coordinator= or set MASTER_ADDR/MASTER_PORT)")
    dist.init_process_group("gloo", init_method=addr, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device=None) -> torch.device:
    """A training rank's device. ``device`` is ``--device``: the CPU, or a
    GPU named with its index, is taken as given (``cuda:0`` on every rank
    rehearses several ranks on one card); plain CUDA is ``cuda:{LOCAL_RANK}``
    (torchrun's variable; without it, the rank modulo this host's GPUs).
    One process keeps ``device`` as it is."""
    base = resolve_device(device)
    if base.type == "cpu" or base.index is not None or process_count() <= 1:
        return base
    have = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", process_index() % max(have, 1)))
    if local >= have:
        raise ValueError(f"rank {process_index()}: LOCAL_RANK {local} but this host has "
                         f"{have} GPUs")
    return torch.device("cuda", local)


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _joined() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _joined() else 0


def process_shard(items):
    """Every ``process_count()``-th item from this process's index (strided,
    so mixed-size directories balance); the identity on one process."""
    items = list(items)
    n = process_count()
    return items if n <= 1 else items[process_index()::n]


def process_allgather(local: np.ndarray) -> np.ndarray:
    """(process_count(), *local.shape) float64: every process's ``local``,
    in rank order (JAX's ``multihost_utils.process_allgather``). A
    collective: every process calls it, and it returns once all have."""
    import torch.distributed as dist

    t = torch.as_tensor(np.asarray(local, np.float64))
    if not _joined():
        return t[None].numpy()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def _through(t: torch.Tensor, group, op: Callable[[torch.Tensor], object]) -> torch.Tensor:
    """``op(t)`` in place on ``group``'s backend (a ``gloo`` group takes a
    CUDA tensor through a host copy); returns ``t``."""
    import torch.distributed as dist

    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        op(host)
        return t.copy_(host)
    op(t)
    return t


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` (``sum``, ``min`` or ``max``) in place;
    the identity on one process. ``t`` is contiguous."""
    import torch.distributed as dist

    if not _joined():
        return t
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
    return _through(t, group, lambda x: dist.all_reduce(x, red, group=group))


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over ``group``, as a new tensor: ``t`` is not modified."""
    return all_reduce_(t.clone(memory_format=torch.contiguous_format), op, group)


def all_min(t: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(t, "min", group)


def all_max(t: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(t, "max", group)


def broadcast0(t: torch.Tensor, group=None) -> torch.Tensor:
    """Rank 0's ``t`` on every process, in place; returns ``t``."""
    import torch.distributed as dist

    if not _joined():
        return t
    src = dist.get_global_rank(group, 0) if group is not None else 0
    return _through(t, group, lambda x: dist.broadcast(x, src, group=group))


def gather_rows(t: torch.Tensor, rows: Sequence[int], group=None) -> Optional[torch.Tensor]:
    """On rank 0, every rank's NCHW ``t`` concatenated along H in rank
    order, where rank r's has ``rows[r]`` rows (every rank passes the same
    ``rows``); None on the other ranks. Each part is padded to the longest,
    so one ``gather`` moves them all. A collective."""
    import torch.distributed as dist

    if not _joined():
        return t
    rank = dist.get_rank(group)
    if t.shape[2] != rows[rank]:
        raise ValueError(f"rank {rank}: {t.shape[2]} rows, expected {rows[rank]}")
    comm = torch.device("cpu") if dist.get_backend(group) == "gloo" else t.device
    part = torch.nn.functional.pad(t, (0, 0, 0, max(rows) - rows[rank])).to(comm).contiguous()
    parts = [torch.empty_like(part) for _ in rows] if rank == 0 else None
    dst = dist.get_global_rank(group, 0) if group is not None else 0
    dist.gather(part, parts, dst=dst, group=group)
    if rank != 0:
        return None
    return torch.cat([p[:, :, :n] for p, n in zip(parts, rows)], 2).to(t.device)


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every process (over the default
    group); the identity on one process."""
    import torch.distributed as dist

    if not _joined():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Zero-pad ``axis`` to a multiple of ``multiple``; (padded, n_real)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad), n


# -- running work on each device ------------------------------------------------

def streams_for(devices: Sequence[torch.device]) -> list:
    """One CUDA stream per listed device (None for a CPU entry), so that two
    entries naming one card still run concurrently there."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices]


@contextlib.contextmanager
def on_device(device: torch.device, stream=None):
    """Make ``device`` (and ``stream`` on it) current for the block; the
    stream first waits for the device's default stream (the weights and
    anything queued before). A no-op for the CPU."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.default_stream(device))
        with torch.cuda.stream(stream):
            yield


def run_each(devices: Sequence[torch.device], fn: Callable[[int], object],
             streams: Optional[list] = None, n: Optional[int] = None) -> list:
    """``[fn(i) for i in range(n)]`` (n defaults to ``len(devices)``) with
    ``devices[i]`` (and ``streams[i]``) current for ``fn(i)``, under
    inference mode. On CUDA each call runs on a thread of its own and its
    stream is synchronized before the call returns, so nothing waits for
    another device; on the CPU the calls run in turn. The first exception
    raised is re-raised."""
    n = len(devices) if n is None else n
    streams = streams or [None] * len(devices)

    def one(i):
        with torch.inference_mode(), on_device(devices[i], streams[i]):
            out = fn(i)
            if streams[i] is not None:
                streams[i].synchronize()
            elif devices[i].type == "cuda":
                torch.cuda.current_stream(devices[i]).synchronize()
            return out

    if n <= 1 or all(devices[i].type != "cuda" for i in range(n)):
        return [one(i) for i in range(n)]
    with cf.ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(one, i) for i in range(n)]
        return [f.result() for f in futures]
