"""Data-parallel training, one process a device: the counterpart of
``data_sharding``, ``replicated``, ``shard_batch`` and ``replicate_tree``
(``nind_denoise_tpu/parallel/mesh.py:98-118``) as the JAX trainer uses them
(``nind_denoise_tpu/train/loop.py:719-723, 792-793``).

JAX trains one process over a ``('data',)`` mesh: the batch sharded, the
parameters replicated, and under GSPMD every reduction over the batch axis
global (the loss means, the gradient, the BatchNorm statistics, the
discriminator's targets drawn at the global shape). A data-parallel step is
the one-device step on the global batch, up to the order of the sums. Here
each process (rank) holds one replica on its own device, and:

* ``enabled(world, batch, grad_accum)`` is the one predicate that turns
  data parallelism on: the batch scatter, the gradient reduce and the
  device-cache gate all read it;
* ``start`` derives the backend (``nccl`` when every rank has a GPU of its
  own, ``gloo`` on the CPU or where ranks share a card), makes the group
  and makes it active; ``broadcast_module`` starts the replicas alike from
  rank 0's parameters and buffers;
* ``DataParallel.batches`` scatters rank 0's global batch (its usual
  ``Loader``): rank r takes the r-th part of each global microbatch
  (``rank_rows``), so under ``--grad_accum`` BatchNorm sees JAX's
  microbatches. One small all-reduce a batch carries the batch's shape, the
  end of the epoch and any rank's shutdown request, so every rank takes the
  same branch;
* ``reduce_gradients`` is one flat all-reduce a step (sum, then divided by
  the world) of every gradient and the step's metrics, which come out as
  global means; ``min_max`` reduces prediction ranges;
* ``convert_batch_norm`` swaps the class of a model's ``nn.BatchNorm2d``
  modules in place (the ``state_dict`` names do not change) for
  ``GlobalBatchNorm2d``, which holds the run and normalizes by the global
  batch's statistics in train mode: the forward all-reduces ``[sum x, sum
  x^2, n]`` (float64 from each rank's own mean and variance), the backward
  ``[sum dy, sum dy*x_hat]``. Its ``normalize`` is the functional form
  (``F.batch_norm``'s arguments) that the models' frozen paths call;
* ``local()`` is a section one rank runs alone (validation on rank 0): inside
  it nothing is reduced;
* ``owned_rows(r0, r1, rows)`` marks a forward of one row band of an image
  (the trainer's sharded whole-image test, ``parallel/spatial.py``): rows
  ``[r0, r1)`` of the band's ``rows`` are this rank's, the rest a halo
  whose activations near the band's cut are wrong by construction. Inside
  it a ``GlobalBatchNorm2d`` in train mode sums ``[sum x, sum x^2, n]``
  over the owned rows alone, at each layer's scale (``owned``), across
  ranks, and normalizes the whole band by them: the statistics of the
  whole image. A forward only (no autograd).

Nothing here falls back: a failed ``nccl`` group raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import socket
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import mesh


def enabled(world: int, batch_size: int, grad_accum: int = 1) -> bool:
    """Data parallelism is on: more than one process, and a batch that
    splits into ``world`` equal parts of every one of its ``grad_accum``
    microbatches."""
    return world > 1 and batch_size % (world * grad_accum) == 0


def rank_rows(n: int, world: int, rank: int, grad_accum: int = 1) -> List[int]:
    """The rows of an ``n``-row global batch that ``rank`` takes: the
    ``rank``-th part of each of its ``grad_accum`` contiguous microbatches
    (JAX's microbatch i is rows ``[i*mb, (i+1)*mb)``)."""
    mb = n // grad_accum
    part = mb // world
    return [i * mb + rank * part + j for i in range(grad_accum) for j in range(part)]


@dataclasses.dataclass
class DataParallel:
    """The active data-parallel run: its group and this rank's place."""
    world: int
    rank: int
    backend: str
    group: object
    device: torch.device
    grad_accum: int = 1
    reduce_bytes: int = 0  # bytes of the last gradient all-reduce's buffer
    stopped: bool = False  # the last ``batches`` ended on a shutdown request
    paused: int = 0  # open ``local`` sections, one more once the run stops
    band: Optional[tuple] = None  # (r0, r1, rows) inside ``owned_rows``

    @property
    def reducing(self) -> bool:
        """Whether collectives run now: not inside ``local``, not stopped."""
        return not self.paused

    @property
    def comm_device(self) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def batches(self, host_batches: Optional[Iterable], stop: Callable[[], bool]
                ) -> Iterator:
        """This rank's NCHW (clean, noisy) tensors on its device, batch by
        batch. Rank 0 passes its NHWC numpy global batches; the others pass
        None. Before each batch every rank says whether it was asked to
        stop (``stop()``); the iteration ends on every rank at once, at the
        end of rank 0's batches or at any rank's request (``stopped``)."""
        self.stopped = False
        it = iter(host_batches) if self.rank == 0 else None
        while True:
            pair = next(it, None) if it is not None else None
            ctl = torch.zeros(6, dtype=torch.float64, device=self.device)
            ctl[0] = float(stop())
            if self.rank == 0:
                ctl[1] = float(pair is None)
                if pair is not None:
                    ctl[2:] = torch.tensor(pair[0].shape, dtype=torch.float64)
            ctl = mesh.all_max(ctl, self.group).tolist()
            if ctl[0] > 0:
                self.stopped = True
                return
            if ctl[1] > 0:
                return
            yield self._scatter(pair, [int(v) for v in ctl[2:]])

    def _scatter(self, pair, shape):
        import torch.distributed as dist

        n, h, w, c = shape
        if n % (self.world * self.grad_accum):
            raise ValueError(f"a batch of {n} does not split over {self.world} ranks "
                             f"x {self.grad_accum} microbatches")
        out = torch.empty((2, n // self.world, h, w, c), dtype=torch.float32,
                          device=self.comm_device)
        parts = None
        if self.rank == 0:
            both = torch.from_numpy(np.stack([np.asarray(a, np.float32) for a in pair]))
            parts = [both[:, rank_rows(n, self.world, r, self.grad_accum)]
                     .contiguous().to(self.comm_device) for r in range(self.world)]
        dist.scatter(out, parts, src=0, group=self.group)
        out = out.to(self.device).permute(0, 1, 4, 2, 3)
        return out[0].contiguous(), out[1].contiguous()


_ACTIVE: Optional[DataParallel] = None


def active() -> Optional[DataParallel]:
    """The active run, or None (no data parallelism, or inside ``local``)."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.reducing else None


@contextlib.contextmanager
def local():
    """A section this rank runs alone: nothing inside is reduced."""
    dp = _ACTIVE
    if dp is not None:
        dp.paused += 1
    try:
        yield
    finally:
        if dp is not None:
            dp.paused -= 1


@contextlib.contextmanager
def owned_rows(r0: int, r1: int, rows: int):
    """A forward of a band of ``rows`` input rows of which ``[r0, r1)`` are
    this rank's (see the module doc); a no-op without an active run."""
    dp = active()
    if dp is not None:
        if dp.band is not None:
            raise RuntimeError("owned_rows sections do not nest")
        dp.band = (r0, r1, rows)
    try:
        yield
    finally:
        if dp is not None:
            dp.band = None


def owned(x: torch.Tensor, band: tuple) -> torch.Tensor:
    """The rows of NCHW ``x``, an activation of a band's forward, that the
    band owns: ``[r0, r1)`` of its ``rows`` input rows at ``x``'s scale,
    which must divide them exactly."""
    r0, r1, rows = band
    h = x.shape[2]
    if rows % h or r0 % (rows // h) or r1 % (rows // h):
        raise ValueError(f"owned rows [{r0}, {r1}) of {rows} at a scale of {h} rows")
    k = rows // h
    return x[:, :, r0 // k:r1 // k]


def derive_backend(device: torch.device) -> str:
    """``nccl`` when every rank of the joined group trains on a GPU of its
    own, else ``gloo`` (the CPU, or ranks that share a card: NCCL refuses
    two ranks on one GPU). Every rank gets the same answer."""
    import torch.distributed as dist

    mine = (socket.gethostname(), str(device))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    own_gpus = all(d.startswith("cuda:") for _, d in everyone) \
        and len(set(everyone)) == len(everyone)
    return "nccl" if own_gpus else "gloo"


def start(device: torch.device, grad_accum: int = 1) -> DataParallel:
    """Make the joined processes one data-parallel run on ``device`` (this
    rank's) and make it active. ``nccl`` gets a group of its own, opened by
    a first all-reduce so that a failure raises here."""
    import torch.distributed as dist

    global _ACTIVE
    backend = derive_backend(device)
    group = None
    if backend == "nccl":
        torch.cuda.set_device(device)
        group = dist.new_group(backend="nccl")
        mesh.all_reduce(torch.zeros(1, device=device), "sum", group)
    _ACTIVE = DataParallel(world=dist.get_world_size(), rank=dist.get_rank(),
                           backend=backend, group=group, device=device,
                           grad_accum=grad_accum)
    return _ACTIVE


def stop() -> None:
    """Deactivate the run: its converted modules reduce nothing more (the
    process group stays joined)."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.paused += 1
    _ACTIVE = None


def broadcast_module(module: nn.Module) -> None:
    """Rank 0's parameters and buffers into ``module`` on every rank."""
    dp = active()
    if dp is None:
        return
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            t.copy_(mesh.broadcast0(t.detach().clone(), dp.group))


def digest(modules: Iterable[nn.Module]) -> str:
    """SHA-256 of the bytes of every parameter and buffer of ``modules``:
    equal on two ranks when their replicas are equal bit for bit."""
    h = hashlib.sha256()
    for m in modules:
        for k, t in m.state_dict().items():
            h.update(k.encode())
            h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def reduce_gradients(params: Iterable[torch.Tensor],
                     metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One flat all-reduce of every gradient of ``params`` (those that have
    one) and of the 0-d ``metrics``, summed and divided by the world: the
    gradients become the global batch's, the metrics its means (equal shards
    make the mean of the ranks' means the global mean). The identity where
    no run is active."""
    dp = active()
    if dp is None:
        return metrics
    grads = [p.grad for p in params if p.grad is not None]
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.stack([metrics[k].detach().float().reshape(()) for k in keys])])
    mesh.all_reduce_(flat, "sum", dp.group).div_(dp.world)
    parts = flat.split([g.numel() for g in grads] + [len(keys)])
    with torch.no_grad():
        torch._foreach_copy_(grads, [v.view_as(g) for g, v in zip(grads, parts)])
    dp.reduce_bytes = flat.numel() * flat.element_size()
    return dict(zip(keys, parts[-1].unbind()))


def min_max(ranges: torch.Tensor) -> torch.Tensor:
    """``[min, max, min, max, ...]`` over every rank's rows."""
    dp = active()
    if dp is None:
        return ranges
    return torch.stack([mesh.all_min(ranges[0::2], dp.group),
                        mesh.all_max(ranges[1::2], dp.group)], 1).reshape(-1)


def rank_slice(u: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``u``, a tensor with the global batch's rows."""
    dp = active()
    if dp is None:
        return u
    return u[rank_rows(u.shape[0], dp.world, dp.rank, dp.grad_accum)]


def global_shape(shape) -> tuple:
    """``shape`` (this rank's rows first) with the global batch's rows."""
    dp = active()
    return tuple(shape) if dp is None else (shape[0] * dp.world, *shape[1:])


# -- BatchNorm over the global batch --------------------------------------------

def _global_moments(x: torch.Tensor, group):
    """(mean, biased variance, count) a channel of NCHW ``x`` over every
    rank's ``x``: ``[sum x, sum x^2, n]`` in float64 from each rank's own
    mean and variance, summed across ranks. The count stays on the device:
    no host read a site."""
    c = x.shape[1]
    n = x.numel() // c
    var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
    m64 = mean.double()
    local = torch.cat([m64 * n, (var.double() + m64 * m64) * n,
                       torch.full((1,), float(n), dtype=torch.float64, device=x.device)])
    tot = mesh.all_reduce(local, "sum", group)
    count = tot[-1]
    gmean64 = tot[:c] / count
    gvar = (tot[c:2 * c] / count - gmean64 * gmean64).clamp_min(0).float()
    return gmean64.float(), gvar, count


def _update_running(running_mean, running_var, gmean, gvar, count, momentum) -> None:
    """The running stats (where given) take the global statistics, the
    variance unbiased over ``count``."""
    if running_mean is not None:
        unbiased = gvar * (count / (count - 1).clamp_min(1)).float()
        running_mean.copy_((1 - momentum) * running_mean + momentum * gmean)
        running_var.copy_((1 - momentum) * running_var + momentum * unbiased)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm of NCHW ``x`` by the statistics of every rank's
    rows; updates the running stats (unbiased over the global count) where
    they are given."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, group):
        gmean, gvar, count = _global_moments(x, group)
        _update_running(running_mean, running_var, gmean, gvar, count, momentum)
        inv = torch.reciprocal(torch.sqrt(gvar + eps))
        xhat = (x - gmean[:, None, None]) * inv[:, None, None]
        y = xhat
        if weight is not None:
            y = y * weight[:, None, None]
        if bias is not None:
            y = y + bias[:, None, None]
        ctx.save_for_backward(xhat, inv, weight)
        ctx.count, ctx.group = count.float(), group
        return y

    @staticmethod
    def backward(ctx, dy):
        xhat, inv, weight = ctx.saved_tensors
        c = dy.shape[1]
        sdy = dy.sum((0, 2, 3))
        sdyx = (dy * xhat).sum((0, 2, 3))
        tot = mesh.all_reduce(torch.cat([sdy, sdyx]), "sum", ctx.group)
        scale = inv if weight is None else inv * weight
        dx = scale[:, None, None] * (dy - (tot[:c] / ctx.count)[:, None, None]
                                     - xhat * (tot[c:] / ctx.count)[:, None, None])
        # the parameters' gradients stay this rank's: reduce_gradients sums them
        dw = sdyx if weight is not None and ctx.needs_input_grad[1] else None
        db = sdy if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None, None, None


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode takes the statistics of the
    global batch of the run ``dp`` it was converted in
    (``convert_batch_norm``), outside its ``local`` sections."""

    dp: Optional[DataParallel] = None

    def _global(self, training: bool) -> bool:
        return training and self.dp is not None and self.dp.reducing

    def normalize(self, x: torch.Tensor, running_mean, running_var, weight, bias,
                  training: bool, momentum: float, eps: float) -> torch.Tensor:
        """``F.batch_norm``, by the global batch's statistics in training;
        inside ``owned_rows``, by those of every rank's owned rows."""
        if not self._global(training):
            return F.batch_norm(x, running_mean, running_var, weight, bias, training,
                                momentum, eps)
        if self.dp.band is not None:
            if torch.is_grad_enabled():
                raise RuntimeError("a band's BatchNorm is a forward only: run it under no_grad")
            # the whole band by the owned rows' statistics, in one fused pass
            xf = x.float()
            gmean, gvar, count = _global_moments(owned(xf, self.dp.band), self.dp.group)
            _update_running(running_mean, running_var, gmean, gvar, count, momentum)
            return F.batch_norm(xf, gmean, gvar, weight, bias, False, 0.0, eps).to(x.dtype)
        y = _GlobalBatchNorm.apply(x.float(), weight, bias, running_mean, running_var,
                                   momentum, eps, self.dp.group)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._global(self.training):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return self.normalize(x, self.running_mean, self.running_var, self.weight, self.bias,
                              True, self.momentum, self.eps)


def convert_batch_norm(module: nn.Module) -> int:
    """Every ``nn.BatchNorm2d`` of ``module`` becomes a ``GlobalBatchNorm2d``
    of the active run in place (parameters, buffers and names kept; without
    a run it normalizes as before); returns how many."""
    count = 0
    for m in module.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
            m.dp = active()
            count += 1
    return count
