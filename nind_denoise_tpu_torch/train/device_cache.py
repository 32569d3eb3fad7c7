"""Device-resident training data: crops held on the card and augmented
there. The counterpart of ``nind_denoise_tpu/train/device_cache.py``.

* A shard of the crop set lives on the device as two stacked NHWC
  ``(N, cs, cs, 3)`` tensors (clean, noisy) in float16. The fill
  and each refresh draw their rows from ``np.random.default_rng(seed)``
  in the JAX package's order, so one seed caches the same crops in both.
* The reference's per-item augmentation (rot90 by k, two flips, the
  exposure multiplier ``exp_mult ~ U[min, min(max, 1/x.max())]``, applied
  unclipped to the clean crop and clipped to the noisy one;
  dataset_torch_3.py:249-274) runs on the device in ``augment``: plain
  torch, one gather for the orientations. Its draws come from a device
  ``torch.Generator``; no host bytes move per step.
* A background thread decodes a refresh block on the host;
  ``maybe_swap`` uploads it and writes it into the cache at an epoch
  boundary, on the owner thread, and never waits for the refresher.
  Uploads go in chunks through one pinned staging buffer on CUDA.

JPEG-compression and Gaussian-noise augmentations (host codecs) have no
device form: ``supports`` is False and the trainer keeps its host loader.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

# bytes per upload chunk during (re)fills
_PUT_CHUNK_BYTES = 64 << 20


def supports(dataset) -> bool:
    """Whether ``dataset``'s augmentations have a device form (rot90,
    flips, exp_mult yes; JPEG compression and Gaussian noise no)."""
    return (getattr(dataset, "compressionmin", 100) >= 100
            and getattr(dataset, "sigmamax", 0) == 0
            and hasattr(dataset, "load_pair"))


def orientation_index(n: int, nrot: torch.Tensor, fv: torch.Tensor, fh: torch.Tensor):
    """Source (row, col) of every pixel of an n x n crop after
    ``np.rot90(., k, (0, 1))``, then a vertical flip where ``fv``, then a
    horizontal flip where ``fh``: two (B, n, n) int64 tensors."""
    ar = torch.arange(n, device=nrot.device)
    i = ar.view(1, n, 1).expand(nrot.shape[0], n, n)
    j = ar.view(1, 1, n).expand(nrot.shape[0], n, n)
    v = fv.long().view(-1, 1, 1)
    h = fh.long().view(-1, 1, 1)
    i = i + v * (n - 1 - 2 * i)   # the flips act on the rotated crop
    j = j + h * (n - 1 - 2 * j)
    k = nrot.long().view(-1, 1, 1)
    # rot90 by k: k=1 (i, j) <- (j, n-1-i); k=2 <- (n-1-i, n-1-j); k=3 <- (n-1-j, i)
    row = torch.where(k == 0, i, torch.where(k == 1, j, torch.where(k == 2, n - 1 - i, n - 1 - j)))
    col = torch.where(k == 0, j, torch.where(k == 1, n - 1 - i, torch.where(k == 2, n - 1 - j, i)))
    return row, col


def augment(x: torch.Tensor, y: torch.Tensor, nrot: torch.Tensor, fv: torch.Tensor,
            fh: torch.Tensor, u: torch.Tensor, exp_mult_min: float,
            exp_mult_max: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's augmentation of an NHWC float32 batch of square
    clean ``x`` and noisy ``y`` crops, given its draws: per sample the
    same rotation ``nrot`` (0-3) and flips ``fv``/``fh`` for both crops,
    then ``exp_mult = min + u * (min(max, 1 / max(x)) - min)`` (rounded
    once, as a fused multiply-add); ``x``
    scales unclipped, ``y`` scales and clips to [0, 1]. The same arithmetic
    as the JAX sampler (``device_cache.py:91-117``), so given JAX's draws
    it returns JAX's batch bit for bit."""
    b, n = x.shape[0], x.shape[1]
    lo, top = float(np.float32(exp_mult_min)), float(np.float32(exp_mult_max))
    row, col = orientation_index(n, nrot, fv, fh)
    bi = torch.arange(b, device=x.device).view(b, 1, 1)
    x, y = x[bi, row, col], y[bi, row, col]
    # the bound tracks the clean crop's max, which rot/flip preserve
    hi = torch.clamp(1.0 / torch.clamp(x.amax(dim=(1, 2, 3)), min=1e-8), max=top)
    # one rounding of u * (hi - min) + min, as the fused multiply-add that
    # XLA emits for this line: the float64 product of two float32 values
    # is exact
    em = (u.double() * (hi - lo).double() + lo).float()
    em = em.view(b, 1, 1, 1)
    return x * em, torch.clamp(y * em, 0.0, 1.0)


class DeviceEpochCache:
    """Device-resident shard of (clean, noisy) crop pairs with device-side
    augmentation.

    ``capacity``: crops held (at most ``len(dataset)``). ``refresh_frac``:
    share of the cache re-drawn (new ISO pair and crop position, decoded on
    the host) and uploaded at each epoch boundary; 0 disables refresh.
    ``device``: CUDA unless the caller asks for the CPU; raises where CUDA
    is absent.
    The rows are stored as float16, the JAX trainer's storage type.
    """

    def __init__(self, dataset, capacity: int, *, device=None, seed: int = 0,
                 refresh_frac: float = 0.25,
                 threads: int = 2):
        if not supports(dataset):
            raise ValueError(
                "DeviceEpochCache: dataset uses host-only augmentation "
                "(JPEG compression / Gaussian noise) or lacks load_pair")
        self.dataset = dataset
        self.device = resolve_device(device)
        self.n = min(capacity, len(dataset))
        self.cs = dataset.cs
        self.exp_mult_min = float(getattr(dataset, "exp_mult_min", 1.0))
        self.exp_mult_max = float(getattr(dataset, "exp_mult_max", 1.0))
        self._rng = np.random.default_rng(seed)
        self._threads = max(1, threads)
        self._refresh_rows = (max(1, int(round(self.n * refresh_frac)))
                              if refresh_frac > 0 else 0)
        self._pending: Optional[Tuple[np.ndarray, np.ndarray, int]] = None
        self._pending_lock = threading.Lock()
        self._refresher: Optional[threading.Thread] = None
        self._next_offset = 0
        self._staging: Optional[torch.Tensor] = None
        xs, ys = self._load_rows(self.n)
        shape = (self.n, self.cs, self.cs, 3)
        self.cache_x = torch.empty(shape, dtype=torch.float16, device=self.device)
        self.cache_y = torch.empty(shape, dtype=torch.float16, device=self.device)
        self._upload(self.cache_x, xs, 0)
        self._upload(self.cache_y, ys, 0)
        del xs, ys
        self.uploaded_rows = self.n  # every row ever uploaded
        self.swaps = 0

    # -- host side -------------------------------------------------------

    def _load_rows(self, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """Decode ``count`` fresh (clean, noisy) pairs (threaded) -> NHWC
        arrays in float16."""
        idxs = [int(i % len(self.dataset)) for i in
                self._rng.permutation(max(count, len(self.dataset)))[:count]]
        xs = np.empty((count, self.cs, self.cs, 3), np.float16)
        ys = np.empty_like(xs)

        def load_span(lo, hi):
            for j in range(lo, hi):
                c, n = self.dataset.load_pair(idxs[j])
                xs[j] = c.transpose(1, 2, 0)
                ys[j] = n.transpose(1, 2, 0)

        if self._threads == 1 or count < 8:
            load_span(0, count)
        else:
            span = -(-count // self._threads)
            ts = [threading.Thread(target=load_span,
                                   args=(t * span, min(count, (t + 1) * span)))
                  for t in range(self._threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        return xs, ys

    def _upload(self, dst: torch.Tensor, rows: np.ndarray, offset: int) -> None:
        """Copy host ``rows`` into ``dst[offset:offset + len(rows)]`` in
        chunks of about ``_PUT_CHUNK_BYTES``; on CUDA through one pinned
        staging buffer."""
        per = max(1, _PUT_CHUNK_BYTES // max(1, rows[0].nbytes))
        for i in range(0, rows.shape[0], per):
            src = torch.from_numpy(rows[i:i + per])
            if self.device.type == "cuda":
                if self._staging is None or self._staging.shape[0] < src.shape[0]:
                    self._staging = torch.empty((per,) + src.shape[1:], dtype=src.dtype,
                                                pin_memory=True)
                stage = self._staging[:src.shape[0]]
                stage.copy_(src)
                src = stage
            # synchronous: the staging buffer is reused by the next chunk
            dst[offset + i:offset + i + src.shape[0]].copy_(src)

    # -- background refresh ------------------------------------------------

    def start_refresh(self):
        """Start the background re-draw of the next block (host decode
        only; the device is touched on the owner thread alone)."""
        if self._refresh_rows <= 0 or self._refresher is not None:
            return

        def work():
            rows = min(self._refresh_rows, self.n)
            xs, ys = self._load_rows(rows)
            with self._pending_lock:
                self._pending = (xs, ys, self._next_offset)
            self._next_offset = (self._next_offset + rows) % self.n

        self._refresher = threading.Thread(target=work, daemon=True)
        self._refresher.start()

    def maybe_swap(self) -> bool:
        """At an epoch boundary: if a refreshed block is ready, upload it
        over the rows it replaces (two spans where it wraps past the end).
        Returns whether a swap happened. Never waits for the refresher: a
        slow host leaves the augmentations alone to re-randomize."""
        if self._refresher is not None and not self._refresher.is_alive():
            self._refresher = None
        with self._pending_lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return False
        xs, ys, offset = pending
        rows = xs.shape[0]
        head = min(rows, self.n - offset)
        for cache, block in ((self.cache_x, xs), (self.cache_y, ys)):
            self._upload(cache, block[:head], offset)
            if head < rows:  # wrap
                self._upload(cache, block[head:], 0)
        self.uploaded_rows += rows
        self.swaps += 1
        return True

    # -- epoch iteration -----------------------------------------------------

    def epoch_batches(self, batch_size: int, generator: torch.Generator):
        """Yield ``(clean, noisy)`` NCHW float32 device batches for one
        epoch in drop-last order: the epoch's permutation is uploaded once,
        then every batch is gathered and augmented on the device, its draws
        taken from ``generator`` (a generator on the cache's device)."""
        nb = self.n // batch_size
        perm = torch.from_numpy(self._rng.permutation(self.n)).to(self.device)
        for step in range(nb):
            yield self.batch(perm[step * batch_size:(step + 1) * batch_size], generator)

    def batch(self, idxs: torch.Tensor, generator: torch.Generator):
        """The rows ``idxs`` (a device tensor) gathered and augmented: NCHW
        float32 (clean, noisy)."""
        x, y = augment(self.cache_x[idxs].float(), self.cache_y[idxs].float(),
                       *self.draws(idxs.shape[0], generator),
                       self.exp_mult_min, self.exp_mult_max)
        return x.permute(0, 3, 1, 2).contiguous(), y.permute(0, 3, 1, 2).contiguous()

    def draws(self, batch_size: int, generator: torch.Generator):
        """One batch's augmentation draws (nrot, fv, fh, u) on the device."""
        kw = {"generator": generator, "device": self.device}
        nrot = torch.randint(0, 4, (batch_size,), **kw)
        fv = torch.rand(batch_size, **kw) < 0.5
        fh = torch.rand(batch_size, **kw) < 0.5
        return nrot, fv, fh, torch.rand(batch_size, **kw)

    def nbytes(self) -> int:
        return self.cache_x.nbytes + self.cache_y.nbytes

    def __len__(self):
        return self.n
