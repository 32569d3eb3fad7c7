"""Clean/noisy pair datasets over the pre-cropped NIND directory layout: a
copy of ``nind_denoise_tpu/train/dataset.py`` (numpy + OpenCV only).

It draws from ``random.Random(seed)`` in the same order as the JAX copy,
so one seed gives both packages the same items and, with one loader
thread, the same batches. Parity with the reference's
src/nind_denoise/dataset_torch_3.py:

* ``sort_isos`` (:37-87): ISO<num>[-rep] parsing, ISOH* sorted last, GT*
  handling, base-ISO duplicates.
* ``DenoisingDataset`` (:98-279): scans ``<datadir>/<set>/ISO<val>/*`` with
  dir names encoding ``<DS>_<cs>_<ucs>``; test_reserve exclusion (substring
  or exact); per-item random base-ISO x / random noisy-ISO y; pad/rand-crop
  to cs; rot90 x k + 2 flips augmentation; optional JPEG-compression and
  Gaussian-noise augmentation of y; exposure multiplier
  ``exp_mult in [min, min(max, 1/x.max())]``.
* ``CleanCleanDataset`` (:300-310), ``LazyNoiseDataset`` (:313-323),
  ``TestDenoiseDataset`` (:326-401), ``ValidationDataset`` (:403-428),
  ``PickyDenoisingDatasetFromList`` (:281-298).

Batches come out NHWC float32 numpy through ``Loader``, a threaded
prefetch iterator; the trainer moves them to the device as NCHW.
``list_content_quality`` audits every crop pair by MS-SSIM on the device
(``eval/score.py``) and writes the ``<dsname>-msssim.csv`` that
``PickyDenoisingDatasetFromList`` reads.
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from io import BytesIO
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import yaml

from ..core import imgio

CROP_SIZELIMIT = 10_000_000  # 10 MB per crop file
# host threads that decode crop pairs ahead of the MS-SSIM audit's scoring
# (tools/score_breakdown.py sweeps it on the card)
AUDIT_DECODE_THREADS = 4


def sort_isos(raw_isos: Sequence[str]) -> Tuple[List[str], List[str]]:
    """Split ISO dir names into (base ISOs incl. duplicates, noisy ISOs)."""
    isos: List = []
    bisos: List = []
    if any(iso[:3] != "ISO" for iso in raw_isos):
        for iso in raw_isos:
            if "GT" in iso:
                bisos.append(iso)
            else:
                isos.append(iso)
        isos = sorted(isos)
        if not bisos:
            bisos.append(isos.pop(0))
        return bisos, isos
    hisos: List[str] = []
    dupisos: Dict[str, List[str]] = {}
    for iso in raw_isos:
        if "H" in iso:
            hisos.append(iso)
        elif "-" in iso:
            isoval, _, repid = iso[3:].partition("-")
            isos.append(int(isoval))
            dupisos.setdefault(isoval, []).append(repid)
        else:
            isos.append(int(iso[3:]))
    base, *isos = sorted(isos)
    bisos = [base]
    while isos and bisos[0] == isos[0]:
        bisos.append(str(isos.pop(0)) + "-" + dupisos[str(bisos[0])].pop())
    for dupiso, repids in dupisos.items():
        for repid in repids:
            if int(dupiso) in isos:
                isos[isos.index(int(dupiso))] = f"{dupiso}-{repid}"
    bisos = ["ISO" + str(b) for b in bisos]
    isos = ["ISO" + str(i) for i in isos] + sorted(hisos)
    return bisos, isos


def get_baseline_fpath(dpath: str) -> str:
    """Lowest-ISO image of a whole-image scene directory = ground truth."""
    iso_fn = {fn.split("_")[-1].split(".")[0]: fn for fn in os.listdir(dpath)}
    bisos, _ = sort_isos(list(iso_fn.keys()))
    return os.path.join(dpath, iso_fn[bisos[0]])


class DenoisingDataset:
    def __init__(self, datadirs: Sequence[str], yval: Optional[str] = None,
                 compressionmin: int = 100, compressionmax: int = 100,
                 sigmamin: float = 0, sigmamax: float = 0,
                 test_reserve: Sequence[str] = (), min_crop_size: Optional[int] = None,
                 exact_reserve: bool = False, cs: Optional[int] = None,
                 exp_mult_min: float = 1, exp_mult_max: float = 1,
                 seed: Optional[int] = None, cache_images: bool = False):
        def is_reserved(aset: str) -> bool:
            if exact_reserve:
                return bool(test_reserve) and aset in test_reserve
            return any(s in aset for s in test_reserve)

        self.rng = random.Random(seed)
        self.dataset: List[Tuple[str, List[str], List[str]]] = []
        self.min_crop_size = min_crop_size
        # decode cache for small datasets (decode once, serve from RAM)
        self._cache: Optional[Dict[str, np.ndarray]] = {} if cache_images else None
        if cs is not None:
            self.cs = cs
        else:
            self.cs, parsed_min = (int(i) for i in
                                   os.path.basename(os.path.normpath(datadirs[0]))
                                   .split("_")[-2:])
            if self.min_crop_size is None:
                self.min_crop_size = parsed_min
        self.compressionmin, self.compressionmax = compressionmin, compressionmax
        self.sigmamin, self.sigmamax = sigmamin, sigmamax
        self.exp_mult_min, self.exp_mult_max = exp_mult_min, exp_mult_max
        check = min_crop_size is not None

        for datadir in datadirs:
            for aset in sorted(os.listdir(datadir)):
                if is_reserved(aset):
                    print(f"Skipped {aset} (test reserve)")
                    continue
                bisos, isos = sort_isos(os.listdir(os.path.join(datadir, aset)))
                if yval is not None:
                    if yval == "x":
                        bisos = isos = bisos[0:1]
                    else:
                        isos = [i for i in isos
                                if i.endswith(yval) or i.endswith(yval + "-")]
                        if not isos:
                            print(f"Skipped {aset} ({yval} not found)")
                            continue
                iso_dir = os.path.join(datadir, aset, isos[0])
                for animg in sorted(os.listdir(iso_dir)):
                    imgpath = os.path.join(iso_dir, animg)
                    if check:
                        import cv2

                        dims = cv2.imread(imgpath, flags=cv2.IMREAD_COLOR
                                          + cv2.IMREAD_ANYDEPTH).shape[:2]
                        if any(d < self.min_crop_size for d in dims):
                            print(f"DenoisingDataset: skipping {imgpath} "
                                  f"({dims} < {self.min_crop_size})")
                            continue
                    template = os.path.join(datadir, aset, "ISOBASE",
                                            animg.replace(isos[0] + "_", "ISOBASE_"))
                    self.dataset.append((template, bisos, isos))
                print(f"Added {aset}{bisos}{isos} to the dataset")
        self.dsname = "+".join(os.path.basename(os.path.normpath(p)) for p in datadirs)

    # -- pair selection -------------------------------------------------------

    @staticmethod
    def _resolve(template: str, iso: str) -> str:
        return template.replace("ISOBASE_", iso + "_").replace(
            os.sep + "ISOBASE" + os.sep, os.sep + iso + os.sep)

    def get_x_y_paths(self, index: int) -> Tuple[str, str]:
        template, bisos, isos = self.dataset[index]
        return (self._resolve(template, self.rng.choice(bisos)),
                self._resolve(template, self.rng.choice(isos)))

    def all_crop_pairs(self) -> Iterator[Tuple[str, str]]:
        for template, bisos, isos in self.dataset:
            for b in bisos:
                for n in isos:
                    yield self._resolve(template, b), self._resolve(template, n)

    def list_content_quality(self, export: bool = False, outdir: str = "datasets",
                             device=None):
        """MS-SSIM audit of every (gt, noisy) crop pair -> optional CSV.

        One pair at a time on ``device`` (CUDA unless "cpu"), in
        ``all_crop_pairs`` order, while ``AUDIT_DECODE_THREADS`` host
        threads decode up to twice as many pairs ahead."""
        import concurrent.futures as cf

        from ..eval import score
        from ..utils.device import resolve_device

        def decode(pair):
            return imgio.load_img(pair[0]), imgio.load_img(pair[1])

        dev = resolve_device(device)
        pairs = list(self.all_crop_pairs())
        ahead = 2 * AUDIT_DECODE_THREADS
        rows = []
        with cf.ThreadPoolExecutor(max_workers=AUDIT_DECODE_THREADS) as pool:
            decoded = [pool.submit(decode, p) for p in pairs[:ahead]]
            for i, (xpath, ypath) in enumerate(pairs):
                if i + ahead < len(pairs):
                    decoded.append(pool.submit(decode, pairs[i + ahead]))
                x, y = decoded[i].result()
                decoded[i] = None  # free the pixels
                rows.append((xpath, ypath, score.msssim(score.to_device(x, dev),
                                                        score.to_device(y, dev))))
                print(rows[-1])
        if export:
            from ..utils import utilities

            outpath = os.path.join(outdir, self.dsname + "-msssim.csv")
            utilities.list_of_tuples_to_csv(rows, ("xpath", "ypath", "score"), outpath)
            print(f"Quality check exported to {outpath}")
        return rows

    # -- item assembly ---------------------------------------------------------

    def crop_and_pad(self, ximg: np.ndarray, yimg: np.ndarray):
        assert ximg.shape == yimg.shape, "crops do not match"
        if any(d < self.cs for d in ximg.shape[1:]):
            ximg, yimg = imgio.pad_img_pair(ximg, yimg, self.cs)
        if any(d > self.cs for d in ximg.shape[1:]):
            ximg, yimg = imgio.crop_img_pair(ximg, yimg, self.cs,
                                             imgio.CropMethod.RAND, rng=self.rng)
        return ximg, yimg

    def _load(self, fpath: str) -> np.ndarray:
        cache = getattr(self, "_cache", None)
        if cache is None:
            return imgio.load_img(fpath)
        if fpath not in cache:
            cache[fpath] = imgio.load_img(fpath)
        return cache[fpath]

    def load_pair(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Un-augmented (clean, noisy) pair: random ISO pair choice + random
        crop/pad to cs, nothing else. Each call re-rolls the pair and crop
        like __getitem__ does."""
        xpath, ypath = self.get_x_y_paths(index)
        return self.crop_and_pad(self._load(xpath), self._load(ypath))

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        ximg, yimg = self.load_pair(index)
        # augmentation: rot90 x k + two flips
        nrot = self.rng.randint(0, 3)
        ximg = np.rot90(ximg, nrot, (1, 2))
        yimg = np.rot90(yimg, nrot, (1, 2))
        if self.rng.getrandbits(1):
            ximg, yimg = np.flip(ximg, 1), np.flip(yimg, 1)
        if self.rng.getrandbits(1):
            ximg, yimg = np.flip(ximg, 2), np.flip(yimg, 2)
        ximg, yimg = ximg.copy(), yimg.copy()
        if self.compressionmin < 100:
            from PIL import Image

            quality = self.rng.randint(self.compressionmin, self.compressionmax)
            buf = BytesIO()
            Image.fromarray((np.clip(yimg, 0, 1).transpose(1, 2, 0)
                             * 255).astype(np.uint8)).save(buf, "JPEG", quality=quality)
            yimg = (np.asarray(Image.open(buf), dtype=np.float32) / 255).transpose(2, 0, 1)
        if self.sigmamax > 0:
            sigma = self.rng.uniform(self.sigmamin, self.sigmamax) / 255
            yimg = np.abs(yimg + np.random.default_rng(self.rng.getrandbits(32))
                          .normal(0, sigma, yimg.shape).astype(np.float32))
        if self.exp_mult_min != 1 or self.exp_mult_max != 1:
            exp_mult = self.rng.uniform(self.exp_mult_min,
                                        min(self.exp_mult_max, 1.0 / max(ximg.max(), 1e-8)))
            ximg = ximg * exp_mult
            yimg = np.clip(yimg * exp_mult, 0, 1)
        return ximg, yimg

    def __len__(self) -> int:
        return len(self.dataset)


class PickyDenoisingDatasetFromList(DenoisingDataset):
    """CSV of (xpath, ypath, msssim score) with a min-quality threshold."""

    def __init__(self, csv_fpath: str, min_quality: float = 0,
                 cs: Optional[int] = None, exp_mult_min: float = 1,
                 exp_mult_max: float = 1, seed: Optional[int] = None):
        self.rng = random.Random(seed)
        self.dataset = []
        with open(csv_fpath, "r") as fp:
            for row in csv.DictReader(fp):
                if float(row["score"]) > min_quality:
                    self.dataset.append((row["xpath"], row["ypath"]))
        self.cs = cs
        self.compressionmin = self.compressionmax = 100
        self.sigmamin = self.sigmamax = 0
        self.exp_mult_min, self.exp_mult_max = exp_mult_min, exp_mult_max

    def get_x_y_paths(self, index):
        return self.dataset[index]


class CleanCleanDataset(DenoisingDataset):
    """Clean-image dir -> (x, x) identity pairs (<= 10 MB/crop)."""

    def __init__(self, data_dpath: str, cs: int, crop_sizelimit: int = CROP_SIZELIMIT,
                 seed: Optional[int] = None):
        self.rng = random.Random(seed)
        self.cs = cs
        self.data_dpath = data_dpath
        self.compressionmin = self.compressionmax = 100
        self.sigmamin = self.sigmamax = 0
        self.exp_mult_min = self.exp_mult_max = 1
        self.dataset = [fn for fn in sorted(os.listdir(data_dpath))
                        if os.stat(os.path.join(data_dpath, fn)).st_size <= crop_sizelimit]

    def get_x_y_paths(self, index):
        fpath = os.path.join(self.data_dpath, self.dataset[index])
        return fpath, fpath


class LazyNoiseDataset(DenoisingDataset):
    """Returns (noisy, noisy)."""

    def __getitem__(self, index):
        _, noisy = super().__getitem__(index)
        return noisy, noisy


class TestDenoiseDataset:
    """Full-size test images per scene; gt/ subdir or base-ISO autodetect."""

    def __init__(self, data_dpath: str, sets: Sequence[str] = ()):
        self.ds = []
        for ascene in sorted(os.listdir(data_dpath)):
            scene_dpath = os.path.join(data_dpath, ascene)
            if sets and ascene not in sets:
                continue
            gt_dir = os.path.join(scene_dpath, "gt")
            if os.path.isdir(gt_dir):
                gt_fpath = os.path.join(gt_dir, sorted(os.listdir(gt_dir))[0])
                noisy = [os.path.join(scene_dpath, fn)
                         for fn in sorted(os.listdir(scene_dpath)) if fn != "gt"]
            else:
                isovals = [fn.split("_")[-1].split(".")[0]
                           for fn in os.listdir(scene_dpath)]
                gtval, _ = sort_isos(isovals)
                noisy, gt_fpath = [], None
                for fn in sorted(os.listdir(scene_dpath)):
                    if gtval[0] + "." in fn:
                        gt_fpath = os.path.join(scene_dpath, fn)
                    else:
                        noisy.append(os.path.join(scene_dpath, fn))
            self.ds.append({"gt": gt_fpath, "noisy": noisy})

    def get_imgs(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for scene in self.ds:
            gt = imgio.load_img(scene["gt"])
            for nf in scene["noisy"]:
                yield gt, imgio.load_img(nf)

    def __getitem__(self, index):
        i = 0
        for scene in self.ds:
            for nf in scene["noisy"]:
                if i == index:
                    gt = imgio.crop_to_multiple(imgio.load_img(scene["gt"]), 64)
                    noisy = imgio.crop_to_multiple(imgio.load_img(nf), 64)
                    return gt, noisy
                i += 1
        raise IndexError(index)

    def __len__(self):
        return sum(len(s["noisy"]) for s in self.ds)


class ValidationDataset:
    """yaml list of (clean, noisy) crop-path pairs, center-cropped to cs."""

    def __init__(self, val_tuples, cs: int):
        if isinstance(val_tuples, str):
            with open(val_tuples, "r") as fp:
                val_tuples = yaml.safe_load(fp)
        self.val_tuples = val_tuples
        self.cs = cs

    def __len__(self):
        return len(self.val_tuples)

    def __getitem__(self, i):
        ximg = imgio.load_img(self.val_tuples[i][0])
        yimg = imgio.load_img(self.val_tuples[i][1])
        return imgio.crop_img_pair(ximg, yimg, self.cs, imgio.CropMethod.CENTER)


class Loader:
    """Threaded prefetch iterator -> NHWC float32 (clean, noisy) batches.

    Threads overlap image decoding with the device's steps. drop_last
    semantics match the reference's training loader (nn_train.py:239-240).
    With more than one thread the batch order is only approximate.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_threads: int = 2,
                 prefetch: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def assemble(idxs):
            xs, ys = zip(*(self.dataset[i] for i in idxs))
            x = np.stack(xs).transpose(0, 2, 3, 1)  # NCHW -> NHWC
            y = np.stack(ys).transpose(0, 2, 3, 1)
            return np.ascontiguousarray(x), np.ascontiguousarray(y)

        def worker(my_batches):
            for b in my_batches:
                if stop.is_set():
                    return
                try:
                    item = assemble(b)
                except BaseException as e:  # noqa: BLE001 — a silently dead
                    # daemon worker would hang the training loop forever on
                    # q.get (its batches never arrive); propagate instead
                    q.put(("__loader_error__", e))
                    return
                q.put(item)

        if self.num_threads == 1:
            for b in batches:
                yield assemble(b)
            return
        # round-robin split keeps output order only approximately; training
        # shuffles anyway, so feed order does not matter
        threads = [threading.Thread(
            target=worker, args=(batches[t::self.num_threads],), daemon=True)
            for t in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            for _ in range(nb):
                item = q.get()
                if type(item[0]) is str and item[0] == "__loader_error__":
                    raise RuntimeError(
                        "Loader worker failed while assembling a batch "
                        "(corrupt/unreadable crop?)") from item[1]
                yield item
        finally:
            stop.set()
            while not q.empty():
                q.get_nowait()
