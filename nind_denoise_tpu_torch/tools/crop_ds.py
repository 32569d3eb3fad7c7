"""Dataset tile cropper: whole scenes -> overlapping cs x cs training crops.

Counterpart of ``nind_denoise_tpu/tools/crop_ds.py`` (the reference's
tools/crop_ds.py:1-78 + crop_img.sh:1-82), on the host with OpenCV: crops
are pixel-identical for PNG/TIFF sources; JPEG crops are re-encoded at
quality 100 unless jpegtran is on the PATH, and jpegtran is used only where
its crop is exact (origin and size on 16-px boundaries).

Output layout (parsed back by DenoisingDataset):
    <resdir>/<DS>_<cs>_<stride>/<set>/ISO<val>/<orig-stem>_<x>_<y>_<stride>.<ext>
Duplicate ISO directory names get a ``-2`` suffix (crop_ds.py:49-56).
CS and stride (=UCS) must be multiples of 8 (crop_img.sh precondition).

    python -m nind_denoise_tpu_torch.tools.crop_ds --cs 256 --stride 192 \
        --orig_data <datasets>/NIND --resdir <datasets>/cropped
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
from typing import List, Tuple


def crop_grid(width: int, height: int, cs: int, stride: int) -> List[Tuple[int, int]]:
    """Top-left corners covering the image with stride; edge tiles clamp."""
    xs = list(range(0, max(width - cs, 0) + 1, stride)) or [0]
    ys = list(range(0, max(height - cs, 0) + 1, stride)) or [0]
    if xs[-1] + cs < width:
        xs.append(width - cs)
    if ys[-1] + cs < height:
        ys.append(height - cs)
    return [(x, y) for y in ys for x in xs]


def _crop_jpegtran(src: str, dst: str, x: int, y: int, cs: int) -> bool:
    if shutil.which("jpegtran") is None:
        return False
    r = subprocess.run(["jpegtran", "-crop", f"{cs}x{cs}+{x}+{y}", "-copy",
                        "none", "-outfile", dst, src], capture_output=True)
    return r.returncode == 0 and os.path.isfile(dst)


def crop_image(src_fpath: str, out_dir: str, cs: int, stride: int) -> int:
    import cv2

    img = cv2.imread(src_fpath, flags=cv2.IMREAD_COLOR + cv2.IMREAD_ANYDEPTH)
    if img is None:
        print(f"crop_ds: cannot decode {src_fpath}")
        return 0
    h, w = img.shape[:2]
    if h < cs or w < cs:
        print(f"crop_ds: {src_fpath} smaller than cs={cs}, skipping")
        return 0
    stem, ext = os.path.splitext(os.path.basename(src_fpath))
    is_jpeg = ext.lower() in (".jpg", ".jpeg")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for x, y in crop_grid(w, h, cs, stride):
        dst = os.path.join(out_dir, f"{stem}_{x}_{y}_{stride}{ext}")
        if os.path.isfile(dst):
            n += 1
            continue
        # jpegtran rounds a non-iMCU-aligned origin down (up to 15 px at
        # 4:2:0), so its pixels would not match the _x_y_ name, and a
        # clean/noisy pair where one file took the cv2 path would be
        # misaligned. Use it only where it is exact: origin and size on
        # 16-px boundaries (every JPEG sampling's iMCU divides 16).
        if is_jpeg and x % 16 == 0 and y % 16 == 0 and cs % 16 == 0 \
                and _crop_jpegtran(src_fpath, dst, x, y, cs):
            n += 1
            continue
        crop = img[y:y + cs, x:x + cs]
        if is_jpeg:
            cv2.imwrite(dst, crop, [cv2.IMWRITE_JPEG_QUALITY, 100])
        else:
            cv2.imwrite(dst, crop)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cs", type=int, default=256, help="crop size")
    p.add_argument("--stride", "--ucs", type=int, default=192)
    p.add_argument("--orig_data", default=os.path.join("..", "..", "datasets", "NIND"))
    p.add_argument("--resdir", default=os.path.join("..", "..", "datasets", "cropped"))
    p.add_argument("--workers", type=int,
                   default=max(1, (os.cpu_count() or 2) // 2))
    args = p.parse_args(argv)
    if args.cs % 8 or args.stride % 8:
        raise SystemExit("crop_ds: cs/stride must be multiples of 8")

    ds_name = os.path.basename(os.path.normpath(args.orig_data))
    out_root = os.path.join(args.resdir, f"{ds_name}_{args.cs}_{args.stride}")
    jobs = []
    for aset in sorted(os.listdir(args.orig_data)):
        set_dir = os.path.join(args.orig_data, aset)
        if not os.path.isdir(set_dir):
            continue
        seen_isos = {}
        for fn in sorted(os.listdir(set_dir)):
            iso = fn.rsplit("_", 1)[-1].split(".")[0]
            # duplicate ISO values get a -2 suffix (crop_ds.py:49-56)
            if iso in seen_isos:
                seen_isos[iso] += 1
                iso = f"{iso}-{seen_isos[iso]}"
            else:
                seen_isos[iso] = 1
            jobs.append((os.path.join(set_dir, fn), os.path.join(out_root, aset, iso)))

    with concurrent.futures.ThreadPoolExecutor(max_workers=args.workers) as ex:
        total = sum(ex.map(lambda job: crop_image(*job, args.cs, args.stride), jobs))
    print(f"crop_ds: wrote {total} crops under {out_root}")
    return total


if __name__ == "__main__":
    main()
