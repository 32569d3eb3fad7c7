"""Copy images whose EXIF ISO <= maxISO (clean-clean dataset preparation).

Counterpart of ``nind_denoise_tpu/tools/filter_dataset_by_iso.py`` (the
reference's tools/filter_dataset_by_iso.py:1-42), on the host. ISO probing
follows the reference's libimganalysis.get_iso: piexif for JPEG where it is
installed, else PIL's EXIF reader, else exiftool for other formats.

    python -m nind_denoise_tpu_torch.tools.filter_dataset_by_iso \
        --src_dir <photos> --dst_dir <clean> --max_iso 200
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
from typing import Optional

ISO_TAG = 34855  # EXIF PhotographicSensitivity


def get_iso(fpath: str) -> Optional[int]:
    if fpath.lower().endswith((".jpg", ".jpeg")):
        try:
            import piexif  # type: ignore

            val = piexif.load(fpath)["Exif"].get(ISO_TAG)
            if isinstance(val, int):
                return val
        except Exception:
            pass
        try:
            from PIL import Image

            with Image.open(fpath) as im:
                val = im.getexif().get(ISO_TAG)
                if isinstance(val, int):
                    return val
        except Exception:
            pass
    if shutil.which("exiftool"):
        res = subprocess.run(["exiftool", "-S", "-ISO", fpath],
                             text=True, capture_output=True).stdout
        try:
            return int(res.split(": ")[-1])
        except (ValueError, IndexError):
            return None
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--src_dir", required=True)
    p.add_argument("--dst_dir", required=True)
    p.add_argument("--max_iso", type=int, default=200)
    args = p.parse_args(argv)
    os.makedirs(args.dst_dir, exist_ok=True)
    kept = skipped = 0
    for fn in sorted(os.listdir(args.src_dir)):
        fpath = os.path.join(args.src_dir, fn)
        if not os.path.isfile(fpath):
            continue
        iso = get_iso(fpath)
        if iso is not None and iso <= args.max_iso:
            shutil.copy2(fpath, os.path.join(args.dst_dir, fn))
            kept += 1
        else:
            skipped += 1
    print(f"kept {kept}, skipped {skipped}")


if __name__ == "__main__":
    main()
