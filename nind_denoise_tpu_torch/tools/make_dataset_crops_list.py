"""Crop-quality CSV: MS-SSIM for every (gt, noisy) crop pair.

Counterpart of ``nind_denoise_tpu/tools/make_dataset_crops_list.py`` (the
reference's tools/make_dataset_crops_list.py:1-39): the same CSV, consumed
by ``PickyDenoisingDatasetFromList``, scored on the device (``--device``,
CUDA unless ``cpu``).

    python -m nind_denoise_tpu_torch.tools.make_dataset_crops_list \
        --train_data <cropped>/NIND_256_192 --out_dir datasets
"""

from __future__ import annotations

import argparse
import os

from ..train import dataset as ds_mod


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_data", nargs="*", required=True)
    p.add_argument("--out_dir", default="datasets")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    ds = ds_mod.DenoisingDataset(args.train_data, cs=None)
    os.makedirs(args.out_dir, exist_ok=True)
    return ds.list_content_quality(export=True, outdir=args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
