"""Pick N random (clean, noisy) crop pairs from the test-reserve sets.

Counterpart of ``nind_denoise_tpu/tools/pick_validation_set.py`` (the
reference's tools/pick_validation_set.py:1-73), on the host: samples pairs
from sets in the test reserve only and writes
``<out_dir>/validation_set_<N>_<ds>_<reserve>.yaml``, the list the
trainer's ``--validation_set_yaml`` reads.

    python -m nind_denoise_tpu_torch.tools.pick_validation_set \
        --train_data <cropped>/NIND_256_192 --test_reserve <reserve.yaml> -n 300
"""

from __future__ import annotations

import os
import random

import yaml

from ..train import dataset as ds_mod
from ..utils import conf


def build_parser():
    p = conf.LayeredArgumentParser(
        description=__doc__, default_config_files=[conf.common_config_fpath()])
    p.add_argument("--number", "-n", type=int, default=300)
    p.add_argument("--train_data", nargs="*", required=True)
    p.add_argument("--test_reserve", nargs="*", required=True)
    p.add_argument("--out_dir", default="configs")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    from ..train.loop import get_test_reserve_list

    args = build_parser().parse_known_args_layered(argv)[0]
    reserve = get_test_reserve_list(args.test_reserve)
    reserve_tag = (os.path.splitext(os.path.basename(args.test_reserve[0]))[0]
                   if len(args.test_reserve) == 1
                   and str(args.test_reserve[0]).endswith(".yaml")
                   else "reserve")

    # only the reserved sets are scanned
    rng = random.Random(args.seed)
    pairs = []
    for datadir in args.train_data:
        for aset in sorted(os.listdir(datadir)):
            if not any(s in aset for s in reserve):
                continue
            bisos, isos = ds_mod.sort_isos(os.listdir(os.path.join(datadir, aset)))
            base_dir = os.path.join(datadir, aset, bisos[0])
            for fn in sorted(os.listdir(base_dir)):
                clean = os.path.join(base_dir, fn)
                for iso in isos:
                    noisy = os.path.join(datadir, aset, iso,
                                         fn.replace(bisos[0] + "_", iso + "_"))
                    if os.path.isfile(noisy):
                        pairs.append([clean, noisy])
    if not pairs:
        raise SystemExit("pick_validation_set: no reserved crop pairs found")
    rng.shuffle(pairs)
    pairs = pairs[:args.number]
    ds_name = os.path.basename(os.path.normpath(args.train_data[0]))
    out_fpath = os.path.join(
        args.out_dir, f"validation_set_{len(pairs)}_{ds_name}_{reserve_tag}.yaml")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(out_fpath, "w") as fp:
        yaml.safe_dump(pairs, fp)
    print(f"wrote {out_fpath} ({len(pairs)} pairs)")
    return out_fpath


if __name__ == "__main__":
    main()
