"""Results grapher: SSIM / MSE vs ISO plots across experiment directories.

Counterpart of ``nind_denoise_tpu/eval/grapher.py`` (the reference's
tools/grapher.py:1-183 + graph_utils.py), on the host: parses
``res.csv``/``res.txt`` files under experiment result directories (rows
``filename,ssim,mse`` where filename encodes the ISO, as ``denoise_dir``'s
``gen_score`` writes them) and plots one curve per experiment. matplotlib is
imported when a plot is drawn, with the Agg backend, so the tool runs
headless; the parsers need nothing beyond the standard library.

    python -m nind_denoise_tpu_torch.eval.grapher <result dirs> -o graph.png
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from typing import Dict, List, Optional, Tuple


def iso_of(filename: str) -> Optional[str]:
    m = re.search(r"ISOH?\d+(-\d+)?", filename)
    return m.group(0) if m else None


def iso_sort_key(iso: str) -> Tuple[int, int]:
    if iso.startswith("ISOH"):
        return (1, int(iso[4:].split("-")[0]))
    return (0, int(iso[3:].split("-")[0]))


def parse_res_file(fpath: str) -> Dict[str, Dict[str, List[float]]]:
    """-> {iso: {'ssim': [...], 'mse': [...]}}"""
    out: Dict[str, Dict[str, List[float]]] = {}
    with open(fpath, "r") as fp:
        reader = csv.reader(fp)
        next(reader, None)  # header
        for row in reader:
            if len(row) < 3:
                continue
            iso = iso_of(row[0])
            if iso is None:
                continue
            d = out.setdefault(iso, {"ssim": [], "mse": []})
            try:
                d["ssim"].append(float(row[1]))
                d["mse"].append(float(row[2]))
            except ValueError:
                continue
    return out


def find_res_files(root: str) -> List[str]:
    hits = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn in ("res.txt", "res.csv"):
                hits.append(os.path.join(dirpath, fn))
    return sorted(hits)


def plot(results_dirs: List[str], metric: str = "ssim",
         out_fpath: str = "results_graph.png", title: Optional[str] = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for rdir in results_dirs:
        files = find_res_files(rdir) if os.path.isdir(rdir) else [rdir]
        for fpath in files:
            per_iso = parse_res_file(fpath)
            if not per_iso:
                continue
            isos = sorted(per_iso, key=iso_sort_key)
            ys = [sum(per_iso[i][metric]) / len(per_iso[i][metric]) for i in isos]
            label = os.path.basename(os.path.dirname(fpath)) or fpath
            ax.plot(isos, ys, marker="o", label=label)
    ax.set_xlabel("ISO")
    ax.set_ylabel(metric.upper())
    ax.set_title(title or f"{metric.upper()} vs ISO")
    ax.legend(fontsize=7)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_fpath, dpi=120)
    plt.close(fig)
    print(f"wrote {out_fpath}")
    return out_fpath


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_dirs", nargs="+",
                   help="experiment result dirs (searched for res.txt/res.csv)")
    p.add_argument("--metric", default="ssim", choices=["ssim", "mse"])
    p.add_argument("-o", "--output", default="results_graph.png")
    p.add_argument("--title")
    args = p.parse_args(argv)
    return plot(args.results_dirs, args.metric, args.output, args.title)


if __name__ == "__main__":
    main()
