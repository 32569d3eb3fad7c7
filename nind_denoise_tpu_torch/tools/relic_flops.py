"""relic-flops — the FLOPs and fp32 bounds of chip_smoke.py's relics and
relic_gan phases, counted on the meta device (no data, no card): each
network of ``chip_smoke.RELIC_NETS`` at its batch and size, and each relic
critic's parts of a cGAN batch (30 x 6 x 184², ``--d_funit 32``): its step
(two sides, forward and backward) and the generator's fooling term
(forward, and the backward to the input only). The bound is the larger of
the bytes (input, output and weights, fp32, once) over 3.35 TB/s and the
FLOPs over 67 TFLOP/s (``chip_smoke.bound_ms``). Run from the repository's
root, where chip_smoke.py is:

    python -m nind_denoise_tpu_torch.tools.relic_flops
"""

from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke

from ..models import build


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def forwards():
    out = {}
    for network, kw, shape, *_ in chip_smoke.RELIC_NETS:
        with torch.device("meta"):
            model = build(network, **kw).eval()
            x = torch.empty(shape)
        with torch.no_grad():
            y = model(x)
            flops = _flops(lambda: model(x))
        nbytes = 4 * (x.numel() + y.numel() + sum(p.numel() for p in model.parameters()))
        bound, by = chip_smoke.bound_ms(nbytes, flops, "float32")
        label = network + "".join(f"/{k}" for k, v in kw.items() if v is True)
        out[label] = {"input": list(shape), "tflop": flops / 1e12, "bound_ms": bound,
                      "bound_by": by}
    return out


def critic_parts(batch: int = 30, cs: int = 184):
    out = {}
    for network, widths in chip_smoke.RELIC_GAN_CRITICS:
        with torch.device("meta"):
            model = build(network, **widths).train()
            x = torch.empty(batch, widths["input_channels"], cs, cs)

        def step():
            for _ in range(2):  # the real side, then the fake side
                model(x).square().mean().backward()

        def fooling():
            xi = x.detach().requires_grad_()
            model(xi, frozen=True).square().mean().backward()

        s, f = _flops(step), _flops(fooling)
        out[network] = {"disc_step_tflop": s / 1e12, "fooling_term_tflop": f / 1e12,
                        "bound_ms_fp32": (s + f) / (chip_smoke.PEAK_FLOPS["float32"] * 1e-3)}
    return out


def main():
    print(json.dumps({"forwards": forwards(), "critics": critic_parts()}, indent=1))


if __name__ == "__main__":
    main()
