"""Faults planted in the program under a run, to show that the check
catches them: used by the calibration (``calibrate.py``) to read what a
fault does at a cell's size, and by the tests. The benchmark's own runs
never import this module.

- ``unchanged``: the optimizer's step leaves the state as it was.
- ``half_batch``: the train step sees the first half of each batch, so its
  mean is taken over that half alone.
- ``answer_altered``: the delivered uint8 image has one square block at
  its centre, a quarter of its shorter side wide (about a tile, 4 % of a
  6 MP image), inverted where RL produces it.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(name: str):
    from nind_denoise_tpu_torch.ops import rl_deblur
    from nind_denoise_tpu_torch.train import optim, steps

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged":
        patch(optim.AmsGrad, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        make = steps.make_generator_train_step

        def make_half(*a, **k):
            inner = make(*a, **k)

            def step(state, clean, noisy):
                half = clean.shape[0] // 2
                return inner(state, clean[:half], noisy[:half])

            return step

        patch(steps, "make_generator_train_step", make_half)
    elif name == "answer_altered":
        to_u8 = rl_deblur.rl_to_u8_device

        def altered(img, *a, **k):
            out = to_u8(img, *a, **k)
            h, w = out.shape[-3], out.shape[-2]
            side = min(h, w) // 4
            y, x = (h - side) // 2, (w - side) // 2
            out[..., y:y + side, x:x + side, :] = 255 - out[..., y:y + side, x:x + side, :]
            return out

        patch(rl_deblur, "rl_to_u8_device", altered)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
