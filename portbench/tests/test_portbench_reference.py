"""The plain reference against the program at tiny sizes on the CPU, in
float32: if the two did not agree where both are exact, the check on the
card would compare against the wrong thing. Also the operation count
behind K2's bound."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import gen, yardstick
from portbench.reference import nets, rl, tiling
from portbench.reference import train as rtrain

torch.set_num_threads(4)


def program_model(network, funit, weights):
    from nind_denoise_tpu_torch.models import build

    kw = {"funit": funit, "activation": "PReLU"} if network == "UtNet" else {}
    m = build(network, **kw)
    m.load_state_dict({k: v.float() for k, v in weights.items()})
    return m


@pytest.fixture(params=[("UtNet", 8, 104), ("UNet", None, 64)], ids=["utnet", "unet"])
def net(request):
    network, funit, cs = request.param
    return network, funit, cs, gen.weights(network, funit, torch.float32, "cpu", 11)


def test_state_dict_names_match_the_program(net):
    network, funit, _, w = net
    prog = program_model(network, funit, w)
    assert set(prog.state_dict()) == set(w)


def test_forward(net):
    network, funit, cs, w = net
    x = torch.rand((2, 3, cs, cs), generator=torch.Generator().manual_seed(3))
    prog = program_model(network, funit, w).eval()
    with torch.no_grad():
        got, ref = prog(x), nets.forward(network, w, x)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_unet_train_mode_forward():
    w = gen.weights("UNet", None, torch.float32, "cpu", 12)
    x = torch.rand((2, 3, 48, 48), generator=torch.Generator().manual_seed(4))
    prog = program_model("UNet", None, w).train()
    torch.testing.assert_close(prog(x), nets.forward("UNet", w, x, train=True),
                               rtol=1e-5, atol=1e-5)


def test_tiled_canvas_equals_the_engine():
    from nind_denoise_tpu_torch.engine import tile_engine

    w = gen.weights("UtNet", 8, torch.float32, "cpu", 13)
    traffic = {"pool": 2, "shape": [130, 170], "portrait_every": 2, "noise_sigmas": [0.05],
               "scene_cells": 5, "texture_cells": 30}
    for raw in gen.photos(traffic, "cpu", 5):
        eng = tile_engine.AdaptiveEngine("UtNet", program_model("UtNet", 8, w), cs=104, ucs=88,
                                         batch_size=3, compute_dtype="float32", device="cpu")
        got = eng.denoise_raw(raw, 65535.0, out_dtype="device")
        x = torch.from_numpy(raw.astype(np.float32)) / 65535.0
        ref = tiling.denoise(lambda t: nets.forward("UtNet", w, t), x, 104, 88, 6, 3)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_tile_grid_matches_the_program():
    from nind_denoise_tpu_torch.core.tiles import TilePlan

    for h, w, cs, ucs in ((2000, 3000, 504, 480), (3000, 2000, 440, 320), (130, 170, 104, 88)):
        plan = TilePlan(h, w, cs, ucs, 6)
        got = [(plan.spec(i).abs_y0, plan.spec(i).abs_x0) for i in range(plan.ntiles)]
        assert got == tiling.tiles(h, w, ucs, 6)


def test_rl_and_quantize():
    from nind_denoise_tpu_torch.ops import rl_deblur

    g = torch.Generator().manual_seed(6)
    canvas = 1.2 * torch.rand((40, 56, 3), generator=g) - 0.1
    for sigma, iters in ((1.0, 10), (2.0, 3)):
        got = rl_deblur.rl_deblur(torch.clamp(canvas, min=0), sigma, iters)
        ref = rl.deblur(torch.clamp(canvas, min=0), sigma, iters)
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-6)
        got_u8 = rl_deblur.rl_to_u8_device(canvas, sigma, iters).int()
        assert (got_u8 - rl.to_u8(canvas, sigma, iters).int()).abs().max() <= 1


def test_losses():
    from nind_denoise_tpu_torch.ops import losses

    g = torch.Generator().manual_seed(7)
    a, b = torch.rand((2, 3, 170, 170), generator=g), torch.rand((2, 3, 170, 170), generator=g)
    b = 0.7 * a + 0.3 * b
    torch.testing.assert_close(losses.ms_ssim(a, b), rtrain.ms_ssim(a, b), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        rtrain.loss(a, b, {"MSE": 1.0}, 161), losses.mse_loss(rtrain.centre(a, 161),
                                                              rtrain.centre(b, 161)).mean())


@pytest.mark.parametrize("network,funit,cs,loss_cs,weights", [
    ("UtNet", 8, 168, 168, {"MSSSIM": 1.0}), ("UNet", None, 48, 40, {"MSE": 1.0})],
    ids=["utnet", "unet"])
def test_train_steps(network, funit, cs, loss_cs, weights):
    """Three steps of the program's train step and of the reference from
    the same weights on the same batches: the same losses, first gradient
    and parameters, to float32 rounding."""
    from nind_denoise_tpu_torch.train import steps

    w = gen.weights(network, funit, torch.float32, "cpu", 14)
    traffic = {"pool": 8, "noise_sigma_range": [0.02, 0.08], "scene_cells": 4,
               "texture_cells": 20}
    clean, noisy = gen.pairs(traffic, cs, "cpu", 15)
    batches = [(clean[i:i + 2].permute(0, 3, 1, 2).float(),
                noisy[i:i + 2].permute(0, 3, 1, 2).float()) for i in (0, 2, 4)]
    model = program_model(network, funit, w).train()
    state = steps.TrainState(model, steps.make_optimizer(model, 1e-4, 0.75))
    step = steps.make_generator_train_step(steps.plain_apply, weights, loss_cs)
    losses = []
    for k, (c, n) in enumerate(batches):
        losses.append(float(step(state, c, n)["weighted"]))
        if k == 0:
            g1 = {name: mu / 0.25 for (name, _), mu in
                  zip(model.named_parameters(), state.opt.moments("mu"))}
    ref_losses, ref_g1, ref_p = rtrain.train_steps(
        network, w, batches, {"lr": 1e-4, "beta1": 0.75}, weights, loss_cs)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-6)
    # after a step, rounding in near-zero gradients moves weights by up to
    # 2 lr (AMSGrad), which moves UNet's later losses by ~2e-4
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    # the first gradient by the check's measure: UtNet reads ~0; UNet's
    # float32 gradients read 5.7e-4 apart at this size, while in float64
    # the two sides agree to 3e-8 (the program's float32 BatchNorm
    # backward is the further of the two from float64 here)
    gap, _ = yardstick.worst_leaf_gap({k: float(v.norm()) for k, v in g1.items()},
                                      {k: float(v.norm()) for k, v in ref_g1.items()})
    assert gap < 2e-3
    for name, p in model.named_parameters():
        # AMSGrad's steps are lr * sign-like: rounding in a near-zero
        # gradient can flip one, so after three steps the parameters agree
        # to 2 lr a step
        assert (p.detach() - ref_p[name]).abs().max() <= 3 * 2e-4


def test_k2_bound_counts_level_one():
    """The meta-device count of UtNet's level 1 (reflect pad, two 3x3 VALID
    convs) at one 504 x 504 tile equals the hand count behind K2's bound."""
    from torch.utils.flop_counter import FlopCounterMode

    w = {k: torch.empty(s, device="meta") for k, s, _ in nets.utnet_shapes(64)}
    x = torch.empty((1, 3, 504, 504), device="meta")
    with FlopCounterMode(display=False) as fc:
        t = torch.nn.functional.pad(x, (2, 2, 2, 2), mode="reflect")
        t = nets.prelu(torch.nn.functional.conv2d(t, w["convs1.0.weight"], w["convs1.0.bias"]),
                       w["convs1.1.weight"])
        torch.nn.functional.conv2d(t, w["convs1.2.weight"], w["convs1.2.bias"])
    flops, _ = yardstick.enc1_level1(1, 504, 504, 64)
    assert fc.get_total_flops() == flops
    # and the K2 row of the kernel table: 0.1586 ms at batch 8 at the bf16 peak
    assert abs(yardstick.bound_s(*reversed(yardstick.enc1_level1(8, 504, 504)),
                                 "bfloat16")[0] * 1e3 - 0.1586) < 5e-4


def test_k1_bound_matches_the_kernel_table():
    fl, nb = yardstick.rl_iteration(3, 2000, 3000, 3)
    s, by = yardstick.bound_s(nb, fl, "float32")
    assert by == "bytes" and abs(s * 1e3 - 0.06448) < 5e-5


def test_percentile():
    assert yardstick.percentile(list(range(101)), 90) == 90
    assert yardstick.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def test_photos_are_decoder_layout():
    """The pool's images are C-contiguous HWC uint16, as a decoder hands
    them over: a strided view would add a host transpose to every image."""
    traffic = {"pool": 3, "shape": [40, 60], "portrait_every": 3, "noise_sigmas": [0.05],
               "scene_cells": 4, "texture_cells": 10}
    for i, raw in enumerate(gen.photos(traffic, "cpu", 2 ** 31 + 3)):
        assert raw.dtype == np.uint16 and raw.flags["C_CONTIGUOUS"]
        assert raw.shape == ((60, 40, 3) if i == 2 else (40, 60, 3))


def test_train_steps_in_float64():
    """The reference's float64 step (the second witness on the card) lands
    within float32 rounding of its float32 step."""
    w = gen.weights("UtNet", 8, torch.float32, "cpu", 16)
    traffic = {"pool": 4, "noise_sigma_range": [0.02, 0.08], "scene_cells": 4,
               "texture_cells": 20}
    clean, noisy = gen.pairs(traffic, 168, "cpu", 17)
    batch = [(clean[:2].permute(0, 3, 1, 2).float(), noisy[:2].permute(0, 3, 1, 2).float())]
    args = ("UtNet", w, batch, {"lr": 1e-4, "beta1": 0.75}, {"MSSSIM": 1.0}, 168)
    l32, g32, _ = rtrain.train_steps(*args)
    l64, g64, _ = rtrain.train_steps(*args, dtype=torch.float64)
    assert all(v.dtype == torch.float64 for v in g64.values())
    np.testing.assert_allclose(l32, l64, rtol=1e-5)
    gap, _ = yardstick.worst_leaf_gap({k: float(v.norm()) for k, v in g32.items()},
                                      {k: float(v.norm()) for k, v in g64.items()})
    assert gap < 1e-3


def test_block_means_find_one_wrong_block():
    """The photo check's local reading: blocks of at most ``block`` a side,
    split evenly, ragged edges included; one wrong block among 35 reads
    whole where the image's mean reads ~3 %."""
    from portbench.loops.photos import block_means

    off = torch.zeros((2000, 3000, 3))
    off[800:1200, 1287:1716] = 1.0  # one of the 5 x 7 blocks, 400 x 429
    means = block_means(off, 480)
    assert means.shape == (35,)
    assert float(means.max()) == 1.0 and float(off.mean()) < 0.03
    assert float(block_means(torch.ones((7, 5, 1)), 3).min()) == 1.0
