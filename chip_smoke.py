#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nind_denoise_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (every line carries the card's name and power
limit as nvidia-smi reports them):

1. build every kernel in ``nind_denoise_tpu_torch/csrc`` (one nvcc each,
   all at once);
2. K2 (enc1) against its plain PyTorch version on the card, at the product
   batch (8 x 504 x 504, funit 64) in bf16 and fp32, at 2 x 104 x 136, and
   at the server's adapted (136 x 136) and tiny-path (104 x 104) tiles;
   each shape also times cuDNN's own level 1 (channels_last convolutions,
   PReLU, max pool) as the library yardstick;
3. RL against a loop of its plain iteration, at 2000 x 3000 x 3, sigma
   1, 10 iterations, plus the short-tail heights, sigma 3, a 6000-wide
   strip, a ragged 97 x 131, and one case of each route with its launch
   counts: sigma 6 and 10 on K1, 11 on K3 blurs, 22 on the plain blur; a
   batch of 3 that must equal its single runs bit for bit; K1's times at
   sigma 1 and 10 at 6 MP and at the server's (24, 480, 480) planes, with
   a sequence of cuDNN calls as their library yardstick, and each
   separable route's time per iteration at 6 MP;
4. K3 (the standalone Gaussian blur) against its plain version at
   2000 x 3000 x 3 for sigma 1, 3 and 21 (r = 63, the largest radius
   under the limit), at 97 x 131, 5 x 7 (smaller than its radius) and
   24 x 6000; its planar entry at (3, 2000, 3000) for R 30, 33 and 64,
   each timed beside a replicate pad and two depthwise convolutions; every
   radius 1-64 on a ragged 75 x 77 x 3 image and ragged (2, 75, 77)
   planes; sigma 22 must raise;
5. end to end: a seeded 16-bit 2000 x 3000 TIFF and a seeded funit-64 .npz
   checkpoint through ``denoise_cli --tiff-input`` in bf16 to a JPEG,
   with the kernel launch counts of that run; then a small image in fp32
   on the card and on the CPU, whose pre-encode uint8 images must agree to
   1 LSB;
5b. fetch: the port's downloads. The model table's: ``denoise_cli`` with
   no model flag, the table's entry at a missing path whose ``url`` is the
   ``file://`` URI of end_to_end's checkpoint, on the same TIFF in bf16: the
   checkpoint fetched byte-equal with no ``.part`` left, the pre-encode
   uint8 within 1 LSB of end_to_end's ``--model_path`` run, K2 once a tile
   batch and K1 10 times, nothing fetched by a second run, and a missing
   URL raising the port's ``RuntimeError`` with no JPEG and no ``.part``.
   The NIND downloader (``tools/dl_ds.py``): the dataset_tools and eval
   phases' seeded scenes served by a stand-in for Wikimedia Commons on a
   loopback port (the API's ``imageinfo`` answers and the files' bytes),
   downloaded from a two-set manifest in the pinned form into the tree
   those phases read, every file sha1-equal to its source; a second run
   fetches nothing; a file served corrupt exits 1 after MAX_ATTEMPTS tries
   and is named;
6. serve: ``DenoiseService`` behind ``serve()`` on a loopback port, bf16,
   batch 8, cs 504 / ucs 480, driven with urllib: six 6 MP 16-bit PNGs
   that must equal the engine + RL run directly, bit for bit; 480 x 480
   requests, one at a time, then eight at once, coalesced, with one RL
   dispatch per group, each within 1 LSB of its serial response and the
   group's canvases within one bf16 ulp of each image's own run; 40
   free-running bursts of eight for the rates, and 8 more under the
   profiler for the device's busy share; an adapted and a tiny-image
   request; a reload to a second checkpoint;
7. the K2 and K1 inputs of every shape the serve traffic gave the kernels
   (kept by a wrapper that still launches once per call), each against
   the plain version at the limits of phases 2 and 3; then the batch
   witness: one tile in all eight slots against the tile alone, where K2
   must give every slot the tile's own bits and cuDNN is reported slot by
   slot.

8. cli_plugin: the darktable plugin's own command line (its Lua template
   filled, no model flag) in a working directory that holds a seeded
   funit-64 ``models/nind/generator_650.pt``, on a 6 MP 16-bit TIFF at
   sigma 1 and 10; each pre-encode uint8 within 1 LSB of a
   ``--model_path`` run; the warm ``-v`` stage split, and the checkpoint
   load built on the meta device beside an eager build + load;
9. cli_raw: a RAW file and its XMP sidecar through the darktable stand-in
   (``tools/fixtures.py``: stage 1 a seeded 6 MP float32 TIFF, stage 2 the
   denoised image as 16-bit), the darktable command lines held to the
   argv contract, the stage split with develop and stage2;
10. cli_dir: a directory of four 6 MP TIFFs: one checkpoint load and one
   engine, each output within 1 LSB of that file's own run, the wall of
   each image and the first image's load;
11. whole_image: ``denoise_image --whole_image --pad 8`` on a 6 MP 16-bit
   TIFF in bf16: wall, peak device memory, and K2 at its whole-image input
   against its plain version (4 bf16 ulps), timed beside its bound, its
   plain version and cuDNN's level 1.

12. qconv: P1 (the int8 conv) against its plain version at every int8 conv
   shape of the funit-64 forward on 8 x 504^2 tiles, in every epilogue
   variant the forward uses (int32 sums; fp32 raw sums with per-sample or
   the level-4 parity scales; bf16 with bias and PReLU; the decoder's fp32
   sum with its addend and bias map; int8 out with a static scale),
   bit-equal on the batch's first samples; per shape its time (bf16 with
   bias, and the forward's own epilogue), bounds, plain time,
   ``torch._int_mm`` over an im2col and cuDNN's bf16 conv; what torch on
   the card offers for an int8 conv;
13. deriche: P2 (the Deriche IIR, a chunked scan) at (3, 2000, 3000) and
   (24, 480, 480), sigma 1 and 10, along each axis, and at lines longer
   than a tile's segment ((1, 6, 40000) along W, (3, 9000, 24) along H: a
   carry launch and the main one): bit-equal to ``deriche_axis_chunked``,
   its order in plain torch, and within ``error_bound`` (4 x 2^-24 x the
   feedback's two impulse-response sums x max|x|) of the sequential loop
   run in float64, a bound the plain fp32 loop must meet too;
14. int8: ``denoise_cli --tiff-input`` on the 6 MP TIFF with
   ``--compute_dtype int8`` and ``int8_static`` (P1, K2, K1 launches, wall,
   device time, PSNR against a float32 run at or above 45 / 42 dB), and
   the forward alone per batch of 8 x 504^2 against bf16;
15. int8_serve: a server window in int8_static, each response bit-equal
   to the engine + RL run of its request, no coalesced engine group;
16. gmic_fast_cli and rl_dt: ``denoise_cli --rl-psf gmic_fast`` at 6 MP
   (40 P2 launches, no K1); RL with gmic_fast through P2 against RL with
   P2 swapped for its plain loop, uint8 within 1 LSB and at least 99.9 %
   equal, at 6 MP sigma 1 and a server group at sigma 10; and RL with dt
   0.5 (20 K3 launches, no K1) bit-equal to the plain iteration.
17. train: ``train.loop`` with ``train_conf_utnet_std.yaml`` (UtNet funit 64,
   batch 30, 184 px crops, MS-SSIM) for two epochs on seeded synthetic
   16-bit crops in the NIND layout: finite losses, ``trainres.json`` with
   ``best_epoch``, a checkpoint that ``load_generator`` loads and that
   resumes for one more epoch, and K2 launched once per validation pair and
   validation (training steps take cuDNN), and K2 at that fp32 input against
   its plain version; warm step times in fp32 and bf16 (ms a step, crops/s,
   peak memory, top device kernels); one fp32 step on the card against the
   CPU at batch 2, resumed from the run's checkpoint (weights and optimizer
   state), within the TRAIN_* tolerances, and the same step from a fresh
   optimizer state reported beside it.
18. gan: the same config with ``--weight_D1 0.2 --d_lr 1e-4`` (a conditional
   Hul112Disc at d_funit 32) for two epochs: finite losses, discriminator
   checkpoints, K2 launched once per discriminator learn (the generator
   forward before each discriminator step) and once per validation pair
   and validation; a resume from both checkpoints carrying Adam's count and
   the plateau scheduler; K2 at the learn forward's (30, 3, 188, 188) input
   against its plain version, fp32 bit-equal and bf16 within 4 ulps, each
   timed beside cuDNN's level 1 and its bound; warm times in fp32 and bf16
   of the discriminator step, the generator step with the D1 term, the
   learn forward and a batch in which both networks learn (peak memory,
   the FLOP bound from the run's own count, top device kernels); one
   discriminator step and one generator step on the card against the CPU
   at batch 2, resumed from the run's checkpoints with the same targets,
   within the GAN_* tolerances; then ``--device_cache 64`` for two epochs:
   the cache's bytes, a swap, no host-to-device copy in an epoch's steps
   but the permutation's, the sampler's time per batch, and steps per
   second against the host loader's.
19. dataset_tools: two seeded sets laid out as NIND (an ISO100 baseline and
   three noisy ISOs, 6 MP 16-bit PNGs, as fetch downloaded them): ``crop_ds`` at 256 / 192 (1,408
   crops), the MS-SSIM audit of every crop pair on the card
   (``make_dataset_crops_list``, 1,056 pairs: crops/s, pairs/s, the scoring
   share of its wall, one pair's device time and kernel count; no kernel
   launches), 16 of its scores against the CPU's on the same files (1e-6),
   the CSV through ``PickyDenoisingDatasetFromList``, and
   ``pick_validation_set`` from a reserve of one set.
20. eval: ``denoise_dir`` over those scenes' six noisy images with the
   funit-64 checkpoint, bf16, cs 504 / ucs 480: wall per image, the
   engine's and the scores' times and device work, K2 5 launches an image,
   peak memory; each image's three losses against the CPU's ``get_losses``
   on the written files (1e-6), each written uint16 image bit-equal to
   ``AdaptiveEngine.denoise_raw`` called directly, a ``--skip_existing``
   rerun that decodes and denoises nothing and scores the same, and one
   24 MP (4000 x 6000) pair's score: its time and peak memory.
21. unet_cli: ``denoise_cli --tiff-input`` with a model table entry whose
   network is UNet (seeded full-width weights and BatchNorm state), bf16,
   cs 440 / ucs 320, on the 6 MP TIFF: wall, device time, peak memory, K1
   10 and K2 0 launches; the bf16 output's PSNR against the card's fp32 run
   (TF32 off), with a floor; the card's fp32 uint8 within 1 LSB of the
   CPU's on a 512 x 768 image; three ``DenoiseService("UNet", ...)``
   requests, each bit-equal to the engine + RL run of its image.
22. unet_train: ``train_conf_unet.yaml`` with ``--weight_MSSSIM 0
   --weight_MSE 1`` (batch 20, cs 220, loss_cs 161, fp32) for two epochs
   of two steps on seeded 256 px crops, a resume with ``--compute_dtype
   bfloat16`` (warns, trains fp32), warm step times with the BatchNorm
   kernels' share, and one step from the run's checkpoint on the card
   against the CPU (losses, gradient, BN running stats, parameters).
23. hul_gen_train: ``--g_network Hulb128Net --cs 128 --loss_cs 120
   --batch_size 12 --g_funit 32`` with MSE, one epoch of three steps in fp32
   and in bf16, warm step times, one step card against CPU, and
   Hulbs128Net's forward card against CPU.
24. zoo: DnCNN (22, 64), RedCNN (128, depth 30), the ResnetGenerator (ngf
   64, 9 blocks, BatchNorm), PatchGAN (ndf 64, 3 layers), the pixel critic
   (ndf 64) and MultiscaleDiscriminator (num_D 3) at full width on seeded
   weights with calibrated BatchNorm stats: the card's eval forward at a
   batch of 8 (256 px, RedCNN 128; ms, FLOP count, bound), held with the
   CPU's fp32 forward to a float64 CPU forward (ZOO_TOL of its largest
   magnitude) on its first image (DnCNN: the interior of a 96 px crop),
   and, for the BatchNorm nets, a train-mode forward of 4 images cut to
   128 px on each device, outputs and running stats, held likewise.
25. zoo_gan: the gan phase's config with PatchGAN as D1 and the pixel
   critic as D2 for two epochs: finite losses, both checkpoints at 6
   channels and ndf 64, K2 launched once per learn of either critic and
   once per validation pair and validation, a resume of all three networks
   carrying each Adam's count and scheduler, a PatchGAN both-learn batch's
   warm times against its FLOP bound, and one PatchGAN discriminator step
   (and a generator step with its D1 term) on the card against the CPU, as
   the gan phase holds its own.
26. relics: the relic zoo (HunNet, HuNet, Hul160Net = HulNet, HuDisc,
   Hul128Net, Hul144Disc with each head, HunkyDisc, HunkyNet, RedishCNN)
   and MobileNetV3 at JAX's default widths, as zoo holds its networks (at
   RELIC_TOL): the card's eval forward at a batch of 8 at each net's native
   size (RELIC_NETS), its first image held to the CPU's float64 one;
   for the BatchNorm nets a train-mode forward of 4 images, outputs and
   running stats; MobileNetV3's train-mode forward raises on the card.
27. relic_gan: zoo_gan with HuDisc as D1 and Hul144Disc as D2 (funit 32,
   6 channels): the two-epoch run, K2 launches, the resume, a Hul144Disc
   both-learn batch's times and one Hul144Disc step held card against CPU.
28. trace: ``denoise_image_cli --trace_dir`` on the 6 MP TIFF in bf16: a
   Chrome trace that names K2's kernel once per launch, and an output
   bit-equal to the same run without the trace.
29. parallel: the multi-device engines (``nind_denoise_tpu_torch/parallel``)
   on two devices, distinct GPUs where the machine has them and cuda:0
   twice otherwise (a rehearsal on one card, not a scaling figure), UtNet
   funit 64, bf16: the row-band engine on the 6 MP TIFF against one
   engine (fp32 canvases within one bf16 ulp, bytes moved against JAX's
   formula, wall and device ms beside the single engine's), int8_static
   through it on a 2 MP crop (PSNR against float32 >= 42 dB after RL), the
   batch engine on two 2 MP crops with RL sigma 1 x 10 on each device
   (uint8 against engine + RL, 1 LSB), the pool with two replicas on 32
   requests of four sizes (coalesced groups, uint8 against engine + RL, 1
   LSB, req/s beside one replica), the spatial forward at 6 MP with pad 8
   against the whole forward (one bf16 ulp) with each band's peak memory
   against the whole forward's, the TP forward of 8 x 504^2 in fp32 with
   TF32 off against the single forward (1e-5 relative), and
   ``eval.denoise_dir`` as two processes (torchrun's variables, gloo) on
   seeded 512 x 768 scenes against one process (set means to 1e-6); K1,
   K2 and K3 launches counted on each path.
30. dp_train: data-parallel training (``parallel/data_parallel.py``) as two
   ranks on cuda:0 over gloo (a rehearsal on one card, not a scaling
   figure), from the train phase's checkpoint at full width
   (``train_conf_utnet_std.yaml``: funit 64, batch 30, 15 rows a rank, 184
   px): one epoch with ``--weight_D1 0.2`` through the trainer's command
   line (torchrun's variables), the two ranks' replicas bit-equal at the end
   (the digest each rank logs), the same batches and decisions on both, K2
   launched once a learn on each rank and once a validation pair on rank 0
   alone, and K2 at a rank's learn input (15, 3, 188, 188) against its plain
   version (fp32 bit-equal); then, in the same group, the same 30 crops
   scattered from rank 0 (``DataParallel.batches``) and one cGAN batch from
   the checkpoint and the gan phase's aged critic (Hul112Disc, d_funit 32)
   held against one process's on the 30 crops at the gan phase's
   tolerances: the critic's learn (its global BatchNorm in train mode,
   targets drawn at the global shape and sliced, losses, ``d.loss`` and the
   global prediction ranges, BN running stats, parameters) and the
   generator step with the D1 term (the frozen critic's global statistics;
   loss, metrics, gradient, parameters); a one-rank nccl group in this
   process, in which a DP step at 15 rows is held against the plain step at
   the train phase's tolerances and the gradient reducer is the identity;
   the cGAN generator step's ms a rank against one process, and the
   all-reduce's bytes and ms a step (gloo and nccl; nccl also in parts
   against its bytes bound).
31. dp_test: the trainer's whole-image test sharded over two data-parallel
   ranks on cuda:0 over gloo (a rehearsal on one card, not a scaling
   figure; ``train.loop.test_generator``, ``parallel/spatial.rank_bands``):
   UNet at full width, fp32, on a seeded NIND-shaped 16-bit pair (4000 x
   6000, cropped to 3968 x 5952 by ``TestDenoiseDataset``), each rank
   forwarding one band of rows with a 192-row halo, its BatchNorm by the
   owned rows of both bands, rank 0 gathering and scoring (MS-SSIM + MSE);
   then rank 0's whole forward of the same test alone: the two losses
   within 1e-5, the gathered image within 1e-4 of the whole forward's, the
   running stats untouched and the replicas equal, and each band
   forward's peak memory below the whole forward's; the same with UtNet
   funit 64, fp32, on a seeded 2008 x 3000 pair (a size it takes), where
   K2 launches once a rank and is held bit-equal to its plain version at
   each band's padded shape.

Then a ``kernels`` line (per-launch times against each kernel's bound),
the card line and, last, ``{"ok": true, "device": {...}}``. Any failure,
a missing GPU or a failed build exits non-zero without that last line.
Times are warm, from CUDA events. Launch counts are read around the runs
of the product paths (the CLIs and the server) only, with every count set
to 0 just before each run.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# the product CLIs' phases (cli_plugin, cli_raw, cli_dir, whole_image): a
# 6 MP image through UtNet at the product width
HW, FUNIT = (2000, 3000), 64
# the int8, RL-variant and train phases' device, and the batch and tile edge of
# the int8 forward's timing (a CPU rehearsal makes these small)
DEV, FWD = "cuda", (8, 504)
# the int8 CLI phase's PSNRs against float32 on its seeded image and
# checkpoint (NVIDIA H100 80GB HBM3), as the forward read with the quantize,
# PReLU and decoder sums as separate torch passes; P1's epilogue rounds as
# those passes do, so the PSNRs must not move
INT8_CLI_PSNR_DB = {"int8": 59.40, "int8_static": 58.05}
STAGE = re.compile(r"([\w+]+): ([0-9.]+)s/(\d+)x")  # one stage of a -v split


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def emit(card: str, **rec) -> None:
    print(json.dumps({**rec, "card": card}), flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Warm per-call time from CUDA events over ``reps`` calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    b, o = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def enc1_vs_plain(torch, E, args):
    """K2 against its plain version on ``args``: (max abs error, limit)."""
    # the plain version in full fp32: no TF32 in cuDNN
    torch.backends.cudnn.allow_tf32 = False
    l1, l2 = E.enc1(*args)
    r1, r2 = E.enc1_reference(*args)
    torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32 = True
    err = max((l1.float() - r1.float()).abs().max().item(),
              (l2.float() - r2.float()).abs().max().item())
    scale = max(1.0, r1.float().abs().max().item())
    # fp32: only the order of the 27- and 576-term sums differs.
    # bf16: t0 and l1 are rounded to 8 mantissa bits; a sum-order
    # change can flip a t0 rounding, moving l1 by a few ulps, so
    # allow 4 bf16 ulps at the output's magnitude (4 * 2^-8).
    tol = (1e-4 if args[0].dtype == torch.float32 else 4 * 2 ** -8) * scale
    return err, tol


def rl_vs_plain(torch, R, d, taps, iters):
    """``iters`` K1 iterations from u = d against as many of its plain
    version, on (P, H, W) fp32 planes: (max abs error, limit)."""
    bufs = [torch.empty_like(d), torch.empty_like(d)]
    u = ref = d
    for i in range(iters):
        u = R.rl_iter(u, d, taps, out=bufs[i % 2])
        ref = R.rl_iter_reference(ref, d, taps.tolist())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(u).all()), f"rl {tuple(d.shape)}: non-finite output")
    # fp32, as the CPU tests; the kernel rounds like the plain version
    return (u - ref).abs().max().item(), 2e-5 * max(1.0, ref.abs().max().item())


def bf16_ulp(x: float) -> float:
    """One bfloat16 ulp (8 significant bits) at magnitude ``x`` > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def enc1_library(torch, args):
    """The call a PyTorch user makes for level 1: cuDNN's convolutions on
    channels_last tensors of the input's type, PReLU and max pool. It
    rounds after each convolution, not after each PReLU. A yardstick
    only: the port never calls it."""
    import torch.nn.functional as F

    x, w0, b0, a0, w1, b1, a1 = args
    cl = torch.channels_last
    x, w0, w1 = (t.contiguous(memory_format=cl) for t in (x, w0, w1))

    def run():
        t = F.prelu(F.conv2d(x, w0, b0), a0)
        l1 = F.prelu(F.conv2d(t, w1, b1), a1)
        return l1, F.max_pool2d(l1, 2)

    return run


def enc1_record(torch, E, args, reps):
    """K2 on ``args`` against its plain version (failing above the limit),
    with its warm time, the plain version's, cuDNN's level 1 (the library
    yardstick) and the bound."""
    x = args[0]
    bsz, _, hp, wp = x.shape
    h, w = hp - 4, wp - 4
    dtype = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    err, tol = enc1_vs_plain(torch, E, args)
    check(err <= tol, f"enc1 {dtype} {bsz}x{h}x{w}: max err {err} > {tol}")
    # the plain version is timed as it was checked: without TF32
    torch.backends.cudnn.allow_tf32 = False
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (x.numel() + 64 * 27 + 64 * 576 + 130
                     + bsz * 64 * (h * w + (h // 2) * (w // 2)))
    flops = 2.0 * bsz * h * w * 64 * 576 + 2.0 * bsz * (h + 2) * (w + 2) * 64 * 27
    bms, by = bound_ms(nbytes, flops, dtype)
    ms = time_ms(torch, lambda: E.enc1(*args), reps)
    plain = time_ms(torch, lambda: E.enc1_reference(*args), reps)
    # the library yardstick, fp32 without TF32 like the plain version
    library = enc1_library(torch, args)
    y1, y2 = library()
    r1, r2 = E.enc1_reference(*args)
    lib_err = max((y1.float() - r1.float()).abs().max().item(),
                  (y2.float() - r2.float()).abs().max().item())
    lib_ms = time_ms(torch, library, reps)
    torch.backends.cudnn.allow_tf32 = True
    return dict(dtype=dtype, shape=[bsz, h, w], max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain, library_ms=lib_ms, library_max_abs_err=lib_err,
                bound_ms=bms, bound_by=by)


def phase_enc1(torch, card):
    from nind_denoise_tpu_torch.ops import enc1 as E

    gen = torch.Generator().manual_seed(1)
    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        # the product batch, a ragged 104 x 136, and the two shapes the
        # server's adapted (cs 136) and tiny paths give K2
        shapes = ((8, 504, 504), (2, 104, 136), (1, 136, 136), (1, 104, 104))
        if dtype == "float32":
            # the trainer's validation crop (x_pad (1, 3, 188, 188)), and a
            # ragged shape with W % 4 == 2, which takes the element stores
            shapes += ((1, 184, 184), (3, 50, 30))
        for bsz, h, w in shapes:
            x = torch.rand(bsz, 3, h + 4, w + 4, generator=gen).to("cuda", dt)

            def u(*shape, fan_in):
                b = 1.0 / math.sqrt(fan_in)
                return ((torch.rand(*shape, generator=gen) * 2 - 1) * b).to("cuda", dt)

            args = (x, u(64, 3, 3, 3, fan_in=27), u(64, fan_in=27),
                    torch.full((1,), 0.25, device="cuda", dtype=dt),
                    u(64, 64, 3, 3, fan_in=576), u(64, fan_in=576),
                    torch.full((1,), 0.25, device="cuda", dtype=dt))
            rec = dict(phase="enc1", **enc1_record(torch, E, args, 10 if h == 504 else 50))
            emit(card, **rec)
            out[(dtype, h, w)] = rec
    return out[("bfloat16", 504, 504)]


def rl_library(torch, d, taps):
    """A sequence of cuDNN calls for one RL iteration on (P, H, W): per
    blur a replicate pad and two depthwise 1-D convolutions (fp32 without
    TF32), twice, with the clamp, divide and multiply between. A yardstick
    only: the port never calls it."""
    import torch.nn.functional as F

    p = d.shape[0]
    r = (len(taps) - 1) // 2
    kv = torch.from_numpy(taps).to("cuda").reshape(1, 1, -1, 1).repeat(p, 1, 1, 1)
    kh = kv.reshape(p, 1, 1, -1)

    def blur(x):
        x = F.pad(x[None], (r, r, r, r), mode="replicate")
        return F.conv2d(F.conv2d(x, kv, groups=p), kh, groups=p)[0]

    return lambda: d * blur(d / torch.clamp(blur(d), min=1e-8))


def rl_time(torch, R, d, taps, reps):
    """K1's warm time, its plain version's, its library yardstick's and its
    bound on (P, H, W) planes at ``taps``, one iteration from u = d."""
    tt = torch.from_numpy(taps).to("cuda")
    out = torch.empty_like(d)
    nbytes = 3 * d.numel() * 4 + tt.numel() * 4
    r = (len(taps) - 1) // 2
    # two separable blurs (2 passes of 2r+1 mul+add), the ratio's max and
    # divide, the final multiply
    flops = d.numel() * (2 * 2 * 2 * (2 * r + 1) + 3)
    bms, by = bound_ms(nbytes, flops, "float32")
    rec = dict(ms=time_ms(torch, lambda: R.rl_iter(d, d, tt, out=out), reps),
               plain_ms=time_ms(torch, lambda: R.rl_iter_reference(d, d, taps),
                                max(2, reps // 4)),
               bound_ms=bms, bound_by=by)
    library = rl_library(torch, d, taps)
    torch.backends.cudnn.allow_tf32 = False
    rec.update(library_ms=time_ms(torch, library, max(2, reps // 4)),
               library_max_abs_err=(library() - R.rl_iter_reference(d, d, taps))
               .abs().max().item())
    torch.backends.cudnn.allow_tf32 = True
    return rec


def phase_rl(torch, card):
    """RL deblur on the card against its plain iteration, on each route:
    K1 (``fused``, R <= 32), K3 blurs (``separable_k3``, R <= 64) and the
    tap-unrolled torch blur (``separable_plain``), each with the launch
    counts and the route its radius picks; then K1's times."""
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.ops import rl_fused as R

    gen = torch.Generator().manual_seed(2)
    tol = 2e-5  # fp32, as the CPU tests; the kernels round like the plain version
    expect = {"fused": lambda n: {"rl_iter": n, "gauss_blur": 0},
              "separable_k3": lambda n: {"rl_iter": 0, "gauss_blur": 2 * n},
              "separable_plain": lambda n: {"rl_iter": 0, "gauss_blur": 0}}
    product = None
    # the product shape, the short-tail heights, sigma 3, a 6000-wide strip,
    # a width that is no multiple of 4 (K1's scalar stores), then one case
    # of each route: sigma 6 (R 18) and 10 (R 30, the darktable plugin's
    # top) on K1, 11 (R 33) on K3, 22 (R 66) plain
    for (h, w, sigma, iters) in ((2000, 3000, 1.0, 10), (361, 140, 1.0, 10),
                                 (362, 140, 1.0, 10), (130, 260, 3.0, 10),
                                 (24, 6000, 1.0, 10), (97, 131, 2.0, 3),
                                 (300, 260, 6.0, 3), (300, 260, 10.0, 3),
                                 (300, 260, 11.0, 3), (260, 300, 22.0, 2)):
        img = (torch.rand(h, w, 3, generator=gen) + 0.05).to("cuda")
        taps = RL.gaussian_taps_np(sigma)
        route = RL.route_for(RL.psf_radius(sigma))
        before = {"rl_iter": R.launches, "gauss_blur": G.launches,
                  "route": RL.routes[route]}
        got = RL.rl_deblur(img, sigma, iters)
        torch.cuda.synchronize()
        launches = {"rl_iter": R.launches - before["rl_iter"],
                    "gauss_blur": G.launches - before["gauss_blur"]}
        check(launches == expect[route](iters) and RL.routes[route] == before["route"] + 1,
              f"rl {h}x{w} sigma {sigma}: route {route}, launches {launches}")
        d = img.permute(2, 0, 1).contiguous()
        u = d
        for _ in range(iters):
            u = R.rl_iter_reference(u, d, taps)
        ref = u.permute(1, 2, 0)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"rl {h}x{w}: non-finite output")
        check(err <= tol * max(1.0, ref.abs().max().item()),
              f"rl {h}x{w} sigma {sigma}: max err {err}")
        rec = dict(phase="rl_iter", shape=[h, w, 3], sigma=sigma, radius=len(taps) // 2,
                   route=route, iterations=iters, launches=launches, max_abs_err=err,
                   tol=tol)
        if product is None:
            rec.update(rl_time(torch, R, d, taps, 20))
            product = rec
        emit(card, **rec)
    batch = (torch.rand(3, 120, 176, 3, generator=gen) + 0.05).to("cuda")
    together = RL.rl_deblur(batch, 1.0, 10)
    for i in range(3):
        check(torch.equal(together[i], RL.rl_deblur(batch[i], 1.0, 10)),
              f"rl batch member {i} differs from its single run")
    emit(card, phase="rl_iter", check="batch of 3 equals its single runs bit for bit")

    # K1 where the operations bound it (sigma 10 at 6 MP) and at the
    # server's planes (a group of eight 480 x 480 images); one iteration
    # of each separable route at 6 MP
    img = (torch.rand(2000, 3000, 3, generator=gen) + 0.05).to("cuda")
    d = img.permute(2, 0, 1).contiguous()
    emit(card, phase="rl_iter_time", shape=[3, 2000, 3000], sigma=10.0,
         **rl_time(torch, R, d, RL.gaussian_taps_np(10.0), 10))
    planes = (torch.rand(24, 480, 480, generator=gen) + 0.05).to("cuda")
    emit(card, phase="rl_iter_time", shape=[24, 480, 480], sigma=1.0,
         **rl_time(torch, R, planes, RL.gaussian_taps_np(1.0), 50))
    for sigma in (11.0, 22.0):
        emit(card, phase="rl_route_time", shape=[2000, 3000, 3], sigma=sigma,
             route=RL.route_for(RL.psf_radius(sigma)), iterations=1,
             ms=time_ms(torch, lambda: RL.rl_deblur(img, sigma, 1), 3))
    return product


def blur_vs_plain(torch, got, ref, what):
    """K3's output against its plain version: (max abs error, limit); fails
    on a wrong shape, a non-finite value or an error above the limit, the
    JAX test's bar (0 when the kernel rounds like the plain version)."""
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = 2e-6 * max(1.0, ref.abs().max().item())
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and err <= tol,
          f"{what}: max err {err} > {tol}, or a bad output")
    return err, tol


def blur_library(torch, x, taps, hwc=False):
    """K3's yardstick on (P, H, W) planes, or on (H, W, C) through a
    channels-first view (``hwc``): a replicate pad and two depthwise 1-D
    convolutions; the port never calls it."""
    import torch.nn.functional as F

    planes = x.permute(2, 0, 1) if hwc else x
    p = planes.shape[0]
    r = (len(taps) - 1) // 2
    kv = torch.from_numpy(taps).to("cuda").reshape(1, 1, -1, 1).repeat(p, 1, 1, 1)
    kh = kv.reshape(p, 1, 1, -1)

    def run():
        xp = F.pad(planes[None], (r, r, r, r), mode="replicate")
        y = F.conv2d(F.conv2d(xp, kv, groups=p), kh, groups=p)[0]
        return y.permute(1, 2, 0) if hwc else y

    return run


def blur_times(torch, kernel, plain, library, ref, r, reps):
    """K3's warm time beside its plain version's, its library yardstick's
    (fp32 without TF32, with its error against ``ref``) and its bound:
    8 bytes and 4(2r+1) flops an element."""
    torch.backends.cudnn.allow_tf32 = False
    lib_err = (library() - ref).abs().max().item()
    lib_ms = time_ms(torch, library, 20)
    torch.backends.cudnn.allow_tf32 = True
    bms, by = bound_ms(8 * ref.numel(), 4 * (2 * r + 1) * ref.numel(), "float32")
    return dict(ms=time_ms(torch, kernel, reps),
                plain_ms=time_ms(torch, plain, 3 if r > 9 else 10),
                library_ms=lib_ms, library_max_abs_err=lib_err, bound_ms=bms, bound_by=by)


def gauss_blur_radius_sweep(torch, card):
    """K3 at every radius 1-64 on a ragged HWC image and ragged planes,
    each template instance against the plain version."""
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_fused
    from nind_denoise_tpu_torch.ops.rl_deblur import gaussian_taps_np

    gen = torch.Generator().manual_seed(6)
    img = torch.rand(75, 77, 3, generator=gen).to("cuda")
    planes = torch.rand(2, 75, 77, generator=gen).to("cuda")
    worst = {"hwc": 0.0, "planes": 0.0}
    for r in range(1, G.MAX_RADIUS + 1):
        sigma = (r - 0.5) / 3  # ceil(3 sigma) = r
        taps = gaussian_taps_np(sigma)
        check(len(taps) == 2 * r + 1, f"sigma {sigma}: radius {len(taps) // 2} != {r}")
        tt = torch.from_numpy(taps).to("cuda")
        for name, got, ref in (
                ("hwc", G.gauss_blur(img, sigma), G.gauss_blur_reference(img, sigma)),
                ("planes", G.blur_planes(planes, tt), rl_fused.blur(planes, taps.tolist()))):
            err, _ = blur_vs_plain(torch, got, ref, f"gauss_blur {name} radius {r}")
            worst[name] = max(worst[name], err)
    emit(card, phase="gauss_blur_radii", radii=[1, G.MAX_RADIUS],
         shapes={"hwc": [75, 77, 3], "planes": [2, 75, 77]}, max_abs_err=worst)


def phase_gauss_blur(torch, card):
    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_fused
    from nind_denoise_tpu_torch.ops.rl_deblur import gaussian_taps_np

    gen = torch.Generator().manual_seed(5)
    product = None
    for (h, w, sigma) in ((2000, 3000, 1.0), (2000, 3000, 3.0), (2000, 3000, 21.0),
                          (97, 131, 1.0), (5, 7, 3.0), (24, 6000, 1.0)):
        img = torch.rand(h, w, 3, generator=gen).to("cuda")
        ref = G.gauss_blur_reference(img, sigma)
        err, tol = blur_vs_plain(torch, G.gauss_blur(img, sigma), ref,
                                 f"gauss_blur {h}x{w} sigma {sigma}")
        taps = gaussian_taps_np(sigma)
        r = (len(taps) - 1) // 2
        rec = dict(phase="gauss_blur", shape=[h, w, 3], sigma=sigma, radius=r,
                   max_abs_err=err, tol=tol)
        if h == 2000:
            rec.update(blur_times(torch, lambda: G.gauss_blur(img, sigma),
                                  lambda: G.gauss_blur_reference(img, sigma),
                                  blur_library(torch, img, taps, hwc=True), ref, r, 50))
            product = product or rec
        emit(card, **rec)
    # the planar entry at 6 MP: sigma 10 (R 30, beside K1's), 11 (R 33,
    # RL's separable_k3 route) and 21.3 (R 64)
    planes = torch.rand(3, 2000, 3000, generator=gen).to("cuda")
    for sigma in (10.0, 11.0, 21.3):
        taps = gaussian_taps_np(sigma)
        r = (len(taps) - 1) // 2
        tt = torch.from_numpy(taps).to("cuda")
        out = torch.empty_like(planes)
        ref = rl_fused.blur(planes, taps.tolist())
        err, tol = blur_vs_plain(torch, G.blur_planes(planes, tt, out=out), ref,
                                 f"blur_planes radius {r}")
        emit(card, phase="blur_planes", shape=[3, 2000, 3000], sigma=sigma, radius=r,
             max_abs_err=err, tol=tol,
             **blur_times(torch, lambda: G.blur_planes(planes, tt, out=out),
                          lambda: rl_fused.blur(planes, taps.tolist()),
                          blur_library(torch, planes, taps), ref, r, 20))
    gauss_blur_radius_sweep(torch, card)
    try:
        G.gauss_blur(img, 22.0)
    except ValueError as e:
        emit(card, phase="gauss_blur", check=f"sigma 22 raises: {e}")
    else:
        fail("gauss_blur: sigma 22 (radius 66) did not raise")
    return product


def phase_end_to_end(torch, card, tmp, kernel_mods):
    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.core.tiles import TilePlan
    from nind_denoise_tpu_torch.pipeline import denoise_cli
    from nind_denoise_tpu_torch.tools import fixtures

    rng = np.random.default_rng(3)
    tif = os.path.join(tmp, "img.tif")
    check(cv2.imwrite(tif, rng.integers(0, 65536, (2000, 3000, 3)).astype(np.uint16)),
          "could not write the TIFF")
    ckpt = os.path.join(tmp, "generator_1.npz")
    fixtures.write_jax_checkpoint(ckpt, 64, seed=4)
    outdir = os.path.join(tmp, "out")
    os.makedirs(outdir)
    argv = [tif, "--tiff-input", "--model_path", ckpt, "-o", outdir,
            "--compute_dtype", "bfloat16", "--batch_size", "8"]
    denoise_cli.main(argv)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.time()
    (out, (ref,), _), launches = counted(torch, kernel_mods,
                                         lambda: cli_run(denoise_cli, argv))
    wall = time.time() - t0
    plan = TilePlan(2000, 3000, 504, 480, 6)
    batches = (plan.ipervl + 1) * math.ceil((plan.iperhl + 1) / 8)
    check(launches["enc1"] == batches,
          f"enc1 launched {launches['enc1']} times, expected {batches}")
    check(launches["rl_iter"] == 10,
          f"rl_iter launched {launches['rl_iter']} times, expected 10")
    img = cv2.imread(str(out))
    check(img is not None and img.shape == (2000, 3000, 3), f"bad output {out}")
    emit(card, phase="end_to_end", shape=[2000, 3000, 3], compute_dtype="bfloat16",
         wall_s=wall, mp_per_s=6.0 / wall, tile_batches=batches, launches=launches,
         output=os.path.basename(str(out)))

    # where the time goes: one more run under the profiler (not timed above)
    # (the profiler's own host cost inflates that run's wall, so the busy
    # share is taken against the unprofiled wall above)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        denoise_cli.main(argv + ["-v"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    emit(card, phase="end_to_end_profile", device_ms=device_ms,
         device_busy_share=device_ms / 1e3 / wall,
         top_device_ms={e.key[:90]: e.self_device_time_total / 1e3 for e in top})

    # small image, fp32 without TF32: the card against the CPU
    small = os.path.join(tmp, "small.tif")
    cv2.imwrite(small, rng.integers(0, 65536, (150, 170, 3)).astype(np.uint16))
    seen = [cli_run(denoise_cli, [small, "--tiff-input", "--model_path", ckpt,
                                  "-o", outdir, "--compute_dtype", "float32",
                                  "--precision", "float32", "--cs", "104", "--ucs", "88",
                                  "--device", dev])[1][0] for dev in ("cuda", "cpu")]
    diff = max_lsb(*seen)
    check(diff <= 1, f"small image: card and CPU differ by {diff} LSB")
    emit(card, phase="end_to_end_small", shape=[150, 170, 3], compute_dtype="float32",
         max_lsb_diff_cuda_vs_cpu=diff)
    return launches, (out, ref)


class FakeCommons:
    """Wikimedia Commons on a loopback port for the NIND downloader: the
    API's ``imageinfo`` queries for the files of ``src`` (``<set>/<name>``),
    answered with their URL here and their sha1, and the files' bytes
    (those named in ``corrupt`` served with their first byte flipped).
    ``fetched`` counts the file requests by name. ``close`` stops it."""

    def __init__(self, src, corrupt=()):
        import http.server
        import threading
        import urllib.parse

        from nind_denoise_tpu_torch.utils import utilities

        self.paths = {f: os.path.join(d, f) for d, _, fs in os.walk(src) for f in fs}
        self.sha1 = {f: utilities.checksum(p, "sha1") for f, p in self.paths.items()}
        self.corrupt, self.fetched = set(corrupt), collections.Counter()
        commons = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def send(self, body, ctype):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/w/api.php":
                    q = dict(urllib.parse.parse_qsl(query))
                    name = q["titles"].split(":", 1)[1]
                    info = {"url": f"{commons.base}/files/{name}", "sha1": commons.sha1[name],
                            "timestamp": "2021-05-21T00:00:00Z"}
                    page = {"title": q["titles"], "imageinfo": [info]}
                    self.send(json.dumps({"query": {"pages": {"1": page}}}).encode(),
                              "application/json")
                    return
                name = path.rsplit("/", 1)[1]
                commons.fetched[name] += 1
                with open(commons.paths[name], "rb") as f:
                    body = bytearray(f.read())
                if name in commons.corrupt:
                    body[0] ^= 0xFF
                self.send(bytes(body), "application/octet-stream")

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.api = self.base + "/w/api.php"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def phase_fetch(torch, card, tmp, kernel_mods, tif, ckpt, ref, scenes, hw):
    """The port's downloads. (a) The model table's: ``denoise_cli`` with no
    model flag, the table's entry pointing at a missing path under the
    phase's directory and at ``ckpt`` by a ``file://`` URL, on
    phase_end_to_end's TIFF in bf16: the checkpoint fetched byte-equal, no
    ``.part``, the pre-encode uint8 within 1 LSB of ``ref`` (end_to_end's
    ``--model_path`` run: its JPEG path and image), K2 once a tile batch and
    K1 10 times; a second run fetches nothing; a missing URL raises
    RuntimeError and writes neither a JPEG nor a ``.part``. (b) The NIND
    downloader: seeded scenes (``write_scenes``) served by ``FakeCommons``
    on a loopback port, ``tools.dl_ds.main`` on a two-set manifest in the
    pinned form into ``scenes`` (the tree the dataset_tools and eval phases
    read), every file sha1-equal to its source; a second run fetches
    nothing; a file served corrupt exits 1 after MAX_ATTEMPTS fetches and
    is named. Returns the launch counts of (a)'s first run."""
    import pathlib
    import shutil
    import urllib.request

    import cv2
    import yaml

    from nind_denoise_tpu_torch.pipeline import denoise_cli
    from nind_denoise_tpu_torch.tools import dl_ds
    from nind_denoise_tpu_torch.utils import utilities

    t_phase = time.time()
    d = os.path.join(tmp, "fetch")
    ref_jpg, ref_u8 = ref
    fetches = []
    retrieve = urllib.request.urlretrieve

    def timed_retrieve(url, *a, **kw):
        t0 = time.time()
        try:
            return retrieve(url, *a, **kw)
        finally:
            fetches.append((url, time.time() - t0))

    def table(path, url):
        return with_model_entry(denoise_cli, "nind_generator_650.pt", {
            "path": path, "url": url, "network": "UtNet", "funit": FUNIT,
            "activation": "PReLU"})

    dest = os.path.join(d, "models", "nind", "generator_1.npz")
    outs = [os.path.join(d, f"out{k}") for k in range(3)]
    for o in outs:
        os.makedirs(o)
    argv = [tif, "--tiff-input", "--compute_dtype", "bfloat16", "--batch_size", "8"]
    urllib.request.urlretrieve = timed_retrieve
    restore = table(dest, pathlib.Path(os.path.abspath(ckpt)).as_uri())
    try:
        t0 = time.time()
        (out, seen, _), launches = counted(torch, kernel_mods,
                                           lambda: cli_run(denoise_cli, argv + ["-o", outs[0]]))
        cli_wall = time.time() - t0
        check(len(fetches) == 1, f"fetch: {len(fetches)} downloads, expected 1")
        model_s = fetches[0][1]
        check(utilities.checksum(dest, "sha1") == utilities.checksum(ckpt, "sha1")
              and not os.path.exists(dest + ".part"), "fetch: the checkpoint is not a copy")
        jpg = cv2.imread(str(out))
        check(jpg is not None and jpg.shape == ref_u8.shape,
              f"fetch: bad output {out} ({None if jpg is None else jpg.shape}, "
              f"expected {ref_u8.shape})")
        diff = max_lsb(seen[0], ref_u8)
        check(diff <= 1, f"fetch: {diff} LSB off end_to_end's --model_path run")
        jpeg_equal = open(str(out), "rb").read() == open(str(ref_jpg), "rb").read()
        batches = cli_batches(*ref_u8.shape[:2])
        check(launches["enc1"] == batches and launches["rl_iter"] == 10,
              f"fetch: launches {launches}, expected enc1 {batches} and rl_iter 10")
        t0 = time.time()
        cli_run(denoise_cli, argv + ["-o", outs[1]])
        again_wall = time.time() - t0
        check(len(fetches) == 1, "fetch: a present checkpoint was fetched again")
        restore()
        missing = os.path.join(d, "models", "missing", "generator_1.npz")
        restore = table(missing, pathlib.Path(d, "nowhere.npz").as_uri())
        try:
            cli_run(denoise_cli, argv + ["-o", outs[2]])
            raised = None
        except RuntimeError as e:
            raised = str(e)
        check(raised is not None and "could not download" in raised and missing in raised,
              f"fetch: a missing URL did not raise the port's error ({raised})")
        check(not os.listdir(outs[2]) and not os.path.exists(missing)
              and not os.path.exists(missing + ".part"),
              f"fetch: the failed fetch left {os.listdir(outs[2])}")
    finally:
        restore()
        urllib.request.urlretrieve = retrieve

    # (b) the NIND downloader over loopback into the research loop's tree
    src = os.path.join(d, "commons")
    t0 = time.time()
    write_scenes(src, hw)
    scenes_s = time.time() - t0
    sets = sorted(os.listdir(src))
    manifest = {"last_update": "2021-05-21", "sets": {
        f"cam{i}": {"ext": "png", "scenes": {s: [int(iso[3:]) for iso, _ in SCENE_ISOS]}}
        for i, s in enumerate(sets)}}
    man = os.path.join(d, "manifest.yaml")
    with open(man, "w") as f:
        yaml.safe_dump(manifest, f)
    names = dl_ds.manifest_titles(manifest)
    commons = FakeCommons(src)
    api = dl_ds.API
    dl_ds.API = commons.api
    try:
        t0 = time.time()
        rc, _ = captured(dl_ds.main, ["--target_dir", scenes, "--manifest", man])
        dl_s = time.time() - t0
        check(rc == 0 and sorted(commons.fetched) == sorted(names)
              and set(commons.fetched.values()) == {1}, f"dl_ds: rc {rc}, {commons.fetched}")
        got = {f: os.path.join(dp, f) for dp, _, fs in os.walk(scenes) for f in fs}
        check(sorted(got) == sorted(names), f"dl_ds wrote {sorted(got)}")
        check(all(utilities.checksum(p, "sha1") == commons.sha1[f] for f, p in got.items()),
              "dl_ds: a file differs from its source")
        nbytes = sum(os.path.getsize(p) for p in got.values())
        commons.fetched.clear()
        t0 = time.time()
        rc, _ = captured(dl_ds.main, ["--target_dir", scenes, "--manifest", man])
        skip_s = time.time() - t0
        check(rc == 0 and not commons.fetched, f"dl_ds again: rc {rc}, {commons.fetched}")
    finally:
        commons.close()
        dl_ds.API = api
    bad = names[0]
    commons = FakeCommons(src, corrupt={bad})
    dl_ds.API = commons.api
    try:
        t0 = time.time()
        rc, text = captured(dl_ds.main, ["--target_dir", os.path.join(d, "corrupt"),
                                         "--manifest", man])
        corrupt_s = time.time() - t0
        errors = text.split("ERRORS:", 1)[-1]
        corrupt_rc, corrupt_fetches = rc, commons.fetched[bad]
        check(rc == 1 and corrupt_fetches == dl_ds.MAX_ATTEMPTS
              and f"{bad}: download failed" in errors and errors.count("failed") == 1,
              f"dl_ds with {bad} corrupt: rc {rc}, {corrupt_fetches} fetches, {errors}")
    finally:
        commons.close()
        dl_ds.API = api
    shutil.rmtree(src)
    shutil.rmtree(os.path.join(d, "corrupt"))
    emit(card, phase="fetch", seconds=time.time() - t_phase,
         model={"bytes": os.path.getsize(dest), "download_s": model_s,
                "mb_per_s": os.path.getsize(dest) / 1e6 / model_s, "cli_wall_s": cli_wall,
                "cli_wall_present_s": again_wall, "launches": launches,
                "tile_batches": batches, "max_lsb_vs_model_path": diff,
                "jpeg_bytes_equal": jpeg_equal, "missing_url_raises": raised},
         dl_ds={"files": len(names), "bytes": nbytes, "download_s": dl_s,
                "mb_per_s": nbytes / 1e6 / dl_s, "skip_existing_s": skip_s,
                "corrupt_exit": corrupt_rc, "corrupt_fetches": corrupt_fetches,
                "corrupt_s": corrupt_s, "scenes_written_s": scenes_s, "shape": [*hw, 3]})
    return launches


def record_inputs(mod, name, key):
    """Wrap ``mod.<name>`` so that, while ``rec["on"]``, the first call at
    each ``key(*args)`` (None: skip) keeps a copy of its tensor arguments
    in ``rec["seen"]``. The wrapped function still runs, and counts its
    launch, once per call. ``rec["restore"]()`` puts it back."""
    fn = getattr(mod, name)
    rec = {"on": True, "seen": {}}

    def spy(*args, **kw):
        k = key(*args) if rec["on"] else None
        if k is not None and k not in rec["seen"]:
            rec["seen"][k] = [a.detach().clone() for a in args]
        return fn(*args, **kw)

    setattr(mod, name, spy)
    rec["restore"] = lambda: setattr(mod, name, fn)
    return rec


def phase_serve(torch, card, tmp, kernel_mods):
    """The serving daemon in process on the card. Returns the launch counts
    of its HTTP traffic, summed over the windows it was driven in; the K2
    and K1 inputs that traffic gave the kernels, one per shape; and the
    served model."""
    import threading
    import urllib.request

    import cv2
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.pipeline import serve as S
    from nind_denoise_tpu_torch.tools import fixtures

    ckpt1 = os.path.join(tmp, "generator_1.npz")  # phase_end_to_end's weights
    ckpt2 = os.path.join(tmp, "generator_2.npz")
    fixtures.write_jax_checkpoint(ckpt2, 64, seed=7)
    svc = S.DenoiseService("UtNet", ckpt1, cs=504, ucs=480, batch_size=8,
                           compute_dtype="bfloat16")
    httpd = S.serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    total = {name: 0 for name in kernel_mods}
    recs = {
        "enc1": record_inputs(kernel_mods["enc1"], "enc1",
                              lambda x, *w: (tuple(x.shape), str(x.dtype))),
        # the first iteration of each RL run, where u is d
        "rl_iter": record_inputs(kernel_mods["rl_iter"], "rl_iter",
                                 lambda u, d, taps: tuple(d.shape) if u is d else None)}

    def drive(fn):
        """Run HTTP traffic with every kernel count set to 0 just before
        and read just after; returns (result, counts of this window)."""
        out, seen = counted(torch, kernel_mods, fn)
        for name in total:
            total[name] += seen[name]
        return out, seen

    def png(img):
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        check(ok, "PNG encode failed")
        return buf.tobytes()

    def post(data, query):
        req = urllib.request.Request(f"{base}/denoise?{query}", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            check(r.status == 200, f"status {r.status}")
            return r.read()

    def decode(body):
        return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]

    def direct(raw, sigma=1.0, iterations=10):
        out = svc._adaptive.denoise_raw(raw, 65535.0, out_dtype="device")
        return RL.rl_to_u8_device(out, sigma, iterations).cpu().numpy()

    def stats():
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            return json.loads(r.read())

    rng = np.random.default_rng(8)
    rl_q = "output=png&rl=1&sigma=1&iterations=10"

    try:
        # 1. 6 MP requests, one cold then five warm, equal to the direct run
        big = png(rng.integers(0, 65536, (2000, 3000, 3), dtype=np.uint16))
        t0 = time.time()
        drive(lambda: post(big, rl_q))
        cold = time.time() - t0
        warm, bodies = [], []
        for _ in range(5):
            t0 = time.time()
            body, seen = drive(lambda: post(big, rl_q))
            warm.append(time.time() - t0)
            bodies.append(body)
            check(seen["enc1"] == 5 and seen["rl_iter"] == 10,
                  f"serve 6 MP: launches {seen}")
        check(all(b == bodies[0] for b in bodies), "serve 6 MP: responses differ")
        check(np.array_equal(decode(bodies[0]), direct(decode(big))),
              "serve 6 MP: response differs from the direct engine + RL run")
        emit(card, phase="serve", case="6MP png rl=1", shape=[2000, 3000, 3],
             latency_s_cold=cold, latency_s=warm,
             latency_s_p50=float(np.median(warm)), launches=seen,
             equal_to_direct_run=True)

        # 2. 480 x 480 requests: serial, then eight queued at once behind
        # the parked dispatcher (one group), then free-running bursts of
        # eight. Prewarm's zero images are not kept as kernel inputs.
        smalls = [png(rng.integers(0, 65536, (480, 480, 3), dtype=np.uint16))
                  for _ in range(8)]
        serial, seen = drive(lambda: [post(d, rl_q) for d in smalls])
        check(seen["enc1"] == 8 and seen["rl_iter"] == 80,
              f"serve serial: launches {seen}")
        for r in recs.values():
            r["on"] = False
        warm_info = svc.prewarm(480, 480)
        for r in recs.values():
            r["on"] = True

        def burst(park):
            bodies, lat = [None] * 8, [0.0] * 8
            release = threading.Event()
            if park:
                gate = threading.Event()
                blocker = threading.Thread(
                    target=lambda: svc.submit(lambda: gate.set() or release.wait(120)))
                blocker.start()
                check(gate.wait(60), "dispatcher did not park")

            def hit(i):
                t = time.time()
                bodies[i] = post(smalls[i], rl_q)
                lat[i] = time.time() - t

            threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            if park:
                deadline = time.time() + 60
                while svc._q.qsize() < 8 and time.time() < deadline:
                    time.sleep(0.01)
                check(svc._q.qsize() == 8, "the eight requests did not queue")
                release.set()
                blocker.join(60)
            for t in threads:
                t.join(300)
                check(not t.is_alive(), "a request hung")
            return bodies, lat

        def vs_serial(bodies):
            """Coalesced responses against their serial ones: cuDNN may
            round a tile differently in another batch, so hold them to
            1 LSB and count what differs."""
            d = [np.abs(decode(b).astype(int) - decode(s).astype(int))
                 for b, s in zip(bodies, serial)]
            out = {"max_lsb": int(max(x.max() for x in d)),
                   "values_differing": int(sum((x > 0).sum() for x in d)),
                   "responses_identical": sum(b == s for b, s in zip(bodies, serial))}
            check(out["max_lsb"] <= 1, f"a coalesced response is off its serial one: {out}")
            return out

        before = stats()
        (bodies, _), seen = drive(lambda: burst(park=True))
        after = stats()
        check(after["coalesced_requests"] - before["coalesced_requests"] == 8,
              "the parked burst did not coalesce into one group")
        check(seen["enc1"] == 1 and seen["rl_iter"] == 10,
              f"serve coalesced group of 8: launches {seen}, expected 1 and 10")
        # the same group straight through the engine: the fp32 canvases of
        # the coalesced run against each image's own run, held to one bf16
        # ulp at the canvases' largest magnitude
        raws = [decode(d) for d in smalls]
        many = svc._adaptive.denoise_many(raws, 65535.0, out_dtype="device")
        alone = [svc._adaptive.denoise_raw(r, 65535.0, out_dtype="device") for r in raws]
        eng_diff = max((m - a).abs().max().item() for m, a in zip(many, alone))
        eng_tol = bf16_ulp(max(a.abs().max().item() for a in alone))
        check(eng_diff <= eng_tol,
              f"coalesced canvases off their own runs by {eng_diff} > {eng_tol}")
        emit(card, phase="serve", case="group of 8 at 480x480, coalesced vs serial",
             launches=seen, responses=vs_serial(bodies),
             engine_slots_equal=[bool(torch.equal(m, a)) for m, a in zip(many, alone)],
             engine_max_abs_diff=eng_diff, engine_tol=eng_tol)

        def bursts(rounds, label):
            before = stats()
            t0 = time.time()
            runs, seen = drive(lambda: [burst(park=False) for _ in range(rounds)])
            wall = time.time() - t0
            diffs = [vs_serial(b) for b, _ in runs]
            after = stats()
            groups = {k: v - before["group_sizes"].get(k, 0)
                      for k, v in after["group_sizes"].items()
                      if v != before["group_sizes"].get(k, 0)}
            n_groups = sum(groups.values())
            # each group of <= 8 one-tile images is one tile batch and one RL run
            check(seen["enc1"] == n_groups and seen["rl_iter"] == 10 * n_groups,
                  f"serve bursts: launches {seen} for {n_groups} groups {groups}")
            lats = [x for _, lat in runs for x in lat]
            n_req = 8 * rounds
            rec = dict(phase="serve", case=f"480x480 png rl=1, {rounds} bursts of 8{label}",
                       requests=n_req, wall_s=wall, req_per_s=n_req / wall,
                       mp_per_s=n_req * 480 * 480 / 1e6 / wall,
                       client_latency_ms_p50=float(np.percentile(lats, 50)) * 1e3,
                       client_latency_ms_p95=float(np.percentile(lats, 95)) * 1e3,
                       group_sizes=groups,
                       coalesced_requests=after["coalesced_requests"]
                       - before["coalesced_requests"], launches=seen,
                       vs_serial={"max_lsb": max(d["max_lsb"] for d in diffs),
                                  "values_differing": sum(d["values_differing"]
                                                          for d in diffs),
                                  "responses_identical": sum(d["responses_identical"]
                                                             for d in diffs)},
                       stage_s={k: after["stage_s"][k] - before["stage_s"][k]
                                for k in after["stage_s"]})
            return rec, after

        # a window of some seconds, then a shorter one under the profiler
        # for the device's share (the profiler's host cost inflates that
        # window's wall, so the busy share is taken against the unprofiled
        # window's wall per request)
        rec, after = bursts(40, "")
        emit(card, **rec, server_latency_ms=after["latency_ms"], prewarm=warm_info)
        check(after["coalesced_requests"] >= 2, "no request was coalesced")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_rec, _ = bursts(8, " under the profiler")
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        emit(card, phase="serve_profile", requests=prof_rec["requests"],
             wall_s_profiled=prof_rec["wall_s"], group_sizes=prof_rec["group_sizes"],
             device_ms=device_ms, device_ms_per_request=device_ms / prof_rec["requests"],
             device_busy_share=device_ms / 1e3 / prof_rec["requests"] * rec["req_per_s"],
             top_device_ms={e.key[:90]: e.self_device_time_total / 1e3 for e in top})

        # 3. an adapted tiling (64 x 64 -> cs 136) and the tiny-image path
        for hw in ((64, 64), (40, 44)):
            raw = rng.integers(0, 65536, (*hw, 3), dtype=np.uint16)
            body, seen = drive(lambda: post(png(raw), rl_q))
            check(np.array_equal(decode(body), direct(raw)), f"serve {hw}: differs")
            emit(card, phase="serve", case=f"{hw[0]}x{hw[1]}", launches=seen,
                 engines=sorted(str(k) for k in svc._adaptive._engines))
        check("tiny" in svc._adaptive._engines, "the tiny-image path was not taken")

        # 4. reload to the second checkpoint: the next response runs on it
        req = urllib.request.Request(f"{base}/reload?model_path={ckpt2}", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            check(json.loads(r.read())["status"] == "reloaded", "reload failed")
        body, _ = drive(lambda: post(smalls[0], rl_q))
        got = decode(body)
        check(not np.array_equal(got, decode(serial[0])), "reload did not swap the weights")
        check(np.array_equal(got, direct(decode(smalls[0]))),
              "after reload: response differs from the direct run on the new weights")
        emit(card, phase="serve", case="reload", reloads=stats()["reloads"],
             equal_to_direct_run=True)
    finally:
        for r in recs.values():
            r["restore"]()

    model = svc._adaptive._resolved
    httpd.shutdown()
    httpd.server_close()
    svc.close()
    svc._worker.join(30)
    check(not svc._worker.is_alive(), "the dispatcher did not stop")
    return total, {k: r["seen"] for k, r in recs.items()}, model


def phase_serve_kernels(torch, card, inputs, model):
    """K2 and K1 against their plain versions on the inputs the serve
    traffic gave them, one per shape: among them the coalesced groups'
    stacked RL planes and the adapted and tiny-image tiles. Then the
    witness behind the 1 LSB limit on coalesced responses: one tile in all
    eight slots of a batch, against the same tile alone (a serial
    request's batch of 1). K2 must give every slot the bits of the tile
    alone; cuDNN's first level-2 convolution and the whole forward are
    reported slot by slot."""
    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.ops import rl_fused as R

    checked = {"enc1": [], "rl_iter": []}
    with torch.inference_mode():
        for (shape, dtype), args in inputs["enc1"].items():
            err, tol = enc1_vs_plain(torch, E, args)
            check(err <= tol, f"serve enc1 {shape} {dtype}: max err {err} > {tol}")
            checked["enc1"].append({"shape": list(shape), "dtype": dtype,
                                    "max_abs_err": err, "tol": tol})
        for shape, (_, d, taps) in inputs["rl_iter"].items():
            err, tol = rl_vs_plain(torch, R, d, taps, 10)
            check(err <= tol, f"serve rl_iter {shape}: max err {err} > {tol}")
            checked["rl_iter"].append({"shape": list(shape), "iterations": 10,
                                       "max_abs_err": err, "tol": tol})
    for kernel, shape in (("enc1", (8, 3, 508, 508)), ("enc1", (1, 3, 140, 140)),
                          ("rl_iter", (24, 480, 480))):
        check(any(c["shape"] == list(shape) for c in checked[kernel]),
              f"the serve traffic gave {kernel} no input of shape {shape}")
    emit(card, phase="serve_kernel_shapes", **checked)

    gen = torch.Generator().manual_seed(9)
    tile = torch.rand(1, 3, 504, 504, generator=gen).to("cuda", torch.bfloat16)
    batch = tile.repeat(8, 1, 1, 1)
    with torch.inference_mode():
        l1_1, l2_1 = model.encode1(tile)
        l1_8, l2_8 = model.encode1(batch)
        conv = model.convs2[0]
        c_1, c_8 = conv(l2_1), conv(l2_8)
        f_1, f_8 = model(tile), model(batch)
        torch.cuda.synchronize()

    def by_slot(y8, y1):
        return {"max_abs_diff_vs_batch_of_1": [(y8[k].float() - y1[0].float())
                                               .abs().max().item() for k in range(8)],
                "slots_equal_slot_0": all(torch.equal(y8[k], y8[0]) for k in range(8))}

    enc1_equal = all(torch.equal(l1_8[k], l1_1[0]) and torch.equal(l2_8[k], l2_1[0])
                     for k in range(8))
    check(enc1_equal, "enc1 gives a tile different bits in a batch of 8")
    emit(card, phase="serve_batch_witness", tile=[504, 504], dtype="bfloat16",
         enc1_slots_equal_batch_of_1=enc1_equal,
         cudnn_conv=by_slot(c_8, c_1), forward=by_slot(f_8, f_1))


def counted(torch, kernel_mods, fn):
    """Run ``fn`` with every kernel count set to 0 just before; returns
    (its result, the counts read just after)."""
    for m in kernel_mods.values():
        m.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: m.launches for name, m in kernel_mods.items()}


def captured(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text). The
    text goes to stderr when the call raises."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args), buf.getvalue()
    except BaseException:
        print(buf.getvalue()[-6000:], file=sys.stderr)
        raise


def cli_run(cli, argv):
    """``cli.main(argv)`` with its standard output captured: (its result,
    the uint8 images it handed its encoder, its ``-v`` stage splits). The
    captured output goes to stderr when the run raises."""
    import numpy as np

    seen = []
    encode = getattr(cli, "_encode_u8", None)
    if encode is not None:
        cli._encode_u8 = lambda u8, path, q: seen.append(np.array(u8)) or encode(u8, path, q)
    try:
        out, text = captured(cli.main, argv)
    finally:
        if encode is not None:
            cli._encode_u8 = encode
    stages = [{k: float(v) for k, v, _ in STAGE.findall(line)}
              for line in text.splitlines() if line.startswith("stages: ")]
    return out, seen, stages


def cli_batches(h: int, w: int) -> int:
    """K2 launches (tile batches) of one h x w image through the CLIs'
    default tiling (cs 504 / ucs 480, adapted to small images; batch 8)."""
    from nind_denoise_tpu_torch.core.tiles import TilePlan, adapt_cs_ucs
    from nind_denoise_tpu_torch.models.utnet import check_cs

    plan = TilePlan(h, w, *adapt_cs_ucs(h, w, 504, 480, check=check_cs))
    return (plan.ipervl + 1) * math.ceil((plan.iperhl + 1) / 8)


def max_lsb(a, b) -> int:
    check(a.shape == b.shape, f"shapes differ: {a.shape} vs {b.shape}")
    return int(abs(a.astype(int) - b.astype(int)).max())


def phase_cli_plugin(torch, card, tmp, kernel_mods, tif):
    """The darktable plugin's command line, from its Lua template, with no
    model flag: the checkpoint is the model table's default path under the
    working directory. Returns the launch counts of the plugin's runs."""
    import cv2

    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.models.utnet import UtNet
    from nind_denoise_tpu_torch.pipeline import denoise_cli
    from nind_denoise_tpu_torch.tools import fixtures

    cwd = os.path.join(tmp, "plugin")
    ckpt = os.path.join(cwd, "models", "nind", "generator_650.pt")
    os.makedirs(os.path.dirname(ckpt))
    fixtures.write_torch_checkpoint(ckpt, FUNIT, seed=14)
    work = os.path.join(cwd, "ndtpu_out") + os.sep
    ref_dir = os.path.join(cwd, "model_path_runs")
    os.makedirs(work)
    os.makedirs(ref_dir)
    total = {name: 0 for name in kernel_mods}
    cases = []
    old_cwd = os.getcwd()
    os.chdir(cwd)
    try:
        for sigma in (1, 10):  # 10: R 30, K1's top and the plugin's maximum
            argv = fixtures.plugin_command("nind-denoise", tif, work, sigma=sigma)
            check(not any(a.startswith("--model") for a in argv), f"model flag in {argv}")
            t0 = time.time()
            (out, seen, _), launches = counted(torch, kernel_mods,
                                               lambda: cli_run(denoise_cli, argv[1:]))
            wall = time.time() - t0
            check(launches["enc1"] == cli_batches(*HW) and launches["rl_iter"] == 10
                  and launches["gauss_blur"] == 0, f"plugin sigma {sigma}: {launches}")
            for k in total:
                total[k] += launches[k]
            jpg = cv2.imread(str(out))
            check(str(out).startswith(work) and jpg is not None
                  and jpg.shape == (*HW, 3), f"plugin sigma {sigma}: bad output {out}")
            _, ref, _ = cli_run(denoise_cli, [tif, "--tiff-input", "-o", ref_dir, "-q", "97",
                                              "--sigma", str(sigma), "--model_path", ckpt])
            diff = max_lsb(seen[0], ref[0])
            check(diff <= 1, f"plugin sigma {sigma}: {diff} LSB off the --model_path run")
            cases.append(dict(sigma=sigma, argv=argv, launches=launches, wall_s=wall,
                              output=os.path.basename(str(out)), jpeg_shape=list(jpg.shape),
                              max_lsb_vs_model_path=diff))
        # the warm stage split of the same command line under -v
        argv = fixtures.plugin_command("nind-denoise", tif, work, sigma=1)
        _, _, stages = cli_run(denoise_cli, argv[1:] + ["-v"])
    finally:
        os.chdir(old_cwd)

    # the checkpoint load as the port does it (built on the meta device,
    # tensors assigned) beside an eager build + load of the same file
    def eager():
        model = UtNet(FUNIT)
        model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
        return model

    def best_of(fn, n=3):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    emit(card, phase="cli_plugin", shape=[*HW, 3], compute_dtype="bfloat16",
         template=fixtures.plugin_template(), cases=cases, stages_s=stages[0],
         load_s={"meta_device": best_of(lambda: params_io.load_generator(ckpt)),
                 "eager": best_of(eager)})
    return total


def phase_cli_raw(torch, card, tmp, kernel_mods, ckpt):
    """A RAW file and its sidecar through the darktable stand-in. Returns
    the launch counts of the warm run."""
    import cv2

    from nind_denoise_tpu_torch.pipeline import denoise_cli
    from nind_denoise_tpu_torch.tools import fixtures

    d = os.path.join(tmp, "raw")
    os.makedirs(d)
    tools = os.path.join(ROOT, "build", "chip_smoke_tools")  # exec-able, in the checkout
    os.makedirs(tools, exist_ok=True)
    log = os.path.join(d, "tools.jsonl")
    dt = fixtures.write_darktable(os.path.join(tools, "darktable-cli"), log, *HW, seed=15)
    raw = os.path.join(d, "img.nef")
    with open(raw, "wb") as f:
        f.write(b"stand-in RAW: the darktable stand-in develops a seeded image")
    with open(raw + ".xmp", "w") as f:
        f.write(fixtures.SIDECAR)
    argv = [raw, "--dt", dt, "--model_path", ckpt, "-o", d, "-v"]
    cli_run(denoise_cli, argv)  # cold: the RAW path's own engine
    t0 = time.time()
    (out, seen, stages), launches = counted(torch, kernel_mods,
                                            lambda: cli_run(denoise_cli, argv))
    wall = time.time() - t0
    check(launches["enc1"] == cli_batches(*HW) and launches["rl_iter"] == 10,
          f"cli_raw: {launches}")
    jpg = cv2.imread(str(out))
    check(jpg is not None and jpg.shape == (*HW, 3) and seen[0].shape == jpg.shape,
          f"cli_raw: bad output {out}")
    calls = fixtures.read_log(log)
    check(len(calls) == 4, f"cli_raw: {len(calls)} darktable calls, expected 2 a run")
    s1, s2 = calls[2]["argv"], calls[3]["argv"]
    contract = (s1[0] == raw and s1[1].endswith("img.nef.s1.xmp") and s1[2] == "img_1_s1.tif"
                and "plugins/imageio/format/tiff/bpp=32" in s1
                and "plugins/imageio/format/tiff/compress=0" in s1
                and s2[0].endswith("img_1_s1_denoised.tiff") and s2[1].endswith("img.nef.s2.xmp")
                and s2[2] == "img_1_s2.tif" and "plugins/imageio/format/tiff/bpp=16" in s2
                and s2[s2.index("--height") + 1] == "0")
    check(contract, f"cli_raw: darktable argv off the contract: {s1} {s2}")
    emit(card, phase="cli_raw", standin="darktable-cli stand-in, tools/fixtures.py",
         shape=[*HW, 3], compute_dtype="bfloat16", wall_s=wall, launches=launches,
         stages_s=stages[0], darktable_argv=[s1, s2], output=os.path.basename(str(out)))
    return launches


def phase_cli_dir(torch, card, tmp, kernel_mods, ckpt):
    """A directory of four 6 MP TIFFs: one checkpoint load, one engine, and
    each output within 1 LSB of that file's own run. Returns the launch
    counts of the directory run."""
    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.engine import tile_engine
    from nind_denoise_tpu_torch.pipeline import denoise_cli

    src, out_dir = os.path.join(tmp, "dir_in"), os.path.join(tmp, "dir_out")
    os.makedirs(src)
    os.makedirs(out_dir)
    rng = np.random.default_rng(16)
    files = []
    for i in range(4):
        files.append(os.path.join(src, f"f{i}.tif"))
        check(cv2.imwrite(files[-1], rng.integers(0, 65536, (*HW, 3)).astype(np.uint16)),
              "could not write the TIFF")
    loads, engines, walls = [], [], []
    load, engine_cls, one_file = (denoise_cli.params_io.load_generator,
                                  tile_engine.TileEngine, denoise_cli.denoise_file)

    class Counted(engine_cls):
        def __init__(self, *a, **kw):
            engines.append(a[1:3])
            super().__init__(*a, **kw)

    def timed(*a, **kw):
        t0 = time.time()
        try:
            return one_file(*a, **kw)
        finally:
            torch.cuda.synchronize()
            walls.append(time.time() - t0)

    denoise_cli.params_io.load_generator = lambda *a, **kw: loads.append(a) or load(*a, **kw)
    tile_engine.TileEngine = Counted
    denoise_cli.denoise_file = timed
    try:
        (outs, batch, stages), launches = counted(
            torch, kernel_mods, lambda: cli_run(denoise_cli, [
                src, "--tiff-input", "--model_path", ckpt, "-o", out_dir, "-v"]))
    finally:
        denoise_cli.params_io.load_generator = load
        tile_engine.TileEngine = engine_cls
        denoise_cli.denoise_file = one_file
    check(len(loads) == 1 and len(engines) == 1,
          f"cli_dir: {len(loads)} checkpoint loads and {len(engines)} engines")
    check(launches["enc1"] == 4 * cli_batches(*HW) and launches["rl_iter"] == 40,
          f"cli_dir: {launches}")
    check([os.path.basename(str(o)) for o in outs] == [f"f{i}.jpg" for i in range(4)],
          f"cli_dir: outputs {outs}")
    diffs = []
    for i, f in enumerate(files):
        single = os.path.join(tmp, f"single{i}")
        os.makedirs(single)
        _, one, _ = cli_run(denoise_cli, [f, "--tiff-input", "--model_path", ckpt,
                                          "-o", single])
        diffs.append(max_lsb(batch[i], one[0]))
    check(max(diffs) <= 1, f"cli_dir: outputs off their single runs by {diffs} LSB")
    emit(card, phase="cli_dir", files=4, shape=[*HW, 3], compute_dtype="bfloat16",
         checkpoint_loads=len(loads), engines=len(engines), launches=launches,
         image_wall_s=walls, load_s=[st.get("load", 0.0) for st in stages],
         stages_s=stages, max_lsb_vs_single_runs=max(diffs))
    return launches


def phase_whole_image(torch, card, tmp, kernel_mods, ckpt, tif):
    """``denoise_image --whole_image --pad 8`` on the 6 MP TIFF in bf16,
    then K2 at the input that run gave it. Returns the run's counts."""
    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.pipeline import denoise_image_cli

    out = os.path.join(tmp, "whole.tif")
    argv = ["-i", tif, "-o", out, "--network", "UtNet", "--model_path", ckpt,
            "--whole_image", "--pad", "8", "--exif_method", "noexif"]
    cli_run(denoise_image_cli, argv)  # cold: cuDNN picks its algorithms
    rec = record_inputs(E, "enc1", lambda x, *w: (tuple(x.shape), str(x.dtype)))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        _, launches = counted(torch, kernel_mods, lambda: cli_run(denoise_image_cli, argv))
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        rec["restore"]()
    check(launches["enc1"] == 1 and launches["rl_iter"] == 0, f"whole_image: {launches}")
    img = cv2.imread(out, cv2.IMREAD_UNCHANGED)
    check(img is not None and img.shape == (*HW, 3) and img.dtype == np.uint16,
          "whole_image: bad output")
    (key, args), = rec["seen"].items()
    with torch.inference_mode():
        k2 = enc1_record(torch, E, args, 10)
    emit(card, phase="whole_image", shape=[*HW, 3], pad=8, compute_dtype="bfloat16",
         wall_s=wall, peak_memory_allocated_bytes=peak, peak_memory_allocated_gib=peak / 2 ** 30,
         launches=launches, enc1_input=list(key[0]), enc1=k2)
    return launches


# -- P1 (int8 conv) and P2 (Deriche) -------------------------------------------

def torch_int8_conv_offer(torch):
    """What torch on the card offers for an int8 convolution: each probe
    and its outcome (a yardstick survey; the port calls none of them)."""
    import torch.nn.functional as F

    x = torch.ones(1, 32, 8, 8, dtype=torch.int8, device=DEV)
    w = torch.ones(32, 32, 3, 3, dtype=torch.int8, device=DEV)

    def quantized_conv():
        from torch.ao.nn.quantized import functional as qF

        q = lambda t: torch.quantize_per_tensor(t.float(), 0.1, 0, torch.qint8)
        return qF.conv2d(q(x), q(w), torch.zeros(32, device=DEV), scale=1.0,
                         zero_point=0)

    probes = {}
    for name, fn in (("F.conv2d(int8, int8)", lambda: F.conv2d(x, w)),
                     ("torch._int_mm(int8 (32, 64), int8 (64, 32))", lambda: torch._int_mm(
                         torch.ones(32, 64, dtype=torch.int8, device=DEV),
                         torch.ones(64, 32, dtype=torch.int8, device=DEV))),
                     ("torch.ao.nn.quantized.functional.conv2d (qint8)", quantized_conv)):
        try:
            out = fn()
            probes[name] = f"ok ({getattr(out, 'dtype', type(out).__name__)})"
        except Exception as e:  # a survey of what exists, not a port path
            probes[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return probes


def int_mm_library(torch, xq, wk, pads, dil, ho, wo):
    """The int32 conv as ``torch._int_mm`` over an im2col of the same int8
    input (built once, outside the timing): (run, or the error text)."""
    import torch.nn.functional as F

    n, h, w, c = xq.shape
    cout, k = wk.shape[0], wk.shape[1]
    x = xq
    if dil == 2:
        x = xq.new_zeros((n, 2 * h - 1, 2 * w - 1, c))
        x[:, ::2, ::2] = xq
    pt, pb, pl, pr = pads
    x = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).permute(0, 2, 3, 1).contiguous()
    hp, wp = x.shape[1], x.shape[2]
    cols = x.as_strided((n, ho, wo, k, k, c), (hp * wp * c, wp * c, c, wp * c, c, 1)) \
        .reshape(n * ho * wo, k * k * c)
    wmat = wk.permute(1, 2, 3, 0).reshape(k * k * c, cout).contiguous()
    try:
        torch._int_mm(cols, wmat)
    except Exception as e:  # torch on the card may lack it for these shapes
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return (lambda: torch._int_mm(cols, wmat)), (cols, wmat)


def phase_qconv(torch, card, batch: int = 8, cs: int = 504, f: int = 64,
                full_batch_plain_macs: float = 2e10):
    """P1 against its plain version at every int8 conv shape of the
    funit-``f`` forward on a batch of ``batch`` cs x cs tiles, in every
    epilogue variant the forward uses: the int32 sums; fp32 without bias
    (per-sample scales; the level-4 composed conv with its parity scales);
    bf16 with bias and PReLU (per-sample scales); the decoder's sum (an
    fp32 addend and bias map, bias, PReLU; a scalar scale); and each of the
    last two quantized to int8 with a static scale. Each is bit-equal on
    the first samples of the batch (all of them where the plain float64
    conv is cheap). Per shape: P1's warm time with bf16 out and the bias
    (the yardstick instance, no fused option) and in the epilogue the forward
    gives the site (``site_epilogue``), each with its bound (the fused
    instance's counts its addends' bytes), the plain version's time,
    ``torch._int_mm`` over an im2col of the same input, and cuDNN's bf16
    conv of the same shape."""
    import torch.nn.functional as F

    from nind_denoise_tpu_torch.models.utnet_int8 import conv_shapes, site_epilogue
    from nind_denoise_tpu_torch.ops import qconv as Q

    gen = torch.Generator(device=DEV).manual_seed(21)
    rows, totals = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                            cudnn_bf16_ms=0.0, fwd_ms=0.0, fwd_bound_ms=0.0)
    for site, h, cin, cout, k, pads, dil in conv_shapes(cs, f):
        kind, static_q = site_epilogue(site)
        ho, wo = Q.out_hw(h, h, k, k, pads, dil)
        xq = torch.randint(-127, 128, (batch, h, h, cin), dtype=torch.int8,
                           device=DEV, generator=gen)
        wk = torch.randint(-127, 128, (cout, k, k, cin), dtype=torch.int8,
                           device=DEV, generator=gen)
        sx = torch.rand(batch, device=DEV, generator=gen) * 1e-2 + 1e-3
        sx1 = sx[:1].clone()
        sw = torch.rand((2, cout) if site == "K3fq" else (cout,), device=DEV,
                        generator=gen) * 1e-3 + 1e-4
        bias = torch.rand(cout, device=DEV, generator=gen) - 0.5
        a = torch.full((1,), 0.25, device=DEV)
        qs = torch.full((1,), 0.02, device=DEV)
        addend = torch.randn(batch, ho, wo, cout, device=DEV, generator=gen)
        bmap = torch.randn(1, ho, wo, cout, device=DEV, generator=gen)
        dense = ho * wo * cout * cin * k * k * (4 if dil == 2 else 1)
        m = max(1, min(batch, int(full_batch_plain_macs // dense)))
        ref = Q.conv_i32_reference(xq[:m], wk, pads, dil)
        act = dict(bias=bias, out_dtype=torch.bfloat16, prelu=a)
        summ = dict(act, addend=addend, bias_map=bmap)
        variants = {  # name: (sx, options)
            "int32": (None, dict(out_dtype=torch.int32)),
            "f32_raw": (sx, dict(out_dtype=torch.float32)),
            "bf16_bias": (sx1, dict(bias=bias, out_dtype=torch.bfloat16)),
            "bf16_bias_prelu": (sx, act),
            "bf16_sum": (sx1, summ),
            "int8_bias_prelu": (sx1, dict(act, out_scale=qs)),
            "int8_sum": (sx1, dict(summ, out_scale=qs)),
        }
        eq = {}
        for name, (s_x, kw) in variants.items():
            got = Q.conv_int8(xq, wk, pads, dil, sx=s_x, sw=sw, **kw)
            if kw["out_dtype"] == torch.int32:
                want = ref
            else:
                sub = {key: (v[:m] if key == "addend" else v) for key, v in kw.items()}
                want = Q.dequant_reference(ref, s_x if s_x is sx1 else s_x[:m], sw,
                                           sub.get("bias"), sub["out_dtype"],
                                           sub.get("addend"), sub.get("bias_map"),
                                           sub.get("prelu"), sub.get("out_scale"))
            torch.cuda.synchronize()
            check(got.shape == (batch, ho, wo, cout), f"qconv {site} {name}: shape "
                                                      f"{tuple(got.shape)}")
            eq[name] = bool(torch.equal(got[:m], want))
            del got, want
        check(all(eq.values()), f"qconv {site} ({batch},{h},{h},{cin})->{cout}: "
                                f"not bit-equal {eq}")
        macs = Q.macs(batch, ho, wo, cin, cout, k, dil, pads[0])
        out_n = batch * ho * wo * cout
        nbytes = xq.numel() + wk.numel() + 2 * out_n + 4 * (3 * cout + batch)
        bms, by = bound_ms(nbytes, 2.0 * macs, "int8")
        reps = 5 if macs > 5e10 else 20
        ms = time_ms(torch, lambda: Q.conv_int8(xq, wk, pads, dil, sx=sx1, sw=sw, bias=bias,
                                                 out_dtype=torch.bfloat16), reps)
        # the epilogue the forward gives this site, its bytes in its bound
        fwd_kw = {"raw": dict(out_dtype=torch.float32), "act": act, "sum": summ}[kind]
        fwd_sx = sx if kind != "sum" else sx1
        fwd_bytes = xq.numel() + wk.numel() + 4 * (3 * cout + batch) + \
            out_n * (4 if kind == "raw" else 2) + (4 * out_n + 4 * ho * wo * cout) * (kind == "sum")
        fwd_bms, fwd_by = bound_ms(fwd_bytes, 2.0 * macs, "int8")
        fwd_ms = time_ms(torch, lambda: Q.conv_int8(xq, wk, pads, dil, sx=fwd_sx, sw=sw,
                                                     **fwd_kw), reps)
        plain = time_ms(torch, lambda: Q.conv_int8_reference(
            xq[:m], wk, pads, dil, sx1, sw, bias, torch.bfloat16), 1)
        lib_run, lib_info = int_mm_library(torch, xq, wk, pads, dil, ho, wo)
        rec = dict(site=site, input=[batch, h, h, cin], cout=cout, k=k, pads=list(pads),
                   lhs_dilation=dil, output=[batch, ho, wo, cout], macs=macs,
                   checked_samples=m, bit_equal=eq, ms=ms, bound_ms=bms, bound_by=by,
                   epilogue=kind, fwd_ms=fwd_ms, fwd_bound_ms=fwd_bms, fwd_bound_by=fwd_by,
                   plain_ms=plain, plain_samples=m)
        if static_q:
            rec["fwd_int8_ms"] = time_ms(torch, lambda: Q.conv_int8(
                xq, wk, pads, dil, sx=sx1, sw=sw, out_scale=qs, **fwd_kw), reps)
        if lib_run is None:
            rec["int_mm_ms"], rec["int_mm_error"] = None, lib_info
        else:
            rec["int_mm_ms"] = time_ms(torch, lib_run, reps)
            rec["int_mm_equal"] = bool(torch.equal(
                lib_run().reshape(batch, ho, wo, cout),
                Q.conv_int8(xq, wk, pads, dil, out_dtype=torch.int32)))
            del lib_info
        # cuDNN's bf16 conv of the same shape (channels_last), a yardstick
        xb = xq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        if dil == 2:
            wb = wk.to(torch.bfloat16).permute(3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last)  # (cin, cout, k, k)
            cud = lambda: F.conv_transpose2d(xb, wb, stride=2)
        else:
            wb = wk.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            cud = lambda: F.conv2d(xb, wb, padding=pads[0])
        check(tuple(cud().shape) == (batch, cout, ho, wo), f"qconv {site}: cuDNN shape")
        rec["cudnn_bf16_ms"] = time_ms(torch, cud, reps)
        emit(card, phase="qconv", **rec)
        rows.append(rec)
        for key in totals:
            totals[key] += rec[key if key != "library_ms" else "int_mm_ms"] or 0.0
        del xq, wk, ref, xb, wb, addend, bmap
        torch.cuda.empty_cache()
    heavy = sorted(rows, key=lambda r: -r["ms"])[:5]
    emit(card, phase="qconv_summary", batch=batch, cs=cs, funit=f, convs=len(rows),
         offer=torch_int8_conv_offer(torch),
         heaviest=[dict(site=r["site"], ms=r["ms"], fwd_ms=r["fwd_ms"], bound_ms=r["bound_ms"],
                        int_mm_ms=r["int_mm_ms"], cudnn_bf16_ms=r["cudnn_bf16_ms"])
                   for r in heavy], **{f"sum_{k}": v for k, v in totals.items()})
    return dict(max_abs_err=0.0, ms=totals["ms"], plain_ms=totals["plain_ms"],
                bound_ms=totals["bound_ms"], bound_by="operations",
                library_ms=totals["library_ms"] or None, shapes=len(rows))


def phase_deriche(torch, card):
    """P2, the chunked scan, at the CLI's (3, 2000, 3000) and a server
    group's (24, 480, 480) planes, sigma 1 and 10, along each axis, and at
    lines longer than one tile's segment ((1, 6, 40000) along W, (3, 9000,
    24) along H: a carry pass and the main pass): bit-equal to
    ``deriche_axis_chunked`` (the kernel keeps its order) and within
    ``error_bound`` of the sequential loop run in float64, which the plain
    fp32 loop must meet too. The warm time through the wrapper, the plain
    loop's, and the byte bound (8 bytes an element). No single PyTorch call
    computes a recursive filter, so there is no library time."""
    from nind_denoise_tpu_torch.ops import deriche as D

    gen = torch.Generator(device=DEV).manual_seed(22)
    out, errs = {}, []
    cases = [(shape, sigma, axis) for shape in ((3, 2000, 3000), (24, 480, 480))
             for sigma in (1.0, 10.0) for axis in (1, 2)]
    cases += [((1, 6, 40000), 10.0, 2), ((3, 9000, 24), 10.0, 1)]
    for shape, sigma, axis in cases:
        x = torch.rand(shape, device=DEV, generator=gen) + 0.05
        before = D.launches
        y = D.deriche_axis(x, sigma, axis)
        launches = D.launches - before
        mirror = D.deriche_axis_chunked(x, sigma, axis)
        ref = D.deriche_axis_reference(x, sigma, axis)
        y64 = D.deriche_axis_reference(x.double(), sigma, axis)
        torch.cuda.synchronize()
        geo = D.geometry(shape[axis], axis)
        check(launches == (2 if geo.segments > 1 else 1),
              f"deriche {shape} axis {axis}: {launches} launches for {geo.segments} segments")
        check(torch.equal(y, mirror), f"deriche {shape} sigma {sigma} axis {axis}: differs "
              f"from the chunked order by {(y - mirror).abs().max().item()}")
        bound = D.error_bound(sigma, x.abs().max().item())
        err64 = (y.double() - y64).abs().max().item()
        plain64 = (ref.double() - y64).abs().max().item()
        check(err64 <= bound and plain64 <= bound,
              f"deriche {shape} sigma {sigma} axis {axis}: |y - y64| {err64}, the plain "
              f"loop's {plain64}, bound {bound}")
        err = (y - ref).abs().max().item()
        errs.append(err)
        rec = dict(shape=list(shape), sigma=sigma, axis=axis, launches=launches,
                   segments=geo.segments, equal_to_chunked_order=True, max_abs_err=err,
                   err_f64=err64, plain_err_f64=plain64, error_bound=bound)
        if shape in ((3, 2000, 3000), (24, 480, 480)):
            bms, by = bound_ms(8.0 * x.numel(), 0.0, "float32")
            o = torch.empty_like(x)
            rec.update(ms=time_ms(torch, lambda: D.deriche_axis(x, sigma, axis, out=o), 20),
                       plain_ms=time_ms(torch, lambda: D.deriche_axis_reference(
                           x, sigma, axis), 1),
                       bound_ms=bms, bound_by=by, library_ms=None)
            out[(shape, sigma, axis)] = rec
        emit(card, phase="deriche", **rec)
        del x, y, mirror, ref, y64
    # the kernels line: one 6 MP blur at sigma 1 (both axes), as RL runs it
    h = out[((3, 2000, 3000), 1.0, 1)]
    w = out[((3, 2000, 3000), 1.0, 2)]
    return dict(max_abs_err=max(errs), ms=(h["ms"] + w["ms"]) / 2,
                plain_ms=(h["plain_ms"] + w["plain_ms"]) / 2,
                bound_ms=h["bound_ms"], bound_by="bytes", library_ms=None)


def psnr_u8(a, b) -> float:
    import numpy as np

    d = a.astype(np.float64) - b.astype(np.float64)
    return float(10 * np.log10(255.0 ** 2 / max((d ** 2).mean(), 1e-20)))


def phase_int8(torch, card, tmp, kernel_mods, tif, ckpt):
    """``denoise_cli --tiff-input`` on the 6 MP TIFF with ``--compute_dtype
    int8`` and ``int8_static`` (bf16 tile I/O), each against a float32 run
    (no TF32) of the same image in this process: P1, K2 and K1 launches
    (a forward launches P1 20 times, 21 in int8_static, whose engine build
    and per-image calibration add an observing forward of 20 each, as in
    the JAX CLI's serial path), wall, device time under
    the profiler, and the PSNR of the pre-encode uint8 against the float32
    run, held at the engine floors of tests/test_qconv.py (45 / 42 dB).
    Then the forward alone on a batch of 8 x 504^2 tiles, int8 and
    int8_static against bf16. Returns the launch counts by run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.models.utnet import UtNet
    from nind_denoise_tpu_torch.models.utnet_int8 import QuantUtNet
    from nind_denoise_tpu_torch.ops.qconv import calib_tiles
    from nind_denoise_tpu_torch.pipeline import denoise_cli

    outdir = os.path.join(tmp, "int8")
    os.makedirs(outdir)
    base = [tif, "--tiff-input", "--model_path", ckpt, "-o", outdir, "--batch_size", "8"]
    _, (ref,), _ = cli_run(denoise_cli, base + ["--compute_dtype", "float32",
                                                "--precision", "float32"])
    batches = cli_batches(*HW)
    by_run = {}
    for mode, floor in (("int8", 45.0), ("int8_static", 42.0)):
        argv = base + ["--compute_dtype", mode]
        cli_run(denoise_cli, argv)  # cold: cuDNN picks its algorithms
        t0 = time.time()
        (_, (got,), _), launches = counted(torch, kernel_mods,
                                           lambda: cli_run(denoise_cli, argv))
        wall = time.time() - t0
        per_fwd = 21 if mode == "int8_static" else 20
        # int8_static observes two calibration forwards of 20 convs: the
        # engine's build (the synthetic set) and the image's own crops
        calib = 40 if mode == "int8_static" else 0
        want = dict(qconv=per_fwd * batches + calib, rl_iter=10, gauss_blur=0, deriche=0,
                    enc1=batches if mode == "int8" else 0)
        check(all(launches[k] == v for k, v in want.items()),
              f"int8 cli {mode}: launches {launches}, expected {want}")
        db = psnr_u8(got, ref)
        check(db >= floor, f"int8 cli {mode}: PSNR {db:.2f} dB against float32 < {floor}")
        # P1's epilogue options round as the torch passes they replace, so
        # the PSNR reads as before them (the same image, weights and card)
        check(round(db, 2) == INT8_CLI_PSNR_DB[mode],
              f"int8 cli {mode}: PSNR {db:.4f} dB, expected {INT8_CLI_PSNR_DB[mode]}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cli_run(denoise_cli, argv)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        emit(card, phase="int8_cli", compute_dtype=mode, shape=[*HW, 3], wall_s=wall,
             launches=launches, expected_launches=want, psnr_db_vs_float32=db,
             floor_db=floor, device_ms=device_ms, device_busy_share=device_ms / 1e3 / wall,
             top_device_ms={e.key[:90]: e.self_device_time_total / 1e3 for e in top})
        by_run[f"int8_cli_{mode}"] = launches

    # the forward alone, one batch of 8 x 504^2 bf16 tiles
    model = params_io.load_generator(ckpt, "UtNet", "PReLU")
    gen = torch.Generator(device=DEV).manual_seed(23)
    x = torch.rand(FWD[0], 3, FWD[1], FWD[1], device=DEV, generator=gen).to(torch.bfloat16)
    fwd, top, p1_share = {}, {}, {}
    with torch.inference_mode():
        bf16 = UtNet(FUNIT)
        bf16.load_state_dict(model.state_dict())
        bf16 = bf16.to(DEV, torch.bfloat16).eval()
        nets = {"bfloat16": bf16}
        for mode in ("int8", "int8_static"):
            nets[mode] = QuantUtNet(model, static=mode == "int8_static", device=DEV)
            if nets[mode].static:
                nets[mode].calibrate(calib_tiles())
        for mode, net in nets.items():
            fwd[mode] = time_ms(torch, lambda: net(x), 5)
            # the device kernels of one warm forward, by name
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                net(x)
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            total = sum(e.self_device_time_total for e in kernels)
            top[mode] = {e.key[:90]: e.self_device_time_total / 1e3 for e in sorted(
                kernels, key=lambda e: -e.self_device_time_total)[:8]}
            p1_share[mode] = sum(e.self_device_time_total for e in kernels
                                 if "qconv_kernel" in e.key) / max(total, 1e-9)
    emit(card, phase="int8_forward", batch=[FWD[0], FWD[1], FWD[1]], funit=FUNIT, ms=fwd,
         int8_over_bf16=fwd["int8"] / fwd["bfloat16"],
         int8_static_over_bf16=fwd["int8_static"] / fwd["bfloat16"],
         p1_share_of_device_time=p1_share, top_device_ms=top)
    return by_run


def phase_int8_serve(torch, card, tmp, kernel_mods, ckpt):
    """A short server window with ``--compute_dtype int8_static``: one 6 MP
    request, then eight 480 x 480 requests queued at once behind the
    parked dispatcher. Each response must equal the engine + RL run of the
    same request (which recalibrates on its image first, as the service
    does), and no group may coalesce in the engine. Returns the window's
    launch counts."""
    import threading
    import urllib.request

    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.engine import tile_engine
    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.pipeline import serve as S

    svc = S.DenoiseService("UtNet", ckpt, cs=504, ucs=480, batch_size=8,
                           compute_dtype="int8_static")
    httpd = S.serve(svc, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    coalesced = []
    many = tile_engine.TileEngine.denoise_many

    def spy(self, *a, **kw):
        coalesced.append(len(a[0]))
        return many(self, *a, **kw)

    tile_engine.TileEngine.denoise_many = spy
    rng = np.random.default_rng(24)
    q = "output=png&rl=1&sigma=1&iterations=10"

    def png(img):
        ok, buf = cv2.imencode(".png", img[..., ::-1])
        check(ok, "PNG encode failed")
        return buf.tobytes()

    def post(data):
        req = urllib.request.Request(f"{base}/denoise?{q}", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    def decode(body):
        return cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]

    def direct(raw):
        out = svc._adaptive.denoise_raw(raw, 65535.0, out_dtype="device")
        return RL.rl_to_u8_device(out, 1.0, 10).cpu().numpy()

    try:
        big = rng.integers(0, 65536, (*HW, 3), dtype=np.uint16)
        smalls = [rng.integers(0, 65536, (480, 480, 3), dtype=np.uint16) for _ in range(8)]

        def window():
            t0 = time.time()
            first = post(png(big))
            lat_big = time.time() - t0
            release, gate = threading.Event(), threading.Event()
            blocker = threading.Thread(
                target=lambda: svc.submit(lambda: gate.set() or release.wait(120)))
            blocker.start()
            check(gate.wait(60), "dispatcher did not park")
            bodies = [None] * 8
            hits = [threading.Thread(target=lambda i=i: bodies.__setitem__(
                i, post(png(smalls[i])))) for i in range(8)]
            for t in hits:
                t.start()
            deadline = time.time() + 60
            while svc._q.qsize() < 8 and time.time() < deadline:
                time.sleep(0.01)
            t0 = time.time()
            release.set()
            for t in hits + [blocker]:
                t.join(300)
            return first, bodies, lat_big, time.time() - t0

        (first, bodies, lat_big, lat_burst), launches = counted(torch, kernel_mods, window)
        stats = svc.snapshot_stats()
        check(np.array_equal(decode(first), direct(big)),
              "int8_static serve: 6 MP response differs from the engine + RL run")
        for i, body in enumerate(bodies):
            check(body is not None and np.array_equal(decode(body), direct(smalls[i])),
                  f"int8_static serve: 480^2 response {i} differs from the engine + RL run")
        check(not coalesced, f"int8_static serve: engine groups coalesced {coalesced}")
        emit(card, phase="int8_serve", compute_dtype="int8_static", latency_s_6mp=lat_big,
             burst_of_8_480_s=lat_burst, launches=launches,
             dispatcher_group_sizes=stats["group_sizes"], engine_coalesced_groups=0,
             responses_equal_to_engine_plus_rl=True)
    finally:
        tile_engine.TileEngine.denoise_many = many
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    return launches


def phase_rl_variants(torch, card, tmp, kernel_mods, tif, ckpt):
    """RL's other variants at 6 MP: ``denoise_cli --rl-psf gmic_fast``
    (sigma 1 x 10: 40 P2 launches, no K1); RL with psf gmic_fast through P2
    against RL with P2 swapped for its plain loop, at 6 MP sigma 1 and a
    server group (8 x 480 x 480 x 3) at sigma 10: uint8 within 1 LSB, at
    least 99.9 % equal, and the ten iterations' warm time; then RL with
    dt 0.5 at sigma 1
    through ``rl_deblur_to_uint8`` (20 K3 launches, no K1), held bit-equal
    to the same iteration with K3 swapped for its plain version. Returns
    the launch counts by run."""
    import numpy as np

    from nind_denoise_tpu_torch.ops import gauss_blur as G
    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.ops import rl_fused
    from nind_denoise_tpu_torch.pipeline import denoise_cli

    outdir = os.path.join(tmp, "gmic_fast")
    os.makedirs(outdir)
    argv = [tif, "--tiff-input", "--model_path", ckpt, "-o", outdir, "--rl-psf", "gmic_fast"]
    cli_run(denoise_cli, argv)  # cold
    t0 = time.time()
    (out, (u8,), _), gmic = counted(torch, kernel_mods, lambda: cli_run(denoise_cli, argv))
    wall = time.time() - t0
    check(gmic["deriche"] == 40 and gmic["rl_iter"] == 0 and gmic["gauss_blur"] == 0
          and gmic["enc1"] == cli_batches(*HW), f"gmic_fast cli: launches {gmic}")
    check(u8.shape == (*HW, 3), "gmic_fast cli: bad output")
    emit(card, phase="gmic_fast_cli", shape=[*HW, 3], sigma=1, iterations=10, wall_s=wall,
         launches=gmic, output=os.path.basename(str(out)))

    # RL through P2 against RL with P2 swapped for its plain version (the
    # sequential loop): P2 keeps the chunked order, so the uint8 may move
    # by one LSB where a value sits at a rounding edge, on few pixels
    from nind_denoise_tpu_torch.ops import deriche as D

    rng = np.random.default_rng(26)
    for name, img, sigma in (("6mp", rng.random((*HW, 3), dtype=np.float32), 1.0),
                             ("server_group", rng.random((8, 480, 480, 3), dtype=np.float32),
                              10.0)):
        u8_k = RL.rl_deblur_to_uint8(img, sigma, 10, psf="gmic_fast")
        kernel_axis = D.deriche_axis
        D.deriche_axis = lambda x, s, a, out=None: D.deriche_axis_reference(x, s, a)
        try:
            u8_p = RL.rl_deblur_to_uint8(img, sigma, 10, psf="gmic_fast")
        finally:
            D.deriche_axis = kernel_axis
        diff = np.abs(u8_k.astype(np.int16) - u8_p.astype(np.int16))
        equal = float((diff == 0).mean())
        check(u8_k.shape == u8_p.shape and diff.max() <= 1 and equal >= 0.999,
              f"gmic_fast RL {name}: P2 against the plain loop: max {diff.max()} LSB, "
              f"{equal:.6f} equal")
        xg = torch.from_numpy(img).to(DEV)
        t_rl = time_ms(torch, lambda: RL.rl_deblur(xg, sigma, 10, psf="gmic_fast"), 3)
        emit(card, phase="gmic_fast_rl_vs_plain", case=name, shape=list(img.shape), sigma=sigma,
             iterations=10, max_lsb=int(diff.max()), equal_share=equal, ms_10_iterations=t_rl)
        del xg

    img = np.random.default_rng(25).random((*HW, 3), dtype=np.float32)
    x = torch.from_numpy(img).to(DEV)
    u8_k, dt_launches = counted(torch, kernel_mods,
                                lambda: RL.rl_deblur_to_uint8(img, 1.0, 10, 0.5))
    check(dt_launches["gauss_blur"] == 20 and dt_launches["rl_iter"] == 0
          and dt_launches["deriche"] == 0, f"rl dt 0.5: launches {dt_launches}")
    u_k = RL.rl_deblur(x, 1.0, 10, 0.5)
    blur = G.blur_planes
    G.blur_planes = lambda t, taps, out=None: rl_fused.blur(t, taps.tolist())
    try:
        u_p = RL.rl_deblur(x, 1.0, 10, 0.5)
        u8_p = RL.rl_deblur_to_uint8(img, 1.0, 10, 0.5)
    finally:
        G.blur_planes = blur
    torch.cuda.synchronize()
    err = (u_k - u_p).abs().max().item()
    check(torch.equal(u_k, u_p) and np.array_equal(u8_k, u8_p),
          f"rl dt 0.5: K3 route differs from the plain iteration (max err {err})")
    t_k = time_ms(torch, lambda: RL.rl_deblur(x, 1.0, 10, 0.5), 3)
    emit(card, phase="rl_dt", shape=[*HW, 3], sigma=1, iterations=10, dt=0.5,
         launches=dt_launches, bit_equal_to_plain=True, max_abs_err=err, ms_10_iterations=t_k)
    return {"gmic_fast_cli": gmic, "rl_dt": dt_launches}


# -- generator training ----------------------------------------------------

# the train phase's tolerances for one fp32 step (TF32 off) from the same
# weights and batch on the card and on the CPU, set before its first run:
# the loss to 1e-5; the updated parameters: none apart by more than the
# learning rate, and at most 0.1 % of them by more than 1 % of it. The
# gradient is held as a whole, its difference to 1e-3 of its norm: a tensor
# whose gradient is a cancelling sum (a bias, a PReLU slope) is
# ill-conditioned on either device, so each device's per-tensor error
# against a float64 step is reported, not held.
# The held step resumes the checkpoint as the trainer does (its weights and
# its AMSGrad moments and counts). From a fresh optimizer state, AMSGrad's
# first step moves each element by lr * g / (|g| + 1e-8), about the learning
# rate whatever the gradient's size, so an element whose gradient is
# rounding noise near 1e-8 moves by up to twice the learning rate apart on
# two devices; the CPU's own fp32 step lies that far from the float64 step
# on some trained weights. That step is reported beside the held one, not
# held.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_SHARE = 1e-5, 1e-3, 1e-3


def write_train_crops(root, val_yaml, scenes, crops, size=192, seed=0):
    """Seeded synthetic crops in the NIND layout
    (``<root>/<scene>/ISO<v>/<DS>_<scene>_<iso>_<x>_<y>_<ucs>.png``, 16 bit):
    smooth images, clean at ISO200 and with Gaussian noise at ISO3200;
    ``val_yaml`` lists three (clean, noisy) pairs."""
    import cv2
    import numpy as np
    import yaml
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    pairs = []
    for s in range(scenes):
        for x in range(crops):
            clean = gaussian_filter(rng.random((size, size, 3), np.float32), (3, 3, 0))
            clean = (clean - clean.min()) / np.ptp(clean)
            for iso, sigma in (("ISO200", 0.0), ("ISO3200", 0.08)):
                d = os.path.join(root, f"scene{s}", iso)
                os.makedirs(d, exist_ok=True)
                img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
                path = os.path.join(d, f"SYN_scene{s}_{iso}_{x * size}_0_{size}.png")
                check(cv2.imwrite(path, (img * 65535).astype(np.uint16)), path)
            pairs.append([os.path.join(root, f"scene{s}", iso,
                                       f"SYN_scene{s}_{iso}_{x * size}_0_{size}.png")
                          for iso in ("ISO200", "ISO3200")])
    with open(val_yaml, "w") as f:
        yaml.safe_dump(pairs[:3], f)


def train_batch(torch, root, batch, cs):
    """The first batch the trainer's loader gives for the synthetic crops,
    as NCHW float32 CPU tensors (clean, noisy)."""
    from nind_denoise_tpu_torch.train import dataset as ds_mod

    loader = ds_mod.Loader(ds_mod.DenoisingDataset([root], cs=cs, seed=0), batch,
                           num_threads=1, seed=0)
    clean, noisy = next(iter(loader))
    return (torch.from_numpy(clean).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(noisy).permute(0, 3, 1, 2).contiguous())


def train_step_times(torch, ckpt, clean, noisy, reps=5, network="UtNet", weights=None,
                     loss_cs=None, dtypes=("float32", "bfloat16")):
    """Warm steps of ``network`` (default ``utnet_std``: MS-SSIM, AMSGrad,
    lr 1e-4, beta1 0.75) from ``ckpt`` on one batch per compute dtype, fp32
    (TF32 off) and bf16 (``steps.bf16_apply``): ms a step from CUDA events,
    crops/s, the peak memory allocated, device time a step, its largest
    kernels and the BatchNorm kernels' share of it."""
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.train import steps

    clean, noisy = clean.to(DEV), noisy.to(DEV)
    out = {}
    for dtype in dtypes:
        apply = steps.bf16_apply if dtype == "bfloat16" else steps.plain_apply
        model = params_io.load_generator(ckpt, network).to(DEV).train()
        state = steps.TrainState(model, steps.make_optimizer(model, 1e-4, 0.75))
        step = steps.make_generator_train_step(apply, weights or {"MSSSIM": 1},
                                               loss_cs or clean.shape[-1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, lambda: step(state, clean, noisy), reps)
        peak = torch.cuda.max_memory_allocated()
        loss = float(step(state, clean, noisy)["weighted"])
        check(0 < loss < 1, f"{network} train step {dtype}: loss {loss}")
        # where a step's device time goes: two more steps under the profiler
        kernels = device_kernels(torch, lambda: [step(state, clean, noisy) for _ in range(2)],
                                 top=None)
        device_ms = sum(kernels.values())
        bn_ms = sum(v for k, v in kernels.items()
                    if re.search(r"batch_?norm|bn_(fw|bw)|welford", k, re.I))
        out[dtype] = {"ms_per_step": ms, "crops_per_s": clean.shape[0] / ms * 1e3,
                      "peak_memory_allocated_gib": peak / 2 ** 30, "loss": loss,
                      "device_ms_per_step": device_ms / 2,
                      "bn_kernels_share_of_device_time": bn_ms / device_ms,
                      "top_device_ms_per_step": {k: v / 2 for k, v in list(kernels.items())[:8]}}
        del model, state
    return out


def train_card_vs_cpu(torch, ckpt, clean, noisy):
    """One fp32 step on the same batch on the card and on the CPU from
    ``ckpt`` resumed as the trainer resumes it (weights, AMSGrad moments,
    counts and learning rate), held to the TRAIN_* tolerances; the same
    step with the network in float64 on the CPU (its losses cast to
    float32, as the JAX package's do), against which each device's
    per-tensor gradient error is reported; and, reported only, the three
    steps again from a fresh optimizer state (the first step's noise
    floor: each device's parameters against the float64 step's)."""
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.train import loop, steps

    tree = params_io.load_npz(ckpt)
    res = {}
    for resume in (True, False):
        for dev, dt in ((DEV, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
            model = params_io.load_generator(ckpt).to(dev, dt)
            opt = steps.make_optimizer(model, 1e-4, 0.75)
            if resume:
                loop.GeneratorWrapper.restore_opt(opt, model, tree["opt"], tree["params"])
            state = steps.TrainState(model, opt)
            step = steps.make_generator_train_step(steps.plain_apply, {"MSSSIM": 1},
                                                   clean.shape[-1])
            m = step(state, clean.to(dev, dt), noisy.to(dev, dt))
            res[resume, dev, dt] = (float(m["weighted"]),
                                    [p.grad.cpu().double() for p in model.parameters()],
                                    [p.detach().cpu().double() for p in model.parameters()],
                                    opt.hyper["learning_rate"])

    def param_diff(a, b):
        return torch.cat([(x - y).abs().flatten() for x, y in zip(a[2], b[2])])

    card, cpu, f64 = (res[True, d, t] for d, t in ((DEV, torch.float32),
                                                   ("cpu", torch.float32),
                                                   ("cpu", torch.float64)))
    (lg, gg, _, lr), (lc, gc, _, _) = card, cpu
    loss_diff = abs(lg - lc)
    flat = torch.cat([g.flatten() for g in gc])
    grad_norm_rel = (torch.cat([g.flatten() for g in gg]) - flat).norm().item() / flat.norm().item()

    def worst(g):
        return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(g, f64[1]))

    dp = param_diff(card, cpu)
    share = (dp > lr / 100).float().mean().item()
    lr0 = res[False, "cpu", torch.float32][3]
    fresh = {f"{a}_vs_{b}": {"param_max_abs_diff": d.max().item(),
                             "param_share_over_lr_1pct": (d > lr0 / 100).float().mean().item()}
             for a, b, d in (("cuda", "cpu", param_diff(res[False, DEV, torch.float32],
                                                        res[False, "cpu", torch.float32])),
                             ("cpu", "float64", param_diff(res[False, "cpu", torch.float32],
                                                           res[False, "cpu", torch.float64])),
                             ("cuda", "float64", param_diff(res[False, DEV, torch.float32],
                                                            res[False, "cpu", torch.float64])))}
    rec = {"shape": list(clean.shape), "resumed_from": os.path.basename(ckpt),
           "checkpoint_epoch": tree.get("epoch"), "lr": lr, "loss_cuda": lg, "loss_cpu": lc,
           "loss_float64": f64[0], "loss_abs_diff": loss_diff,
           "grad_norm": flat.norm().item(), "grad_norm_rel_diff": grad_norm_rel,
           "grad_worst_tensor_rel_err_vs_float64_net": {"cuda": worst(gg), "cpu": worst(gc)},
           "param_max_abs_diff": dp.max().item(), "param_share_over_lr_1pct": share,
           "param_max_abs_diff_vs_float64": {"cuda": param_diff(card, f64).max().item(),
                                             "cpu": param_diff(cpu, f64).max().item()},
           "tolerance": {"loss": TRAIN_LOSS_TOL, "grad_norm_rel": TRAIN_GRAD_TOL,
                         "param_max": lr, "param_share_over_lr_1pct": TRAIN_PARAM_SHARE},
           "fresh_optimizer_first_step_not_held": fresh}
    check(0 < lc < 1 and rec["grad_norm"] > 0, f"train card vs CPU: a degenerate step {rec}")
    check(math.isfinite(lg) and loss_diff <= TRAIN_LOSS_TOL, f"train card vs CPU: loss {rec}")
    check(grad_norm_rel <= TRAIN_GRAD_TOL, f"train card vs CPU: gradients {rec}")
    check(dp.max().item() <= lr and share <= TRAIN_PARAM_SHARE,
          f"train card vs CPU: parameters {rec}")
    return rec


def phase_train(torch, card, tmp, kernel_mods, funit=64, batch=30, cs=184, extra=()):
    """``train.loop`` with ``train_conf_utnet_std.yaml`` (funit 64, batch 30,
    184 px crops, MS-SSIM, beta1 0.75, lr 1e-4) for two epochs on seeded
    synthetic crops, one loader thread; then a resume from its last
    checkpoint for one more epoch; warm step times in fp32 and bf16 from
    that checkpoint on the loader's first batch; and one step resumed from
    that checkpoint on the card against the CPU on two of its crops.
    Training steps run
    level 1 through cuDNN (K2 has no backward); each validation forward
    launches K2 once. Returns the two-epoch run's counts."""
    import json as _json

    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.train import loop

    t0 = time.time()
    root, val = os.path.join(tmp, "train", "SYN_192_184"), os.path.join(tmp, "train", "val.yaml")
    write_train_crops(root, val, scenes=4, crops=16)
    n_items, n_val = 4 * 16, 3
    cfg = os.path.join(ROOT, "nind_denoise_tpu_torch", "configs", "train_conf_utnet_std.yaml")
    argv = ["--config", cfg, "--train_data", root, "--validation_set_yaml", val,
            "--test_reserve", "0", "--threads", "1", "--device", DEV, *extra]
    models = os.path.join(tmp, "train", "models")
    # the K2 input of a validation forward, kept while the run launches it
    rec = record_inputs(E, "enc1", lambda x, *w: (tuple(x.shape), str(x.dtype)))
    try:
        exp, launches = counted(torch, kernel_mods, lambda: cli_run(
            loop, argv + ["--epochs", "3", "--models_dpath", models])[0])
    finally:
        rec["restore"]()
    with open(os.path.join(exp, "trainres.json")) as f:
        res = _json.load(f)
    epochs = {e: res[str(e)] for e in (0, 1, 2)}
    check(all(math.isfinite(v) for r in epochs.values() for v in r.values()),
          f"train: non-finite results {epochs}")
    check("train_weighted_loss" in epochs[2] and "best_epoch" in res, f"train: {res}")
    check(launches["enc1"] == n_val * 3 and sum(launches.values()) == launches["enc1"],
          f"train: launches {launches}, expected enc1 {n_val * 3} (validation only)")
    kept = sorted(f for f in os.listdir(exp) if f.startswith("generator_"))
    check(kept, f"train: no checkpoint in {os.listdir(exp)}")
    ckpt = os.path.join(exp, kept[-1])
    model = params_io.load_generator(ckpt)
    check(model.convs1[0].out_channels == funit, "train: checkpoint width")
    last = params_io.load_npz(ckpt)["epoch"]
    resumed, resume_launches = counted(torch, kernel_mods, lambda: cli_run(
        loop, argv + ["--epochs", str(last + 2), "--g_model_path", ckpt,
                      "--models_dpath", os.path.join(tmp, "train", "resumed")])[0])
    with open(os.path.join(resumed, "trainres.json")) as f:
        res2 = _json.load(f)
    after = res2.get(str(last + 1), {})
    check(math.isfinite(after.get("train_weighted_loss", math.nan)),
          f"train resume: {res2}")
    check(resume_launches["enc1"] == n_val * 2, f"train resume: launches {resume_launches}")
    cli_s = time.time() - t0

    (key, args), = rec["seen"].items()
    with torch.inference_mode():
        k2 = enc1_record(torch, E, args, 10)
    clean, noisy = train_batch(torch, root, batch, cs)
    times = train_step_times(torch, ckpt, clean, noisy)
    cpu = train_card_vs_cpu(torch, ckpt, clean[:2], noisy[:2])
    emit(card, phase="train", config="train_conf_utnet_std.yaml", funit=funit,
         batch=batch, cs=cs, items=n_items, validation_pairs=n_val, epochs=epochs,
         best_epoch=res["best_epoch"], launches=launches, checkpoint=kept[-1],
         resumed_epoch=last + 1, resumed=after, resume_launches=resume_launches,
         cli_s=cli_s, enc1_input=list(key[0]), enc1=k2, step=times, card_vs_cpu=cpu,
         phase_s=time.time() - t0)
    return launches


# The gan phase's card-vs-CPU steps (d_funit 32, batch 2, 184 px), both
# resumed from the cGAN run's checkpoints (weights, BN state, Adam's and
# AMSGrad's moments) with the same injected fuzzy targets. Losses as the
# train phase's; the BN running stats to 1e-4 of max(1, |stat|); the
# parameters of both networks as the train phase's: none apart by more than
# the learning rate, at most 0.1 % by more than 1 % of it. From the run's
# own discriminator checkpoint (an Adam state three steps old): the fp32
# losses and BN stats as above; the same step in float64 on the card
# against float64 on the CPU to GAN_F64_TOL (losses, BN stats relative,
# gradients' norm relative, parameters absolute); and every fp32
# convolution of the card's step, forward, input and weight gradients (the
# backward recomputed by summation, cuDNN off: cuDNN's FFT and Winograd
# backward passes are not sums and may read above the bound, PERF.md §7;
# reported as card_fp32_cudnn_backward),
# under GAN_CONV_BOUND of its rounding bound
# (disc_step_noise.conv_error_over_bound), a bound the same step with TF32
# allowed must break. This step's fp32 gradient is only good to 0.1-2 % on
# either device, and which device lands nearer float64 is a draw (the
# card 0.2-15x the CPU's distance on a batch, with or without cuDNN, with
# its convolutions in float64 too: tools/disc_step_noise.py), so the
# card's whole fp32 step is reported against float64 and the CPU's, not
# held to them.
GAN_LOSS_TOL, GAN_BN_TOL, GAN_F64_TOL, GAN_CONV_BOUND = 1e-5, 1e-4, 1e-9, 1.0
# discriminator steps on the card before the held one (gan_card_vs_cpu)
GAN_DISC_STEPS = 200
GAN_WEIGHTS = {"MSSSIM": 1.0, "D1": 0.2}  # train_conf_utnet_std.yaml + --weight_D1 0.2
GAN_RUN_PAIRS = 3  # batches of 2 stepped from the run's discriminator checkpoint
RATE_CROPS = 320  # the device cache's rate: ten batches of 30 an epoch


def batch_lines(exp):
    """The per-batch lines of a training run's ``train.log``."""
    with open(os.path.join(exp, "train.log")) as f:
        return [ln for ln in f.read().splitlines() if re.match(r"Epoch \d+ batch \d+/", ln)]


def highest(dpath, keyword):
    """The highest-epoch ``<keyword>_<epoch>.npz`` in ``dpath``."""
    eps = [int(m.group(1)) for f in os.listdir(dpath)
           for m in [re.match(rf"{keyword}_(\d+)\.npz$", f)] if m]
    check(eps, f"no {keyword} checkpoint in {os.listdir(dpath)}")
    return os.path.join(dpath, f"{keyword}_{max(eps)}.npz")


def disc_wrapper(ckpt, d_funit, device, network="Hul112Disc"):
    """The run's discriminator resumed from ``ckpt`` as the trainer does."""
    import types

    from nind_denoise_tpu_torch.train import gan

    return gan.DiscriminatorWrapper(types.SimpleNamespace(beta1=0.75, models_dpath=None),
                                    network, d_funit, 1e-4, True, seed=1,
                                    model_path=ckpt, device=device)


@contextlib.contextmanager
def cached_npz():
    """Within: ``params_io.load_npz`` reads each checkpoint file once (the
    step checks resume the same files tens of times; the generator's, with
    its optimizer moments, is ~500 MB at funit 64). The trees are only
    read."""
    from nind_denoise_tpu_torch.models import params_io

    keep, seen = params_io.load_npz, {}

    def load(fpath):
        key = (os.path.abspath(fpath), os.path.getmtime(fpath))
        if key not in seen:
            seen[key] = keep(fpath)
        return seen[key]

    params_io.load_npz = load
    try:
        yield
    finally:
        params_io.load_npz = keep


def resumed_generator(torch, ckpt, device, dtype=None):
    """UtNet and its AMSGrad from ``ckpt``, resumed as the trainer resumes."""
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.train import loop, steps

    tree = params_io.load_npz(ckpt)
    model = params_io.load_generator(ckpt).to(device, dtype or torch.float32)
    opt = steps.make_optimizer(model, 1e-4, 0.75)
    loop.GeneratorWrapper.restore_opt(opt, model, tree["opt"], tree["params"])
    return steps.TrainState(model, opt)


def infer_fn(torch, apply, model):
    """``GeneratorWrapper.infer``: the forward without autograd or TF32."""
    from nind_denoise_tpu_torch.engine.tile_engine import _tf32

    def infer(x):
        with torch.no_grad(), _tf32(False):
            return apply(model, x)
    return infer


def gan_step_times(torch, gck, dck, clean, noisy, d_funit, reps=5, network="Hul112Disc"):
    """Warm cGAN times from the run's checkpoints on one batch, fp32 (TF32
    off) and bf16 (the generator; the discriminator stays fp32): the
    discriminator step, the generator step with the D1 term, ``learn``'s
    generator forward, and a batch in which both networks learn; peak
    memory; the FLOP count of each (``torch.utils.flop_counter``, K2's
    level 1 added by its formula) and the bound it gives; the top device
    kernels of one batch."""
    import types

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from nind_denoise_tpu_torch.train import steps

    clean, noisy = clean.to(DEV), noisy.to(DEV)
    b, _, h, w = noisy.shape
    k2_flops = 2.0 * b * h * w * 64 * 576 + 2.0 * b * (h + 2) * (w + 2) * 64 * 27
    out = {}
    for dtype, apply in (("float32", steps.plain_apply), ("bfloat16", steps.bf16_apply)):
        state = resumed_generator(torch, gck, DEV)
        disc = disc_wrapper(dck, d_funit, DEV, network)
        infer = infer_fn(torch, apply, state.model)
        gen = types.SimpleNamespace(infer=infer)
        g = torch.Generator(DEV).manual_seed(0)
        gstep = steps.make_generator_train_step(apply, GAN_WEIGHTS, w,
                                                disc_fns=(disc.pred_fn, None))
        gstep_alone = steps.make_generator_train_step(apply, {"MSSSIM": 1.0}, w)
        fake = torch.clamp(infer(noisy), 0, 1)

        def dstep():
            return disc._step(clean, fake, noisy, False, generator=g)

        def both():
            disc.learn(clean, noisy, gen, w, generator=g)
            return gstep(state, clean, noisy)

        ms = {"disc_step": time_ms(torch, dstep, reps),
              "gen_step_with_d1": time_ms(torch, lambda: gstep(state, clean, noisy), reps),
              "learn_generator_forward": time_ms(torch, lambda: infer(noisy), reps)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms["batch_both_learn"] = time_ms(torch, both, reps)
        peak = torch.cuda.max_memory_allocated()

        def flops(fn):
            with FlopCounterMode(display=False) as fc:
                fn()
            return fc.get_total_flops()

        f = {"disc_step": flops(dstep), "gen_step_with_d1": flops(lambda: gstep(state, clean, noisy)),
             "gen_step_alone": flops(lambda: gstep_alone(state, clean, noisy)),
             "learn_generator_forward": flops(lambda: infer(noisy)) + k2_flops}
        f["batch_both_learn"] = f["disc_step"] + f["gen_step_with_d1"] + f["learn_generator_forward"]
        gen_part = f["gen_step_alone"] + f["learn_generator_forward"]
        fp32_part = f["batch_both_learn"] - gen_part
        peak_g = PEAK_FLOPS[dtype] * 1e-3
        bound = gen_part / peak_g + fp32_part / (PEAK_FLOPS["float32"] * 1e-3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            both()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.self_device_time_total
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[dtype] = {"ms": ms, "peak_memory_allocated_gib": peak / 2 ** 30,
                      "tflop": {k: v / 1e12 for k, v in f.items()},
                      "batch_bound_ms": bound, "batch_ms_over_bound": ms["batch_both_learn"] / bound,
                      "batch_device_ms": sum(by_name.values()) / 1e3,
                      "top_device_ms": {k: v / 1e3 for k, v in top},
                      "d_loss": disc.loss}
        check(math.isfinite(disc.loss) and 0 < disc.loss < 2, f"gan step times {dtype}: {disc.loss}")
        del state, disc
    return out


def disc_step_on(torch, dck, d_funit, dev, batch, draws, dtype=None, cudnn=True, tf32=False,
                 bound=None, network="Hul112Disc", cudnn_bound=None):
    """One discriminator step from ``dck`` on ``dev`` (fake targets noisy),
    in float32 or ``dtype`` (the network and its Adam moments converted),
    with cuDNN or without it, with TF32 planted (``tf32``), its convolutions
    held to their rounding bound into the dicts ``bound`` and
    ``cudnn_bound`` (``disc_step_noise.bounding_convs``): (loss_real,
    loss_fake, ranges, its state_dict, the step's gradients), tensors in
    float64 on the CPU."""
    import contextlib

    from nind_denoise_tpu_torch.tools.disc_step_noise import (bounding_convs, copy_as,
                                                              planted_tf32)

    dtype = dtype or torch.float32
    disc = disc_wrapper(dck, d_funit, dev, network)
    if dtype != torch.float32:
        disc = copy_as(disc, dtype)
    grads, opt_step = [], disc.optimizer.step

    def spy():  # the summed gradients, which the step frees after the update
        grads.extend(p.grad.detach().cpu().double() if p.grad is not None
                     else torch.zeros(p.shape, dtype=torch.float64)  # a head not run
                     for p in disc.optimizer.params)
        return opt_step()

    disc.optimizer.step = spy
    c, n, f = (t.to(dev, dtype) for t in batch)
    off = contextlib.nullcontext() if cudnn else torch.backends.cudnn.flags(enabled=False)
    with off, planted_tf32(tf32), bounding_convs(bound, cudnn_bound):
        lr_, lf_, ranges = disc._step(c, f, n, True, draws=tuple(d.to(dev, dtype) for d in draws))
    return (float(lr_), float(lf_), ranges.tolist(),
            {k: v.detach().cpu().double() for k, v in disc.model.state_dict().items()}, grads)


def param_spread(a, b, lr):
    """(max |a - b|, share of elements more than 1 % of ``lr`` apart) of
    two lists of tensors."""
    import torch

    d = torch.cat([(x - y).abs().flatten() for x, y in zip(a, b)])
    return d.max().item(), (d > lr / 100).float().mean().item()


def step_vs(a, b, lr=1e-4, cancelled=None):
    """How far the discriminator steps ``a`` lie from the steps ``b`` (two
    lists of what ``disc_step_on`` returns, paired), pooled over the pairs:
    the losses; the BN running stats relative to max(1, |stat|); the
    gradients, their norm's relative difference and the worst tensor's
    (max |a - b| / max |b|); the parameters, the largest difference and the
    share more than 1 % of ``lr`` apart, leaving out the elements that
    ``cancelled`` marks by parameter name (a gradient 0 in exact
    arithmetic, whose fp32 rounding noise Adam turns into steps of up to
    about ``lr``), whose largest difference is reported apart."""
    import torch

    cancelled = cancelled or {}
    keys = [k for k in b[0][3] if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))]
    bn = max(((x[3][k] - y[3][k]).abs() / y[3][k].abs().clamp_min(1)).max().item()
             for x, y in zip(a, b) for k in y[3] if k.endswith(("running_mean", "running_var")))

    def live(x, k):
        return x[3][k][~cancelled[k]] if k in cancelled else x[3][k]

    p_max, p_share = param_spread([live(x, k) for x in a for k in keys],
                                  [live(y, k) for y in b for k in keys], lr)
    ga = torch.cat([g.flatten() for x in a for g in x[4]])
    gb = torch.cat([g.flatten() for y in b for g in y[4]])
    worst = max(((u - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                for x, y in zip(a, b) for u, v in zip(x[4], y[4]))
    loss = max(abs(x[i] - y[i]) for x, y in zip(a, b) for i in (0, 1))
    out = {"loss_abs_diff": loss, "bn_stat_rel_diff": bn,
           "grad_norm_rel_diff": ((ga - gb).norm() / gb.norm()).item(),
           "grad_worst_tensor_rel_diff": worst, "param_max_abs_diff": p_max,
           "param_max_over_lr": p_max / lr, "param_share_over_lr_1pct": p_share}
    if cancelled:
        out["cancelled_param_max_over_lr_not_held"] = max(
            (x[3][k] - y[3][k])[m].abs().max().item() for x, y in zip(a, b)
            for k, m in cancelled.items()) / lr
    return out


def device_kernels(torch, fn, top=10):
    """``fn()`` under the profiler: its device kernels by name, ms, the
    ``top`` largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name[:96]] = by_name.get(e.name[:96], 0.0) + e.self_device_time_total / 1e3
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def gan_card_vs_cpu(torch, tmp, gck, dck, clean, noisy, d_funit, steps_before=GAN_DISC_STEPS,
                    network="Hul112Disc", sub="gan", n_pairs=GAN_RUN_PAIRS, age_cudnn=True):
    """One discriminator step and one generator step with the D1 term on
    the card and on the CPU at batch 2, on the same crops, generated crops
    and fuzzy targets (fake targets noisy), held to the GAN_* tolerances;
    the discriminator bit-unchanged by the generator step on each device.
    The generator resumes the run's checkpoint. The held discriminator step
    resumes the run's checkpoint trained ``steps_before`` more steps on the
    card (batch 2 from the 30 crops, seeded targets): a young Adam state
    moves an element whose gradient is rounding noise by up to the learning
    rate, so the step's parameters from the run's own checkpoint (three
    steps old) measure each device's fp32 gradient error more than the
    port. From that checkpoint the step is run six ways, the card and the
    CPU in fp32, the card in fp32 without cuDNN and with TF32 planted, and
    both in float64: the float64 steps are held card against CPU (a fault
    of the port shows in float64 too); the card's fp32 convolutions to
    their rounding bound, which the TF32 step's must break (the backward
    passes recomputed by summation; cuDNN's own recompute, FFT and Winograd
    transforms for some critics, is reported, not held). Every fp32 step
    is reported against the float64 one, with the kernels the card's fp32
    step ran. The fp32 steps' parameters are held apart from the elements
    whose float64 gradient is 0 (the biases a BatchNorm cancels, in the
    pix2pix critics: ``step_vs``'s ``cancelled``). ``network``: the run's
    discriminator; ``sub``: the directory under ``tmp`` for the trained
    checkpoint; ``n_pairs``: the batches of 2 stepped from it;
    ``age_cudnn``: False trains that checkpoint with cuDNN off (what counts
    there is its Adam state's age, and cuDNN's heuristics give some critics
    slow FFT convolutions; the held steps keep cuDNN)."""
    from nind_denoise_tpu_torch.train import steps

    secs, t0 = {}, time.time()
    gen = infer_fn(torch, steps.plain_apply, resumed_generator(torch, gck, DEV).model)
    fake = torch.cat([torch.clamp(gen(noisy[i:i + 2].to(DEV)), 0, 1).cpu()
                      for i in range(0, noisy.shape[0] - 1, 2)])
    disc = disc_wrapper(dck, d_funit, DEV, network)
    age = disc.optimizer.count
    g = torch.Generator(DEV).manual_seed(7)
    with contextlib.nullcontext() if age_cudnn else torch.backends.cudnn.flags(enabled=False):
        for k in range(steps_before):
            i = 2 * (k % (noisy.shape[0] // 2))
            disc._step(*(t[i:i + 2].to(DEV) for t in (clean, fake, noisy)), disc.loss < 0.25,
                       generator=g)
    trained = os.path.join(tmp, sub, "held")
    disc.save_model(trained, steps_before, "discriminator")
    tck = os.path.join(trained, f"discriminator_{steps_before}.npz")
    secs["train_on_card"], t0 = time.time() - t0, time.time()
    # ``n_pairs`` batches of 2, each with its own targets; the held step
    # takes the first
    pairs = [tuple(t[i:i + 2] for t in (clean, noisy, fake))
             for i in range(0, 2 * n_pairs, 2)]
    batch = pairs[0]
    shape = disc_wrapper(dck, d_funit, "cpu", network).model(torch.cat([noisy[:2], fake[:2]], 1),
                                                     frozen=True).shape
    gu = torch.Generator().manual_seed(5)
    draws = [(torch.rand(shape, generator=gu), torch.rand(shape, generator=gu)) for _ in pairs]
    held = {dev: disc_step_on(torch, tck, d_funit, dev, batch, draws[0], network=network)
            for dev in (DEV, "cpu")}
    secs["held"], t0 = time.time() - t0, time.time()
    f64 = torch.float64
    ways = {"card_fp32": (DEV, None, True, False), "cpu_fp32": ("cpu", None, True, False),
            "card_fp32_without_cudnn": (DEV, None, False, False),
            "card_fp32_tf32_planted": (DEV, None, True, True),
            "card_float64": (DEV, f64, True, False), "cpu_float64": ("cpu", f64, True, False)}
    bound = {"card_fp32": {}, "card_fp32_tf32_planted": {}, "card_fp32_cudnn_backward": {}}
    run = {}
    for name, (dev, dt, cudnn, tf32) in ways.items():
        run[name] = [disc_step_on(torch, dck, d_funit, dev, b, u, dt, cudnn, tf32,
                                  bound.get(name), network, bound.get(name + "_cudnn_backward"))
                     for b, u in zip(pairs, draws)]
        secs[name], t0 = time.time() - t0, time.time()
    kernels = device_kernels(torch, lambda: disc_step_on(torch, dck, d_funit, DEV, batch,
                                                         draws[0], network=network))

    res = {}
    secs["kernels"], t0 = time.time() - t0, time.time()
    for dev in (DEV, "cpu"):
        c, n = clean[:2].to(dev), noisy[:2].to(dev)
        fool = disc_wrapper(tck, d_funit, dev, network)
        before = {k: v.clone() for k, v in fool.model.state_dict().items()}
        state = resumed_generator(torch, gck, dev)
        m = steps.make_generator_train_step(steps.plain_apply, GAN_WEIGHTS, c.shape[-1],
                                            disc_fns=(fool.pred_fn, None))(state, c, n)
        untouched = all(torch.equal(v, before[k]) for k, v in fool.model.state_dict().items()) \
            and all(p.grad is None for p in fool.model.parameters())
        check(untouched, f"gan card vs CPU: the generator step changed the discriminator on {dev}")
        res[dev] = ({k: float(v) for k, v in m.items()},
                    [p.detach().cpu().double() for p in state.model.parameters()],
                    state.opt.hyper["learning_rate"])
        secs[f"generator_step_{dev}"], t0 = time.time() - t0, time.time()

    (dr_c, df_c, rg_c, _, _), (dr_h, df_h, rg_h, _, _) = held[DEV], held["cpu"]
    ref = run["cpu_float64"]
    names = [k for k in ref[0][3] if not k.endswith(("running_mean", "running_var",
                                                     "num_batches_tracked"))]
    top = max(g.abs().max().item() for g in ref[0][4])
    cancelled = {k: g.abs() <= 1e-9 * top for k, g in zip(names, ref[0][4])}
    cancelled = {k: m for k, m in cancelled.items() if m.any()}
    d = step_vs([held[DEV]], [held["cpu"]], cancelled=cancelled)
    own = {"adam_steps_before": age, "batches_of_2": n_pairs,
           "cancelled_elements": {k: int(m.sum()) for k, m in cancelled.items()},
           "card_vs_cpu_fp32": step_vs(run["card_fp32"], run["cpu_fp32"], cancelled=cancelled),
           "card_vs_cpu_float64": step_vs(run["card_float64"], ref),
           "vs_cpu_float64": {name: step_vs(run[name], ref, cancelled=cancelled) for name in (
               "card_fp32", "cpu_fp32", "card_fp32_without_cudnn", "card_fp32_tf32_planted")},
           "conv_error_over_bound": bound,
           "losses_float64": [r[:2] for r in ref],
           "cudnn_version": torch.backends.cudnn.version(),
           "card_fp32_step_kernels_ms": kernels}
    (mg_c, pg_c, glr), (mg_h, pg_h, _) = res[DEV], res["cpu"]
    g_max, g_share = param_spread(pg_c, pg_h, glr)
    rec = {"network": network, "shape": list(clean[:2].shape), "pred_shape": list(shape),
           "disc_resumed_from": f"{os.path.basename(dck)} + {steps_before} steps on the card"
                                    + ("" if age_cudnn else " (cuDNN off)"),
           "disc": {"loss_real": [dr_c, dr_h], "loss_fake": [df_c, df_h],
                    "ranges_cuda": rg_c, "ranges_cpu": rg_h, **d, "lr": 1e-4},
           "gen": {"metrics_cuda": mg_c, "metrics_cpu": mg_h, "param_max_abs_diff": g_max,
                   "param_share_over_lr_1pct": g_share, "lr": glr},
           "disc_from_the_run_checkpoint": own, "seconds": secs,
           "tolerance": {"loss": GAN_LOSS_TOL, "bn_stat_rel": GAN_BN_TOL, "param_max": "lr",
                         "param_share_over_lr_1pct": TRAIN_PARAM_SHARE,
                         "run_checkpoint_conv_error_over_bound": GAN_CONV_BOUND,
                         "run_checkpoint_float64": GAN_F64_TOL}}
    check(d["loss_abs_diff"] <= GAN_LOSS_TOL, f"gan card vs CPU: discriminator losses {rec}")
    check(d["bn_stat_rel_diff"] <= GAN_BN_TOL, f"gan card vs CPU: BN running stats {rec}")
    check(d["param_max_abs_diff"] <= 1e-4 and d["param_share_over_lr_1pct"] <= TRAIN_PARAM_SHARE,
          f"gan card vs CPU: discriminator {rec}")
    o32, o64 = own["card_vs_cpu_fp32"], own["card_vs_cpu_float64"]
    check(o32["loss_abs_diff"] <= GAN_LOSS_TOL and o32["bn_stat_rel_diff"] <= GAN_BN_TOL,
          f"gan card vs CPU: the run checkpoint's fp32 step {rec}")
    passes = {"forward", "input_grad", "weight_grad"}
    check(set(bound["card_fp32"]) == passes and max(bound["card_fp32"].values()) < GAN_CONV_BOUND,
          f"gan card vs CPU: the run checkpoint's fp32 convolutions on the card {rec}")
    check(max(bound["card_fp32_tf32_planted"].values()) > GAN_CONV_BOUND,
          f"gan card vs CPU: the rounding bound does not see planted TF32 {rec}")
    check(all(o64[k] <= GAN_F64_TOL for k in ("loss_abs_diff", "bn_stat_rel_diff",
                                              "grad_norm_rel_diff", "param_max_abs_diff")),
          f"gan card vs CPU: the run checkpoint's float64 step {rec}")
    check(all(abs(mg_c[k] - mg_h[k]) <= GAN_LOSS_TOL for k in mg_h) and set(mg_c) == set(mg_h)
          and "D1" in mg_h, f"gan card vs CPU: generator losses {rec}")
    check(g_max <= glr and g_share <= TRAIN_PARAM_SHARE, f"gan card vs CPU: generator {rec}")
    return rec


def device_cache_run(torch, tmp, argv, kernel_mods, n_val, batch, cs, funit):
    """``--device_cache 64``, two epochs, generator only: the cache's bytes,
    its swaps and the run's launches; then, on that run's cache, the
    sampler's time per batch and the H2D copies of an epoch of train steps
    under the profiler; then fp32 steps per second on RATE_CROPS crops
    drawn from a cache against the host loader."""
    from torch.profiler import ProfilerActivity, profile

    from nind_denoise_tpu_torch.train import dataset as ds_mod
    from nind_denoise_tpu_torch.train import device_cache as dc_mod
    from nind_denoise_tpu_torch.train import loop, steps

    cls = dc_mod.DeviceEpochCache
    caches, swaps = [], []
    init, swap = cls.__init__, cls.maybe_swap

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        caches.append(self)

    def spy_swap(self):
        swaps.append(swap(self))
        return swaps[-1]

    cls.__init__, cls.maybe_swap = spy_init, spy_swap
    try:
        exp, launches = counted(torch, kernel_mods, lambda: cli_run(loop, argv)[0])
    finally:
        cls.__init__, cls.maybe_swap = init, swap
    (cache,) = caches
    with open(os.path.join(exp, "trainres.json")) as f:
        res = json.load(f)
    nbytes = 2 * cache.n * cs * cs * 3 * 2
    check(cache.nbytes() == nbytes and cache.cache_x.dtype == torch.float16
          and cache.cache_x.device.type == torch.device(DEV).type,
          f"device cache: {cache.nbytes()} bytes, expected {nbytes}")
    check(any(swaps), f"device cache: no swap at {len(swaps)} epoch boundaries")
    check(all(math.isfinite(v) for r in res.values() if isinstance(r, dict)
              for v in r.values() if isinstance(v, float)) and "train_weighted_loss" in res["2"],
          f"device cache: {res}")
    check(launches["enc1"] == n_val * 3 and sum(launches.values()) == launches["enc1"],
          f"device cache: launches {launches}")

    g = torch.Generator(DEV).manual_seed(1)
    idxs = torch.arange(batch, device=DEV)
    sampler_ms = time_ms(torch, lambda: cache.batch(idxs, g), 20)
    model = loop.init_model(funit, "PReLU", 0).to(DEV)
    state = steps.TrainState(model, steps.make_optimizer(model, 1e-4, 0.75))
    step = steps.make_generator_train_step(steps.plain_apply, {"MSSSIM": 1.0}, cs)
    for c, n in cache.epoch_batches(batch, g):  # warm
        step(state, c, n)
    torch.cuda.synchronize()
    # Every copy is a runtime call on the host side of the trace, and the
    # host side keeps them all; the device side can lose records (pageable
    # HtoD ones, seen on the H100 after earlier profiles in the process).
    # So a call without a device record may have been an upload, unless it
    # reads a scalar to the host (under aten::_local_scalar_dense).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(64).to(DEV)  # a probe: the trace must show this copy
        torch.cuda.synchronize()
        for c, n in cache.epoch_batches(batch, g):
            step(state, c, n)
        torch.cuda.synchronize()
    calls, records = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" in e.name:
            records.append(e.name)
        elif e.name.startswith("cudaMemcpy"):
            chain, q = [], e.cpu_parent
            while q is not None and len(chain) < 4:
                chain.append(q.name)
                q = q.cpu_parent
            calls.append(" <- ".join(chain))
    h2d = [r for r in records if "HtoD" in r]
    reads = sum("aten::_local_scalar_dense" in c for c in calls)
    unrecorded = (len(calls) - reads) - sum("DtoH" not in r for r in records)
    uploads = len(h2d) + max(0, unrecorded)
    check(len(calls) >= 2 and uploads <= 2,
          f"device cache: an epoch's steps copied to the device beyond the probe and the "
          f"permutation (at most {uploads} uploads): calls {calls}, records {records}")

    # Steps per second from a cache of RATE_CROPS crops (ten batches an
    # epoch) against the host loader on the same crops, one thread as the
    # run above and the trainer's default six, two epochs each after one
    # to warm; every epoch restarts the loader's threads.
    big = os.path.join(tmp, "gan", "rate", "SYN_192_184")
    write_train_crops(big, os.path.join(os.path.dirname(big), "val.yaml"), scenes=4,
                      crops=RATE_CROPS // 4, seed=1)
    ds = ds_mod.DenoisingDataset([big], cs=cs, min_crop_size=cache.dataset.min_crop_size,
                                 exp_mult_min=cache.exp_mult_min,
                                 exp_mult_max=cache.exp_mult_max, seed=0)
    t0 = time.time()
    rate_cache = dc_mod.DeviceEpochCache(ds, RATE_CROPS, device=DEV, seed=0, threads=4)
    fill_s = time.time() - t0

    def rate(batches):
        for c, n in batches():  # warm
            step(state, c, n)
        torch.cuda.synchronize()
        t0, k = time.time(), 0
        for _ in range(2):
            for c, n in batches():
                step(state, c, n)
                k += 1
        torch.cuda.synchronize()
        return k / (time.time() - t0), k // 2

    def host(threads):
        loader = ds_mod.Loader(ds, batch, num_threads=threads, seed=0)
        return lambda: ((loop.to_device(c, DEV), loop.to_device(n, DEV)) for c, n in loader)

    rates = {"cache": rate(lambda: rate_cache.epoch_batches(batch, g)),
             "host_loader_1_thread": rate(host(1)), "host_loader_6_threads": rate(host(6))}
    check(all(k >= 10 for _, k in rates.values()), f"device cache: short epochs {rates}")
    return {"n": cache.n, "cache_bytes": cache.nbytes(), "swaps": swaps,
            "uploaded_rows": cache.uploaded_rows, "launches": launches,
            "epochs": {e: res[e] for e in ("1", "2")}, "sampler_ms_per_batch": sampler_ms,
            "h2d_records_probe_and_epoch": h2d, "uploads_at_most": uploads,
            "copy_calls": dict(collections.Counter(calls)), "copy_records": records,
            "rate_crops": RATE_CROPS, "rate_cache_fill_s": fill_s,
            "rate_batches_per_epoch": rates["cache"][1],
            "steps_per_s": {k: v for k, (v, _) in rates.items()}}, launches


def phase_gan(torch, card, tmp, kernel_mods, funit=64, batch=30, cs=184, d_funit=32, extra=()):
    """The cGAN: ``train.loop`` with ``train_conf_utnet_std.yaml`` and
    ``--weight_D1 0.2 --d_lr 1e-4`` (Hul112Disc, d_funit 32, conditional)
    for two epochs on the train phase's seeded crops, one loader thread:
    finite losses, discriminator checkpoints, K2 launched once per
    discriminator learn (its generator forward) and once per validation
    pair and validation; a resume from both checkpoints for one more epoch
    carrying Adam's count and the plateau scheduler; K2 at the learn
    forward's input against its plain version in fp32 (bit-equal) and
    bf16; warm step times in fp32 and bf16; one discriminator step and one
    generator step on the card against the CPU; then a two-epoch
    ``--device_cache 64`` run. Returns the launch counts by run."""
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.train import gan, loop

    t0 = time.time()
    root, val = os.path.join(tmp, "train", "SYN_192_184"), os.path.join(tmp, "train", "val.yaml")
    if not os.path.isdir(root):
        write_train_crops(root, val, scenes=4, crops=16)
    n_val = 3
    cfg = os.path.join(ROOT, "nind_denoise_tpu_torch", "configs", "train_conf_utnet_std.yaml")
    argv = ["--config", cfg, "--train_data", root, "--validation_set_yaml", val,
            "--test_reserve", "0", "--threads", "1", "--device", DEV, *extra]
    gan_argv = argv + ["--weight_D1", "0.2", "--d_lr", "1e-4", "--d_funit", str(d_funit)]
    rec = record_inputs(E, "enc1", lambda x, *w: (tuple(x.shape), str(x.dtype)))
    try:
        exp, launches = counted(torch, kernel_mods, lambda: cli_run(
            loop, gan_argv + ["--epochs", "3", "--models_dpath", os.path.join(tmp, "gan", "a")])[0])
    finally:
        rec["restore"]()
    lines = batch_lines(exp)
    learns = sum("loss D1: " in ln for ln in lines)
    g_steps = sum("loss G: " in ln for ln in lines)
    d_losses = [float(v) for ln in lines for v in re.findall(r"loss D1: (\S+) \(", ln)]
    g_losses = [float(v) for ln in lines for v in re.findall(r"weighted: (\S+)", ln)]
    check(learns > 0 and g_steps > 0 and len(g_losses) == g_steps
          and all(math.isfinite(v) for v in d_losses + g_losses),
          f"gan: losses {lines}")
    check(launches["enc1"] == learns + n_val * 3 and sum(launches.values()) == launches["enc1"],
          f"gan: launches {launches}, expected enc1 {learns} learns + {n_val * 3}")
    gck, dck = highest(exp, "generator"), highest(exp, "discriminator")
    dtree = params_io.load_npz(dck)
    last = params_io.load_npz(gck)["epoch"]

    resumed, resume_launches = counted(torch, kernel_mods, lambda: cli_run(
        loop, gan_argv + ["--epochs", str(last + 2), "--g_model_path", gck, "--d_model_path", dck,
                          "--models_dpath", os.path.join(tmp, "gan", "b")])[0])
    r_lines = batch_lines(resumed)
    r_learns = sum("loss D1: " in ln for ln in r_lines)
    d_new = params_io.load_npz(os.path.join(resumed, f"discriminator_{last + 1}.npz"))
    with open(os.path.join(resumed, "train.log")) as f:
        avg = float(re.search(r"Discriminator1 average normalized loss: (\S+)", f.read()).group(1))
    sched = gan.ReduceLROnPlateau(dtree["sched"]["lr"], 0.75, patience=3)
    sched.best, sched.num_bad = dtree["sched"]["best"], dtree["sched"]["num_bad"]
    sched.step(avg)
    check(int(d_new["opt"][0]) == int(dtree["opt"][0]) + r_learns
          and (d_new["sched"]["lr"], d_new["sched"]["best"], d_new["sched"]["num_bad"])
          == (sched.lr, sched.best, sched.num_bad),
          f"gan resume: Adam count {d_new['opt'][0]} after {dtree['opt'][0]} + {r_learns}, "
          f"scheduler {d_new['sched']} from {dtree['sched']} and {avg}")
    check(resume_launches["enc1"] == r_learns + n_val * 2, f"gan resume: {resume_launches}")
    cli_s = time.time() - t0

    # K2 at the learn forward's input, fp32 as the run gave it, and in bf16
    (args,) = [a for (shape, _), a in rec["seen"].items() if shape[0] == batch]
    with torch.inference_mode():
        k2 = enc1_record(torch, E, args, 10)
        check(k2["max_abs_err"] == 0, f"gan: K2 fp32 at {list(args[0].shape)} not bit-equal: {k2}")
        k2_bf16 = enc1_record(torch, E, [a.to(torch.bfloat16) for a in args], 10)
    clean, noisy = train_batch(torch, root, batch, cs)
    with cached_npz():
        times = gan_step_times(torch, gck, dck, clean, noisy, d_funit)
        cpu = gan_card_vs_cpu(torch, tmp, gck, dck, clean, noisy, d_funit)
    emit(card, phase="gan", config="train_conf_utnet_std.yaml + --weight_D1 0.2 --d_lr 1e-4",
         d_network="Hul112Disc", d_funit=d_funit, batch=batch, cs=cs, validation_pairs=n_val,
         batches=len(lines), d_learns=learns, g_steps=g_steps, d_losses=d_losses,
         g_losses=g_losses, launches=launches, checkpoints=[os.path.basename(gck),
                                                            os.path.basename(dck)],
         resumed_epoch=last + 1, resumed_d_learns=r_learns, resume_launches=resume_launches,
         resumed_sched=d_new["sched"], cli_s=cli_s, enc1_input=list(args[0].shape),
         enc1_fp32=k2, enc1_bf16=k2_bf16, step=times, card_vs_cpu=cpu,
         phase_s=time.time() - t0)

    t1 = time.time()
    cache_rec, cache_launches = device_cache_run(
        torch, tmp, argv + ["--epochs", "3", "--device_cache", "64",
                       "--models_dpath", os.path.join(tmp, "gan", "cache")],
        kernel_mods, n_val, batch, cs, funit)
    emit(card, phase="gan_device_cache", **cache_rec, phase_s=time.time() - t1)
    return launches, cache_launches


# -- both ends of the research loop: the dataset tools and evaluation ------------

# NIND-shaped scenes of the dataset_tools and eval phases: two sets, an ISO100
# baseline and three noisy ISOs each, at the CLIs' 6 MP (HW); and NIND's larger
# scenes, 24 MP, for one whole-image score
SCENE_ISOS = (("ISO100", 0.0), ("ISO800", 0.02), ("ISO3200", 0.05), ("ISO6400", 0.08))
BIG_HW = (4000, 6000)
SCORE_TOL = 1e-6  # a score on the card against the CPU's on the same files


def write_scenes(root, hw, seed=17, sets=("SA", "SB"), isos=SCENE_ISOS, ext=".png"):
    """Seeded 16-bit scenes in NIND's layout, ``<root>/<set>/NIND_<set>_<iso><ext>``:
    a smooth clean image, and Gaussian noise that grows with the ISO."""
    import concurrent.futures as cf

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    jobs = []
    for aset in sets:
        os.makedirs(os.path.join(root, aset))
        low = rng.random((hw[0] // 16, hw[1] // 16, 3), np.float32)
        clean = cv2.resize(low, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
        for iso, sigma in isos:
            noisy = clean + sigma * rng.standard_normal(clean.shape, np.float32)
            jobs.append((os.path.join(root, aset, f"NIND_{aset}_{iso}{ext}"),
                         (np.clip(noisy, 0, 1) * 65535).astype(np.uint16)))
    params = [cv2.IMWRITE_TIFF_COMPRESSION, 1] if ext == ".tif" else []
    with cf.ThreadPoolExecutor(8) as pool:
        ok = list(pool.map(lambda job: cv2.imwrite(*job, params), jobs))
    check(all(ok), f"could not write the scenes under {root}")
    return [path for path, _ in jobs]


def timed_calls(torch, mod, name, log, events=False):
    """Wrap ``mod.<name>`` to append each call's host seconds (and, with
    ``events``, its CUDA-event milliseconds) to ``log``; returns the undo."""
    fn = getattr(mod, name)

    def spy(*args, **kw):
        start = end = None
        if events:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if events:
            end.record()
            end.synchronize()
        log.append((time.perf_counter() - t0, start, end))
        return out

    setattr(mod, name, spy)
    return lambda: setattr(mod, name, fn)


def span_ms(entry):
    _, start, end = entry
    return start.elapsed_time(end)


def device_work(torch, fn, calls=1):
    """``fn()`` ``calls`` times under the profiler: the device time of its
    kernels and copies (ms) and their count, each per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sum(e.self_device_time_total for e in work) / 1e3 / calls, len(work) / calls


def phase_dataset_tools(torch, card, tmp, kernel_mods, scenes, hw, n_check=16):
    """The seeded scenes under ``scenes`` (``write_scenes``' tree, which
    phase_fetch downloads there), crop_ds at cs 256 / stride 192 on them,
    the MS-SSIM audit of
    every crop pair on the card (``make_dataset_crops_list``) with 16 of its
    scores against the CPU's on the same files, the CSV through
    ``PickyDenoisingDatasetFromList``, and ``pick_validation_set`` from a
    test reserve of one set. Returns the audit's launch counts."""
    import numpy as np
    import yaml

    from nind_denoise_tpu_torch.core import imgio
    from nind_denoise_tpu_torch.eval import score
    from nind_denoise_tpu_torch.tools import crop_ds, make_dataset_crops_list, \
        pick_validation_set
    from nind_denoise_tpu_torch.train.dataset import PickyDenoisingDatasetFromList

    t_phase = time.time()
    n_sets, n_isos = len(os.listdir(scenes)), len(SCENE_ISOS)
    n_images = n_sets * n_isos
    grid = len(crop_ds.crop_grid(hw[1], hw[0], 256, 192))
    res, lists = os.path.join(tmp, "cropped"), os.path.join(tmp, "lists")
    t0 = time.time()
    n_crops, _ = captured(crop_ds.main, ["--cs", "256", "--stride", "192",
                                         "--orig_data", scenes, "--resdir", res])
    crop_s = time.time() - t0
    check(n_crops == n_images * grid, f"crop_ds wrote {n_crops} crops, expected "
                                      f"{n_images} x {grid}")
    root = os.path.join(res, os.path.basename(scenes) + "_256_192")

    uploads, scores = [], []
    undo = [timed_calls(torch, score, "to_device", uploads),
            timed_calls(torch, score, "msssim", scores, events=True)]
    try:
        t0 = time.time()
        (rows, _), launches = counted(torch, kernel_mods, lambda: captured(
            make_dataset_crops_list.main, ["--train_data", root, "--out_dir", lists]))
        audit_s = time.time() - t0
    finally:
        for u in undo:
            u()
    n_pairs = n_sets * grid * (n_isos - 1)  # (ISO100, noisy ISO) a crop
    check(len(rows) == n_pairs, f"the audit scored {len(rows)} pairs, expected {n_pairs}")
    check(not any(launches.values()), f"dataset_tools launched kernels: {launches}")
    picks = np.linspace(0, len(rows) - 1, n_check).round().astype(int)
    errs = [abs(rows[i][2] - score.msssim_files(rows[i][0], rows[i][1], device="cpu"))
            for i in picks]
    check(max(errs) <= SCORE_TOL, f"audit scores off the CPU's by {max(errs)}")
    csv_path = os.path.join(lists, os.path.basename(root) + "-msssim.csv")
    picky = PickyDenoisingDatasetFromList(csv_path, min_quality=0.0, cs=256, seed=0)
    x, y = picky.load_pair(0)
    check(len(picky) == sum(r[2] > 0 for r in rows) > 0 and x.shape == y.shape == (3, 256, 256),
          f"the audit's CSV does not load: {len(picky)} pairs")
    val, _ = captured(pick_validation_set.main, [
        "--train_data", root, "--test_reserve", "SB", "-n", "300", "--seed", "0",
        "--out_dir", os.path.join(tmp, "configs")])
    with open(val) as f:
        val_pairs = yaml.safe_load(f)
    check(len(val_pairs) == min(300, n_pairs // n_sets)
          and all(os.sep + "SB" + os.sep in a and os.sep + "SB" + os.sep in b
                  for a, b in val_pairs), f"pick_validation_set: {val}")
    # one pair's score alone: the card's work against the host's
    pair = [score.to_device(imgio.load_img(p)) for p in rows[0][:2]]
    alone_ms = time_ms(torch, lambda: score.msssim(*pair), 20)
    pair_device_ms, pair_kernels = device_work(torch, lambda: score.msssim(*pair), 10)
    score_s = sum(u[0] for u in uploads) + sum(e[0] for e in scores)
    emit(card, phase="dataset_tools", seconds=time.time() - t_phase,
         scenes=n_images, shape=[*hw, 3], cs=256, stride=192, crops=n_crops, crop_s=crop_s, crops_per_s=n_crops / crop_s,
         audit_pairs=len(rows), audit_wall_s=audit_s, audit_pairs_per_s=len(rows) / audit_s,
         audit_score_host_s=score_s, audit_score_share_of_wall=score_s / audit_s,
         audit_msssim_event_span_ms_mean=float(np.mean([span_ms(e) for e in scores])),
         audit_upload_ms_mean=1e3 * float(np.mean([u[0] for u in uploads])),
         msssim_alone_ms=alone_ms, msssim_device_ms=pair_device_ms,
         msssim_kernels=pair_kernels,
         audit_device_share_of_wall=pair_device_ms * len(rows) / 1e3 / audit_s,
         launches=launches, checked_vs_cpu=len(errs), max_abs_err_vs_cpu=max(errs),
         picky_pairs=len(picky), validation_pairs=len(val_pairs))
    return launches


def eval_records(text):
    """denoise_dir's per-image lines (``in: ..., out: ..., clean: ...``, then
    the losses) -> [{"in", "out", "clean", "losses"}]."""
    import ast

    lines = text.splitlines()
    recs = []
    for line, nxt in zip(lines, lines[1:]):
        m = re.match(r"in: (.*), out: (.*), clean: (.*)$", line)
        if m:
            recs.append(dict(zip(("in", "out", "clean"), m.groups()),
                             losses=ast.literal_eval(nxt)))
    return recs


def phase_eval(torch, card, tmp, kernel_mods, scenes, ckpt, hw, big_hw=BIG_HW):
    """``denoise_dir`` over the scenes' six noisy images with the funit-64
    checkpoint, bf16, cs 504 / ucs 480: walls, the engine's device time,
    score times, K2 launches, peak memory; each image's three losses
    against the CPU's ``get_losses`` on the written files; each written
    image bit-equal to ``AdaptiveEngine.denoise_raw`` called directly; a
    ``--skip_existing`` rerun that decodes and denoises nothing and scores
    the same; then one score of a 24 MP pair. Returns the launch counts."""
    import concurrent.futures as cf
    import shutil

    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.core import imgio
    from nind_denoise_tpu_torch.engine import tile_engine
    from nind_denoise_tpu_torch.eval import denoise_dir, score
    from nind_denoise_tpu_torch.models import params_io

    t_phase = time.time()
    d = os.path.join(tmp, "eval")
    model = os.path.join(d, "model", "generator_1.npz")  # its JSON files go beside it
    os.makedirs(os.path.dirname(model))
    shutil.copy(ckpt, model)
    argv = ["--model_path", model, "--network", "UtNet", "--noisy_dir", scenes,
            "--result_dir", os.path.join(d, "results"), "--cs", "504", "--ucs", "480"]
    dens, losses = [], []
    undo = [timed_calls(torch, tile_engine.AdaptiveEngine, "denoise_raw", dens, events=True),
            timed_calls(torch, score, "losses", losses)]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        (overall, text), launches = counted(torch, kernel_mods,
                                            lambda: captured(denoise_dir.main, argv))
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        for u in undo:
            u()
    recs = eval_records(text)
    n = len(recs)
    check(n == 6 and len(dens) == n, f"eval: {n} images scored, {len(dens)} denoised")
    check(launches["enc1"] == n * cli_batches(*hw)
          and not any(v for k, v in launches.items() if k != "enc1"), f"eval: {launches}")
    check(set(overall) == {"mse", "ssim", "msssim"}
          and all(math.isfinite(v) for v in overall.values()), f"eval: overall {overall}")
    for path in ("model/trainres.json", "model/testres.json", "results/model/res.txt"):
        check(os.path.isfile(os.path.join(d, path)), f"eval: no {path}")

    # the CPU's scores of the written files, computed beside the card's checks
    with cf.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(lambda: [score.get_losses(r["clean"], r["out"], device="cpu")
                                   for r in recs])
        engine = tile_engine.AdaptiveEngine("UtNet", params_io.load_generator(model),
                                            cs=504, ucs=480, batch_size=8)
        for r in recs:
            raw, scale = imgio.load_img_raw(r["in"])
            direct = engine.denoise_raw(raw, scale, out_dtype="uint16")
            written = cv2.cvtColor(cv2.imread(r["out"], cv2.IMREAD_UNCHANGED),
                                   cv2.COLOR_BGR2RGB)
            check(np.array_equal(direct, written),
                  f"eval: {r['out']} differs from AdaptiveEngine.denoise_raw")
        # one image's device work: the denoise (upload to uint16 download)
        # and its score (the upload of the written pixels and the losses)
        base = score.to_device(imgio.load_img(recs[-1]["clean"]))
        den_work = device_work(torch, lambda: engine.denoise_raw(raw, scale, out_dtype="uint16"))
        score_work = device_work(torch, lambda: score.losses(base, score.to_device(direct)))
        del engine, base

        decodes = []
        load_raw = imgio.load_img_raw
        imgio.load_img_raw = lambda p: decodes.append(p) or load_raw(p)
        try:
            t0 = time.time()
            (again, _), skip_launches = counted(torch, kernel_mods, lambda: captured(
                denoise_dir.main, argv + ["--skip_existing"]))
            skip_s = time.time() - t0
        finally:
            imgio.load_img_raw = load_raw
        check(not decodes and not any(skip_launches.values()),
              f"eval --skip_existing: decoded {decodes}, launched {skip_launches}")
        check(again == overall, f"eval --skip_existing scored {again}, the run {overall}")

        # NIND's larger scenes: a whole-image score is this path's largest allocation
        big = write_scenes(os.path.join(tmp, "big"), big_hw, seed=18, sets=("SC",),
                           isos=SCENE_ISOS[::3], ext=".tif")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        big_losses = score.get_losses(*big)
        big_s = time.time() - t0
        big_peak = torch.cuda.max_memory_allocated()
        pair = [score.to_device(imgio.load_img(p)) for p in big]
        big_device_ms = time_ms(torch, lambda: score.losses(*pair), 3)
        del pair
        check(all(math.isfinite(v) for v in big_losses.values()), f"eval: 24 MP {big_losses}")

        errs = [max(abs(c[k] - r["losses"][k]) for k in c)
                for c, r in zip(cpu.result(), recs)]
    check(max(errs) <= SCORE_TOL, f"eval: card scores off the CPU's by {errs}")
    emit(card, phase="eval", seconds=time.time() - t_phase, images=n, shape=[*hw, 3],
         compute_dtype="bfloat16", cs=504, ucs=480, batch=8, wall_s=wall,
         wall_s_per_image=wall / n,
         denoise_host_ms=[1e3 * e[0] for e in dens],
         denoise_event_span_ms=[span_ms(e) for e in dens],
         denoise_device_ms=den_work[0], denoise_device_ops=den_work[1],
         score_device_ms=score_work[0], score_device_ops=score_work[1],
         device_share_of_wall=(den_work[0] + score_work[0]) * n / 1e3 / wall,
         score_ms=[1e3 * e[0] for e in losses[:n]],
         gen_score_ms=1e3 * sum(e[0] for e in losses[n:]),
         launches=launches, enc1_per_image=launches["enc1"] / n,
         peak_memory_allocated_gib=peak / 2 ** 30, overall=overall,
         max_abs_err_vs_cpu=max(errs), bit_equal_to_direct_engine=True,
         skip_existing={"wall_s": skip_s, "decodes": len(decodes), "launches": skip_launches},
         big_pair={"shape": [*big_hw, 3], "get_losses_s": big_s, "losses_device_ms": big_device_ms,
                   "peak_memory_allocated_gib": big_peak / 2 ** 30, "losses": big_losses})
    return launches


# The UNet and Hul-generator phases (unet_cli, unet_train, hul_gen_train).
# UNet's bf16 CLI output against its own fp32 run (TF32 off) on the card,
# after RL, as a PSNR of the pre-encode uint8 (dB): bf16 convs with fp32
# BatchNorm lie ~2e-3 RMS from fp32 (tests/test_torch_unet.py, CPU).
UNET_CLI_PSNR_DB = 40.0
UNET_CPU_HW = (512, 768)  # the card-vs-CPU fp32 CLI check's image
# A UNet or Hul generator step resumed from its run's checkpoint, card
# against CPU (generator_step_vs_cpu): losses and gradients as the train
# phase's (TRAIN_*); the BN running stats to 1e-4 of max(1, |stat|); the
# card's update to the CPU's AMSGrad on the card's gradient, 1e-6 absolute
# (the fp32 rounding of an update of at most lr, 3e-4, in parameters below
# ~2: a few ulps).
UNET_BN_TOL, GEN_UPDATE_TOL = 1e-4, 1e-6
HUL_FWD_TOL = 1e-4  # Hulbs128Net's fp32 forward, card (TF32 off) vs CPU


def with_model_entry(cli, name, entry):
    """``cli``'s model table with ``name`` -> ``entry`` added (the way a user
    adds a network to ``operations.yaml``); returns the restore function."""
    read = cli.xmp.read_config

    def read_with(*a, **kw):
        cfg = read(*a, **kw)
        cfg["models"][name] = dict(entry)
        return cfg

    cli.xmp.read_config = read_with
    return lambda: setattr(cli.xmp, "read_config", read)


def phase_unet_cli(torch, card, tmp, kernel_mods, tif):
    """``denoise_cli --tiff-input`` with a model table entry whose network is
    UNet (seeded full-width weights, BN state), bf16, UNet's cs 440 / ucs
    320, on the 6 MP TIFF: warm wall, device time, peak memory, K1 10 and K2
    0 launches; the bf16 output against the card's fp32 run (TF32 off) as a
    PSNR with a floor; the card's fp32 uint8 within 1 LSB of the CPU's on
    a 512 x 768 image; then ``DenoiseService("UNet", ...)`` requests, each
    bit-equal to the engine + RL run of its image. Returns the warm CLI
    run's launch counts."""
    import cv2
    import numpy as np

    from nind_denoise_tpu_torch.ops import rl_deblur as RL
    from nind_denoise_tpu_torch.pipeline import denoise_cli
    from nind_denoise_tpu_torch.pipeline import serve as S
    from nind_denoise_tpu_torch.tools import fixtures

    t0 = time.time()
    d = os.path.join(tmp, "unet")
    os.makedirs(os.path.join(d, "out"))
    ckpt = os.path.join(d, "generator_1.npz")
    fixtures.write_unet_checkpoint(ckpt, seed=13)
    restore = with_model_entry(denoise_cli, "unet", {"path": ckpt, "network": "UNet"})
    argv = [tif, "--tiff-input", "--model", "unet", "-o", os.path.join(d, "out"),
            "--batch_size", "8"]
    try:
        cli_run(denoise_cli, argv)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        (out, seen, _), launches = counted(torch, kernel_mods, lambda: cli_run(denoise_cli, argv))
        wall = time.time() - t1
        peak = torch.cuda.max_memory_allocated()
        check(launches["rl_iter"] == 10 and sum(launches.values()) == 10,
              f"unet_cli: launches {launches}, expected rl_iter 10 and nothing else")
        img = cv2.imread(str(out))
        check(img is not None and img.shape == (*HW, 3), f"unet_cli: bad output {out}")
        kernels = device_kernels(torch, lambda: cli_run(denoise_cli, argv), top=None)
        device_ms, top = sum(kernels.values()), dict(list(kernels.items())[:8])
        fp32 = cli_run(denoise_cli, argv + ["--compute_dtype", "float32",
                                            "--precision", "float32"])[1][0]
        psnr = psnr_u8(seen[0], fp32)
        check(psnr >= UNET_CLI_PSNR_DB, f"unet_cli: bf16 vs fp32 PSNR {psnr} dB")
        small = os.path.join(d, "small.tif")
        rng = np.random.default_rng(14)
        check(cv2.imwrite(small, rng.integers(0, 65536, (*UNET_CPU_HW, 3)).astype(np.uint16)),
              "could not write the TIFF")
        t2 = time.time()
        u8 = [cli_run(denoise_cli, [small, "--tiff-input", "--model", "unet", "-o",
                                    os.path.join(d, "out"), "--compute_dtype", "float32",
                                    "--precision", "float32", "--device", dev])[1][0]
              for dev in (DEV, "cpu")]
        cpu_s = time.time() - t2
        diff = max_lsb(*u8)
        check(diff <= 1, f"unet_cli: card and CPU differ by {diff} LSB")
    finally:
        restore()

    svc = S.DenoiseService("UNet", ckpt, batch_size=8, compute_dtype="bfloat16")
    try:
        reqs = [rng.integers(0, 65536, hw + (3,), dtype=np.uint16)
                for hw in ((480, 480), (480, 480), (1000, 1500))]
        bodies = []
        for raw in reqs:
            ok, buf = cv2.imencode(".png", raw[..., ::-1])
            check(ok, "PNG encode failed")
            body, n = counted(torch, kernel_mods, lambda: svc.denoise_bytes(
                buf.tobytes(), output="png", iterations=10))
            check(n["rl_iter"] == 10 and sum(n.values()) == 10, f"unet serve: launches {n}")
            bodies.append(body)
        equal = []
        for raw, body in zip(reqs, bodies):
            got = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_UNCHANGED)[..., ::-1]
            want = RL.rl_to_u8_device(svc._adaptive.denoise_raw(raw, 65535.0, out_dtype="device"),
                                      1.0, 10).cpu().numpy()
            equal.append(bool(np.array_equal(got, want)))
        check(all(equal), f"unet serve: responses equal to the engine + RL run: {equal}")
    finally:
        svc.close()
    emit(card, phase="unet_cli", shape=[*HW, 3], compute_dtype="bfloat16", cs=440, ucs=320,
         wall_s=wall, mp_per_s=HW[0] * HW[1] / 1e6 / wall, device_ms=device_ms,
         device_busy_share=device_ms / 1e3 / wall, top_device_ms=top,
         peak_memory_allocated_gib=peak / 2 ** 30, launches=launches,
         psnr_bf16_vs_fp32_db=psnr, psnr_floor_db=UNET_CLI_PSNR_DB,
         cpu_check={"shape": [*UNET_CPU_HW, 3], "max_lsb_diff_cuda_vs_cpu": diff,
                    "seconds": cpu_s},
         serve={"shapes": [list(r.shape) for r in reqs], "equal_to_engine_rl_run": equal},
         phase_s=time.time() - t0)
    return launches


def generator_step_vs_cpu(torch, ckpt, network, weights, lr, beta1, loss_cs, clean, noisy,
                          activation="PReLU"):
    """One fp32 step (TF32 off) of ``network`` resumed from ``ckpt`` as the
    trainer resumes it (weights, BN state, AMSGrad), on the card and on the
    CPU on the same batch, and on the CPU in float64 (reported). Held: the
    losses and the gradient's norm to the TRAIN_* bounds, the BN running
    stats to ``UNET_BN_TOL``, no parameter apart by more than the learning
    rate, and the card's update to the CPU's AMSGrad applied to the card's
    own gradient from the same state (``GEN_UPDATE_TOL``). The share of
    parameters more than 1 % of the learning rate apart is reported, not
    held: from the run's four-step AMSGrad state an element whose gradient
    is small against its rounding (the biases of the convs before each
    BatchNorm have a gradient of 0 in exact arithmetic) moves by a noisy
    fraction of the learning rate, and the card's cuDNN gradient lies a few
    times further from float64 than the CPU's (UNet, card against CPU:
    0.21 %, 0.0099 % and 1.16 % of the parameters in three runs)."""
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.train import loop, steps

    tree = params_io.load_npz(ckpt)

    def resumed(dev, dt):
        model = params_io.load_generator(ckpt, network, activation).to(dev, dt).train()
        opt = steps.make_optimizer(model, lr, beta1)
        loop.GeneratorWrapper.restore_opt(opt, model, tree["opt"], tree["params"], network)
        return model, opt

    res = []
    for dev, dt in ((DEV, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        model, opt = resumed(dev, dt)
        names = [k for k, _ in model.named_parameters()]
        m = steps.make_generator_train_step(steps.plain_apply, weights, loss_cs)(
            steps.TrainState(model, opt), clean.to(dev, dt), noisy.to(dev, dt))
        sd = {k: v.detach().cpu().double() for k, v in model.state_dict().items()}
        grads = [p.grad.detach().cpu() for p in model.parameters()]
        res.append((float(m["weighted"]), grads, sd, opt.hyper["learning_rate"]))
    (lg, grads_card, sg, lr_now), (lc, grads_cpu, sc, _), (l64, grads64, s64, _) = res
    gg, gc, g64 = (torch.cat([g.double().flatten() for g in gs])
                   for gs in (grads_card, grads_cpu, grads64))
    # the update alone: the CPU's AMSGrad from the same state on the card's gradient
    model, opt = resumed("cpu", torch.float32)
    for p, g in zip(model.parameters(), grads_card):
        p.grad = g.clone()
    opt.step()
    upd = max(((p.detach().double() - sg[k]).abs().max().item()
               for k, p in model.named_parameters()), default=0.0)
    stats = [k for k in sc if k.endswith(("running_mean", "running_var"))]
    bn = max([((sg[k] - sc[k]).abs() / sc[k].abs().clamp_min(1)).max().item() for k in stats],
             default=0.0)
    dp = torch.cat([(sg[k] - sc[k]).abs().flatten() for k in names])
    share64 = {name: (torch.cat([(sd[k] - s64[k]).abs().flatten() for k in names])
                      > lr_now / 100).float().mean().item()
               for name, sd in (("cuda", sg), ("cpu", sc))}
    rec = {"shape": list(clean.shape), "resumed_from": os.path.basename(ckpt),
           "checkpoint_epoch": tree.get("epoch"), "lr": lr_now,
           "loss_cuda": lg, "loss_cpu": lc, "loss_float64": l64, "loss_abs_diff": abs(lg - lc),
           "grad_norm": gc.norm().item(), "grad_norm_rel_diff": ((gg - gc).norm() / gc.norm()).item(),
           "grad_norm_rel_diff_vs_float64": {"cuda": ((gg - g64).norm() / g64.norm()).item(),
                                             "cpu": ((gc - g64).norm() / g64.norm()).item()},
           "bn_stat_rel_diff": bn, "param_max_abs_diff": dp.max().item(),
           "update_max_abs_diff_vs_cpu_amsgrad_on_card_grad": upd,
           "param_share_over_lr_1pct_not_held": (dp > lr_now / 100).float().mean().item(),
           "param_share_over_lr_1pct_vs_float64_not_held": share64,
           "tolerance": {"loss": TRAIN_LOSS_TOL, "grad_norm_rel": TRAIN_GRAD_TOL,
                         "bn": UNET_BN_TOL, "param_max": lr_now, "update": GEN_UPDATE_TOL}}
    check(math.isfinite(lg) and rec["loss_abs_diff"] <= TRAIN_LOSS_TOL and rec["grad_norm"] > 0,
          f"{network} card vs CPU: loss {rec}")
    check(rec["grad_norm_rel_diff"] <= TRAIN_GRAD_TOL, f"{network} card vs CPU: gradients {rec}")
    check(bn <= UNET_BN_TOL, f"{network} card vs CPU: BN stats {rec}")
    check(rec["param_max_abs_diff"] <= lr_now and upd <= GEN_UPDATE_TOL,
          f"{network} card vs CPU: parameters {rec}")
    return rec


def train_run(torch, kernel_mods, argv, models):
    """``train.loop`` on ``argv`` into ``models``: (experiment dir, its
    ``trainres.json``, its printed output, launch counts)."""
    import json as _json

    from nind_denoise_tpu_torch.train import loop

    (exp, text), launches = counted(torch, kernel_mods, lambda: captured(
        loop.main, argv + ["--models_dpath", models]))
    with open(os.path.join(exp, "trainres.json")) as f:
        return exp, _json.load(f), text, launches


def phase_unet_train(torch, card, tmp, kernel_mods, batch=20, cs=220):
    """``train.loop`` with ``train_conf_unet.yaml`` and ``--weight_MSSSIM 0
    --weight_MSE 1`` (UNet, batch 20, cs 220, loss_cs 161, fp32) for two
    epochs of two steps on seeded 256 px crops; a resume for one more
    epoch with ``--compute_dtype bfloat16``, which warns and trains in
    fp32; warm step times (ms, crops/s, peak memory, the BN kernels' share
    of the device time); one step resumed from the run's checkpoint on the
    card against the CPU at batch 2. Returns the two-epoch run's counts."""
    t0 = time.time()
    root = os.path.join(tmp, "unet_train", "SYN_256_220")
    val = os.path.join(tmp, "unet_train", "val.yaml")
    write_train_crops(root, val, scenes=2, crops=batch, size=256, seed=3)
    cfg = os.path.join(ROOT, "nind_denoise_tpu_torch", "configs", "train_conf_unet.yaml")
    argv = ["--config", cfg, "--train_data", root, "--validation_set_yaml", val,
            "--test_reserve", "0", "--threads", "1", "--device", DEV,
            "--weight_MSSSIM", "0", "--weight_MSE", "1", "--batch_size", str(batch),
            "--cs", str(cs)]
    exp, res, _, launches = train_run(torch, kernel_mods, argv + ["--epochs", "3"],
                                      os.path.join(tmp, "unet_train", "models"))
    epochs = {e: res[str(e)] for e in (0, 1, 2)}
    check(all(math.isfinite(v) for r in epochs.values() for v in r.values()),
          f"unet_train: non-finite results {epochs}")
    check("train_weighted_loss" in epochs[2] and sum(launches.values()) == 0,
          f"unet_train: {res} launches {launches}")
    ckpt = highest(exp, "generator")
    _, res2, text, _ = train_run(torch, kernel_mods, argv + [
        "--epochs", "4", "--g_model_path", ckpt, "--compute_dtype", "bfloat16"],
        os.path.join(tmp, "unet_train", "resumed"))
    check("training UNet in float32" in text and math.isfinite(
        res2.get("3", {}).get("train_weighted_loss", math.nan)), f"unet_train resume: {res2}")
    cli_s = time.time() - t0
    clean, noisy = train_batch(torch, root, batch, cs)
    weights = {"MSE": 1}
    times = train_step_times(torch, ckpt, clean, noisy, network="UNet", weights=weights,
                             loss_cs=161, dtypes=("float32",))
    cpu = generator_step_vs_cpu(torch, ckpt, "UNet", weights, 3e-4, 0.5, 161, clean[:2],
                                noisy[:2])
    emit(card, phase="unet_train", config="train_conf_unet.yaml + --weight_MSSSIM 0 "
         "--weight_MSE 1", batch=batch, cs=cs, loss_cs=161, epochs=epochs,
         launches=launches, checkpoint=os.path.basename(ckpt), cli_s=cli_s,
         bf16_resume={"warned": True, "epoch_3": res2["3"]}, step=times, card_vs_cpu=cpu,
         phase_s=time.time() - t0)
    return launches


def phase_hul_gen_train(torch, card, tmp, kernel_mods, funit=32, batch=12):
    """``train.loop --g_network Hulb128Net --cs 128 --loss_cs 120
    --batch_size 12 --g_funit 32 --weight_MSSSIM 0 --weight_MSE 1`` for
    one epoch of three steps in fp32 and in bf16 on seeded 144 px crops;
    warm step times in both; one fp32 step resumed from the fp32 run's
    checkpoint on the card against the CPU at batch 2; Hulbs128Net's
    forward at funit 32, card (TF32 off) against the CPU. Returns the fp32
    run's counts."""
    import numpy as np

    from nind_denoise_tpu_torch.engine.tile_engine import _tf32
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.tools import fixtures

    t0 = time.time()
    root = os.path.join(tmp, "hul_gen", "SYN_144_128")
    val = os.path.join(tmp, "hul_gen", "val.yaml")
    write_train_crops(root, val, scenes=2, crops=3 * batch // 2, size=144, seed=5)
    argv = ["--train_data", root, "--validation_set_yaml", val, "--test_reserve", "0",
            "--threads", "1", "--device", DEV, "--g_network", "Hulb128Net", "--cs", "128",
            "--loss_cs", "120", "--batch_size", str(batch), "--g_funit", str(funit),
            "--weight_MSSSIM", "0", "--weight_MSE", "1", "--g_lr", "3e-4", "--epochs", "2"]
    runs, launches = {}, None
    for dtype in ("float32", "bfloat16"):
        exp, res, _, n = train_run(torch, kernel_mods, argv + ["--compute_dtype", dtype],
                                   os.path.join(tmp, "hul_gen", dtype))
        check(math.isfinite(res["1"].get("train_weighted_loss", math.nan))
              and sum(n.values()) == 0, f"hul_gen_train {dtype}: {res} launches {n}")
        runs[dtype] = {"epoch_1": res["1"], "checkpoint": highest(exp, "generator")}
        launches = launches or n
    ckpt = runs["float32"]["checkpoint"]
    clean, noisy = train_batch(torch, root, batch, 128)
    weights = {"MSE": 1}
    times = train_step_times(torch, ckpt, clean, noisy, network="Hulb128Net", weights=weights,
                             loss_cs=120)
    cpu = generator_step_vs_cpu(torch, ckpt, "Hulb128Net", weights, 3e-4, 0.5, 120,
                                clean[:2], noisy[:2])
    params = fixtures.hul_gen_params("Hulbs128Net", funit, 6)
    sd = params_io.hul_gen_state_dict_from_jax(params, "Hulbs128Net")
    x = torch.from_numpy(np.random.default_rng(6).random((2, 3, 128, 128), np.float32))
    outs = []
    for dev in (DEV, "cpu"):
        model = params_io.generator_from_state_dict(sd, "PReLU", "Hulbs128Net").to(dev)
        with torch.no_grad(), _tf32(False):
            outs.append(model(x.to(dev)).cpu())
    fwd_err = (outs[0] - outs[1]).abs().max().item()
    check(fwd_err <= HUL_FWD_TOL, f"Hulbs128Net forward card vs CPU: {fwd_err}")
    emit(card, phase="hul_gen_train", network="Hulb128Net", funit=funit, batch=batch, cs=128,
         loss_cs=120, runs={k: {**v, "checkpoint": os.path.basename(v["checkpoint"])}
                            for k, v in runs.items()},
         launches=launches, step=times, card_vs_cpu=cpu,
         hulbs128net_forward={"shape": list(x.shape), "funit": funit,
                              "max_abs_err_cuda_vs_cpu": fwd_err, "tolerance": HUL_FWD_TOL},
         phase_s=time.time() - t0)
    return launches


# The legacy and pix2pix zoo (zoo, zoo_gan) and the profiler capture (trace).
# Each zoo forward at full width on the card (fp32, TF32 off) against a
# float64 CPU forward of the same seeded weights, within ZOO_TOL of the
# reference's largest magnitude; the CPU's own fp32 forward must meet it too
# (seen on the CPU at 96 px: 1.7e-5 or less). The CPU's references are cut
# (float64 convolutions run at 40-75 GFLOP/s on the chip machine's eight
# cores): in eval mode, where each image is its own, to the first
# ZOO_CPU_EVAL images of the card's batch, and for DnCNN, whose output pixel
# sees only the 22 px around it through zero-padded 3x3 convs, to a 96 px
# crop of that image whose interior (22 px in from each side) the card's
# whole-image output must match; in train mode, where the batch's statistics
# couple the images, both devices run the first ZOO_CPU_TRAIN images cut to
# ZOO_TRAIN_HW px. Four, not two, and running stats calibrated on the whole
# batch of 8: a BatchNorm over two values a channel (HunNet's 1 x 1 bottom)
# reads an fp32 forward 7-9e-5 from float64 on the card, four and eight 3-4e-6
# on the CPU.
ZOO_TOL = 1e-4
ZOO_CPU_EVAL, ZOO_CPU_TRAIN, ZOO_TRAIN_HW = 1, 4, 128
# (network, its constructor arguments, the input of the card's forward, the
# eval reference's crop and its margin or None, the train-mode input's size);
# RedCNN's 27 VALID 5x5 convs take 108 px off a side before its decoder puts
# them back: at 256 px one image is 1.8 TFLOP, 40 s of the CPU's float64, so
# it runs at 128
ZOO_NETS = (
    ("DnCNN", {"depth": 22, "n_channels": 64}, (8, 3, 256, 256), (96, 22), ZOO_TRAIN_HW),
    ("RedCNN", {"n_channels": 128, "depth": 30}, (8, 3, 128, 128), None, ZOO_TRAIN_HW),
    ("ResnetGenerator", {"ngf": 64, "n_blocks": 9, "norm_type": "batch"}, (8, 3, 256, 256),
     None, ZOO_TRAIN_HW),
    ("PatchGAN", {"ndf": 64, "n_layers": 3}, (8, 6, 256, 256), None, ZOO_TRAIN_HW),
    ("PixelDiscriminator", {"ndf": 64}, (8, 6, 256, 256), None, ZOO_TRAIN_HW),
    ("MultiscaleDiscriminator", {"ndf": 64, "num_D": 3}, (8, 6, 256, 256), None, ZOO_TRAIN_HW),
)


def calibrate_bn(torch, model, x):
    """Set ``model``'s running stats to the statistics of one forward of
    ``x`` with its BatchNorms in train mode (as a trained network's match
    its activations; random stats let the ResnetGenerator's blocks grow
    until tanh saturates, an ill-conditioned eval forward): the mean of the
    statistics of a BatchNorm's every use (RedishCNN's one BatchNorm serves
    48; the others one). Only the BatchNorms leave eval mode, so a network
    that refuses a train-mode forward (MobileNetV3) calibrates too. Returns
    the model in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    keep = [m.momentum for m in bns]
    model.eval()
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative mean
        m.train()
    with torch.no_grad():
        model(x)
    for m, k in zip(bns, keep):
        m.momentum = k
    return model.eval()


def rel_err(got, ref):
    """max |got - ref| / max |ref| over paired lists (or dicts) of tensors."""
    if isinstance(ref, dict):
        got, ref = [got[k] for k in ref], list(ref.values())
    return max(((g.double() - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
               for g, r in zip(got, ref)) if ref else 0.0


ZOO_CPU_WORKERS = 4  # threads for the CPU references (float64's slow paths use ~3 of 8 cores)


def zoo_forward(torch, model, x, train, tf32_off=True):
    """``model`` in train or eval mode on ``x`` without autograd (nor TF32,
    unless ``tf32_off`` is False: the switch is process-wide, so a CPU
    forward in a worker thread leaves it alone): (its outputs as a list, its
    BN running stats by name), on the CPU."""
    from nind_denoise_tpu_torch.engine.tile_engine import _tf32

    with torch.no_grad(), (_tf32(False) if tf32_off else contextlib.nullcontext()):
        y = model.train(train)(x)
    ys = y if isinstance(y, list) else [y]
    stats = {k: v.detach().cpu().double() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return [t.detach().cpu().double() for t in ys], stats


def depthwise_taps(torch, model):
    """``model`` with every depthwise conv computed as a sum of its k x k
    shifted, strided slices (torch's float64 CPU conv runs a depthwise conv
    one group at a time: MobileNetV3's forward takes minutes that way, 8 s
    this way); the same function, in place. Other modules are untouched."""
    import torch.nn.functional as F

    class Taps(torch.nn.Module):
        def __init__(self, conv):
            super().__init__()
            self.conv = conv

        def forward(self, x):
            c = self.conv
            (k, _), (d, _), (s, _), (p, _) = c.kernel_size, c.dilation, c.stride, c.padding
            xp = F.pad(x, (p, p, p, p))
            ho = (xp.shape[2] - d * (k - 1) - 1) // s + 1
            wo = (xp.shape[3] - d * (k - 1) - 1) // s + 1
            out = 0
            for i in range(k):
                for j in range(k):
                    out = out + c.weight[:, 0, i, j].view(1, -1, 1, 1) * xp[
                        :, :, i * d:i * d + s * (ho - 1) + 1:s, j * d:j * d + s * (wo - 1) + 1:s]
            return out if c.bias is None else out + c.bias.view(1, -1, 1, 1)

    for name, child in model.named_children():
        if isinstance(child, torch.nn.Conv2d) and 1 < child.groups == child.in_channels:
            setattr(model, name, Taps(child))
        else:
            depthwise_taps(torch, child)
    return model


def nets_vs_float64(torch, nets, seed, tol=ZOO_TOL, cpu_fp32=True):
    """Each network of ``nets`` ((network, constructor arguments, the card's
    input shape, the eval reference's crop and its margin or None, the
    train-mode input's size or None) at full width, seeded weights with
    calibrated BatchNorm stats (``calibrate_bn`` on the card, on a batch
    of the train size, or of the input's): the card's eval forward at the
    given batch (warm ms a forward, its FLOP count and bound), its first
    ``ZOO_CPU_EVAL`` images (or the interior of a crop's) against the CPU's
    float64 forward of them; with BatchNorm, a train-mode forward of
    ``ZOO_CPU_TRAIN`` images of the train size (cut from the batch where it
    is smaller than the input, else drawn) on each device, outputs and new
    running stats against float64; each within ``tol``, which the CPU's
    fp32 forward must meet too where ``cpu_fp32``. A network of
    ``EVAL_ONLY`` runs no train-mode forward: it must raise
    NotImplementedError on the card. The CPU forwards run on
    ``ZOO_CPU_WORKERS`` threads beside the card's. Returns the records by
    label (the network, and each constructor flag set), and the seconds of
    the whole and of the CPU's wait after the card's last forward."""
    import copy
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from nind_denoise_tpu_torch.engine.tile_engine import _tf32
    from nind_denoise_tpu_torch.models import build
    from nind_denoise_tpu_torch.tools import fixtures

    def on_cpu(model, x, train, wide):
        m = depthwise_taps(torch, copy.deepcopy(model)).double() if wide else copy.deepcopy(model)
        return pool.submit(zoo_forward, torch, m, x.double() if wide else x, train, False)

    recs, pending = {}, []
    t0 = time.time()
    with ThreadPoolExecutor(ZOO_CPU_WORKERS) as pool:
        for i, (network, kw, shape, crop, train_size) in enumerate(nets):
            t1 = time.time()
            label = network + "".join(f"/{k}" for k, v in kw.items() if v is True)
            rng = np.random.default_rng(seed + 10 + i)
            model = fixtures.seed_zoo_module(build(network, **kw), seed + i).eval()
            has_bn = any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
            if has_bn:
                ch, cw = (train_size, train_size) if train_size else shape[2:]
                calib = torch.from_numpy(rng.random((shape[0], shape[1], ch, cw), np.float32))
                model.load_state_dict(calibrate_bn(torch, copy.deepcopy(model).to(DEV),
                                                   calib.to(DEV)).state_dict())
            x = torch.from_numpy(rng.random(shape, np.float32))
            card_model = copy.deepcopy(model).to(DEV).eval()
            xd = x.to(DEV)
            got, _ = zoo_forward(torch, card_model, xd, False)

            def fwd():
                with torch.no_grad(), _tf32(False):
                    return card_model(xd)

            ms = time_ms(torch, fwd, 3)
            with FlopCounterMode(display=False) as fc:
                fwd()
            flops = fc.get_total_flops()
            nbytes = 4 * (x.numel() + sum(t.numel() for t in got)
                          + sum(p.numel() for p in model.parameters()))
            bound, by = bound_ms(nbytes, flops, "float32")
            xe, card_e = x[:ZOO_CPU_EVAL], [g[:ZOO_CPU_EVAL] for g in got]
            if crop is not None:  # the interior of a crop, whose pixels see no padding
                size, m = crop
                r = (shape[2] - size) // 2
                xe = xe[:, :, r:r + size, r:r + size]
                card_e = [g[:, :, r + m:r + size - m, r + m:r + size - m] for g in card_e]
            cpu = {"eval": (on_cpu(model, xe, False, True),
                            on_cpu(model, xe, False, False) if cpu_fp32 else None)}
            card = {"eval": (card_e, None)}
            extra = {}
            if network in EVAL_ONLY:
                try:
                    zoo_forward(torch, card_model, xd[:1], True)
                    raised = False
                except NotImplementedError:
                    raised = True
                extra["train_mode_raises"] = raised
                check(raised, f"{label}: a train-mode forward ran on the card")
            elif has_bn:
                t = train_size or shape[2]
                xt = x[:ZOO_CPU_TRAIN, :, :t, :t] if t <= shape[2] else torch.from_numpy(
                    rng.random((ZOO_CPU_TRAIN, shape[1], t, t), np.float32))
                cpu["train"] = (on_cpu(model, xt, True, True),
                                on_cpu(model, xt, True, False) if cpu_fp32 else None)
                card["train"] = zoo_forward(torch, copy.deepcopy(model).to(DEV), xt.to(DEV), True)
                extra["train_input"] = list(xt.shape)
            recs[label] = {"input": list(shape), **kw, "eval_crop": crop, "ms": ms,
                           "tflop": flops / 1e12, "build_and_card_s": time.time() - t1,
                           "bound_ms": bound, "bound_by": by, "ms_over_bound": ms / bound,
                           **extra, "output_shapes": [list(t.shape) for t in got]}
            pending.append((label, crop, cpu, card))
            del card_model, xd, got
        t2 = time.time()
        for label, crop, cpu, card in pending:
            err = {}
            for mode, (ref_f, fp32_f) in cpu.items():
                (ref, ref_stats), runs = ref_f.result(), {"cuda": card[mode]}
                if fp32_f is not None:
                    runs["cpu_fp32"] = fp32_f.result()
                if crop is not None and mode == "eval":
                    size, m = crop
                    ref = [t[:, :, m:size - m, m:size - m] for t in ref]
                    if "cpu_fp32" in runs:
                        runs["cpu_fp32"] = ([t[:, :, m:size - m, m:size - m]
                                             for t in runs["cpu_fp32"][0]], None)
                err[mode] = {dev: rel_err(out, ref) for dev, (out, _) in runs.items()}
                if mode == "train":
                    err["train_bn_stats"] = {dev: rel_err(st, ref_stats)
                                             for dev, (_, st) in runs.items()}
            recs[label]["rel_err_vs_float64"] = err
            worst = max(v for e in err.values() for v in e.values())
            check(all(math.isfinite(v) for e in err.values() for v in e.values())
                  and worst <= tol, f"{label} against float64: {recs[label]}")
    return recs, {"all_s": time.time() - t0, "cpu_after_card_s": time.time() - t2}


def phase_zoo(torch, card):
    """Every network of the legacy and pix2pix zoo (``ZOO_NETS``) at full
    width against float64 (``nets_vs_float64``), BatchNorm calibrated and
    train mode at ``ZOO_TRAIN_HW`` px."""
    t0 = time.time()
    recs, secs = nets_vs_float64(torch, ZOO_NETS, 30)
    emit(card, phase="zoo", precision="float32, TF32 off", tolerance=ZOO_TOL,
         cpu_images={"eval": ZOO_CPU_EVAL, "train": ZOO_CPU_TRAIN, "train_hw": ZOO_TRAIN_HW},
         nets=recs, seconds=secs, phase_s=time.time() - t0)


# The relic zoo and MobileNetV3 at JAX's default widths, each at its native
# size: the Hu family 160 px, Hul128Net 128, Hul144Disc 144 with each head,
# HunkyDisc 256, HunkyNet 224 (its train-mode forward at 256: at 224 its
# 1 x 1 bottom normalizes two values a channel, an fp32 forward 4e-4 from
# float64), RedishCNN 112 (at 160 one image is 479 GFLOP, ~10 s of the CPU's
# float64), MobileNetV3 512. HulNet is Hul160Net. The CPU's float64 runs one
# image in eval mode and 2 in train mode, at the full size.
RELIC_NETS = (
    ("HunNet", {"funit": 32}, (8, 3, 160, 160), None, None),
    ("HuNet", {"funit": 32}, (8, 3, 160, 160), None, None),
    ("Hul160Net", {"funit": 32}, (8, 3, 160, 160), None, None),
    ("HuDisc", {"funit": 32}, (8, 3, 160, 160), None, None),
    ("Hul128Net", {"funit": 32}, (8, 3, 128, 128), None, None),
    ("Hul144Disc", {"funit": 32}, (8, 3, 144, 144), None, None),
    ("Hul144Disc", {"funit": 32, "finalpool": True}, (8, 3, 144, 144), None, None),
    ("HunkyDisc", {}, (8, 3, 256, 256), None, None),
    ("HunkyNet", {}, (8, 3, 224, 224), None, 256),
    ("RedishCNN", {"n_channels": 128, "depth": 30}, (8, 3, 112, 112), None, None),
    ("MobileNetV3", {}, (8, 3, 512, 512), None, None),
)
EVAL_ONLY = ("MobileNetV3",)  # a train-mode forward raises, as in JAX
# HunkyNet's 45 conv and BatchNorm layers accumulate fp32 rounding about
# evenly, layer by layer: its train-mode forward on the card read 9.7e-5 of
# its largest output from float64 (PERF.md §6, PR 18), at ZOO_TOL's edge;
# the other relics read 5.1e-5 or less
RELIC_TOL = 2e-4


def phase_relics(torch, card):
    """The relic zoo and MobileNetV3 (``RELIC_NETS``) against float64 as
    zoo holds its networks (``nets_vs_float64``), BatchNorm calibrated and
    train mode at each net's native size (HunkyNet's at 256 px), no CPU
    fp32 forward (the float64 references are the phase's cost)."""
    t0 = time.time()
    recs, secs = nets_vs_float64(torch, RELIC_NETS, 60, RELIC_TOL, cpu_fp32=False)
    emit(card, phase="relics", precision="float32, TF32 off", tolerance=RELIC_TOL,
         cpu_images={"eval": ZOO_CPU_EVAL, "train": ZOO_CPU_TRAIN}, nets=recs, seconds=secs,
         phase_s=time.time() - t0)


# (D1, D2): each network and the constructor arguments its checkpoint must
# read back (6 channels, conditional; the pix2pix critics at ndf 64 whatever
# --d_funit says, the relic critics at --d_funit 32)
ZOO_GAN_CRITICS = (("PatchGAN", {"input_nc": 6, "ndf": 64}),
                   ("PixelDiscriminator", {"input_nc": 6, "ndf": 64}))
RELIC_GAN_CRITICS = (("HuDisc", {"input_channels": 6, "funit": 32}),
                     ("Hul144Disc", {"input_channels": 6, "funit": 32}))
# relic_gan times and holds Hul144Disc (D2, both heads, the unused one's
# gradient 0). A Hul144Disc step takes ~0.8 s at batch 30 or 2 (cuDNN's FFT
# convs): the held check ages the run's checkpoint its 200 steps with cuDNN
# off (~10 s; a younger Adam state turns more fp32 gradient noise into
# parameter differences, and 20 steps left too many elements over 1 % of lr
# apart, PERF.md §6), steps one batch of 2 from the run's checkpoint, and
# the step times take 2 repetitions, not 5.
RELIC_GAN = {"critics": RELIC_GAN_CRITICS, "held": 1, "n_pairs": 1, "age_cudnn": False,
             "reps": 2}


def phase_zoo_gan(torch, card, tmp, kernel_mods, batch=30, cs=184, extra=(), phase="zoo_gan",
                  critics=ZOO_GAN_CRITICS, held=0, n_pairs=GAN_RUN_PAIRS,
                  steps_before=GAN_DISC_STEPS, reps=5, age_cudnn=True):
    """The cGAN with the critics ``critics`` (D1, D2; by default the pix2pix
    critics; phase relic_gan: HuDisc and Hul144Disc): ``train.loop`` with
    ``train_conf_utnet_std.yaml`` and ``--weight_D1 0.2 --d_lr 1e-4
    --d_network <D1> --weight_D2 0.2 --d2_lr 1e-4 --d2_network <D2>``
    (both conditional, 6 channels) for two epochs on the train phase's
    seeded crops: finite losses, both checkpoints at their widths, K2
    launched once per learn of either critic (its generator forward) and
    once per validation pair and validation; a resume from both
    checkpoints carrying each Adam's count and plateau scheduler; warm
    times of a both-learn batch of critic ``held`` (0: D1, 1: D2) against
    its FLOP bound (``gan_step_times``, ``reps`` calls a time); one
    discriminator step of it and one generator step with its fooling term
    on the card against the CPU (``gan_card_vs_cpu``, on ``n_pairs``
    batches of 2 from the run's checkpoint trained ``steps_before`` more
    steps, with cuDNN unless ``age_cudnn`` is False). Returns the two-epoch
    run's counts."""
    from nind_denoise_tpu_torch.models import get_network, params_io
    from nind_denoise_tpu_torch.train import gan, loop

    t0 = time.time()
    root, val = os.path.join(tmp, "train", "SYN_192_184"), os.path.join(tmp, "train", "val.yaml")
    if not os.path.isdir(root):
        write_train_crops(root, val, scenes=4, crops=16)
    n_val = 3
    cfg = os.path.join(ROOT, "nind_denoise_tpu_torch", "configs", "train_conf_utnet_std.yaml")
    (d1, _), (d2, _) = critics
    flags = ["--weight_D1", "0.2", "--d_lr", "1e-4", "--d_network", d1,
             "--weight_D2", "0.2", "--d2_lr", "1e-4", "--d2_network", d2]
    argv = ["--config", cfg, "--train_data", root, "--validation_set_yaml", val,
            "--test_reserve", "0", "--threads", "1", "--device", DEV, *extra, *flags]
    exp, launches = counted(torch, kernel_mods, lambda: cli_run(
        loop, argv + ["--epochs", "3", "--models_dpath", os.path.join(tmp, phase, "a")])[0])
    lines = batch_lines(exp)

    def learns_of(lns, w):
        return sum(f"loss {w}: " in ln for ln in lns)

    learns = {w: learns_of(lines, w) for w in ("D1", "D2")}
    g_steps = sum("loss G: " in ln for ln in lines)
    d_losses = {w: [float(v) for ln in lines for v in re.findall(rf"loss {w}: (\S+) \(", ln)]
                for w in learns}
    g_losses = [float(v) for ln in lines for v in re.findall(r"weighted: (\S+)", ln)]
    check(all(learns.values()) and g_steps > 0 and len(g_losses) == g_steps
          and all(math.isfinite(v) for v in d_losses["D1"] + d_losses["D2"] + g_losses),
          f"{phase}: losses {lines}")
    check(launches["enc1"] == sum(learns.values()) + n_val * 3
          and sum(launches.values()) == launches["enc1"],
          f"{phase}: launches {launches}, expected enc1 {learns} learns + {n_val * 3}")
    gck = highest(exp, "generator")
    cks = {"discriminator": (d1, "D1"), "discriminator2": (d2, "D2")}
    widths = dict(critics)
    trees = {name: params_io.load_npz(highest(exp, name)) for name in cks}
    for name, (net, w) in cks.items():
        sd = params_io.disc_state_dict_from_jax(net, trees[name]["params"], trees[name]["state"])
        cfg_d = get_network(net).config_of(sd)
        check(all(cfg_d[k] == v for k, v in widths[net].items())
              and int(trees[name]["opt"][0]) == learns[w],
              f"{phase}: {name} {cfg_d}, Adam count {trees[name]['opt'][0]} after {learns[w]}")
    last = params_io.load_npz(gck)["epoch"]

    resumed, resume_launches = counted(torch, kernel_mods, lambda: cli_run(
        loop, argv + ["--epochs", str(last + 2), "--g_model_path", gck,
                      "--d_model_path", highest(exp, "discriminator"),
                      "--d2_model_path", highest(exp, "discriminator2"),
                      "--models_dpath", os.path.join(tmp, phase, "b")])[0])
    r_lines = batch_lines(resumed)
    with open(os.path.join(resumed, "train.log")) as f:
        log = f.read()
    r_learns = {}
    for i, (name, (net, w)) in enumerate(cks.items()):
        r_learns[w] = learns_of(r_lines, w)
        new = params_io.load_npz(os.path.join(resumed, f"{name}_{last + 1}.npz"))
        old = trees[name]
        avg = float(re.search(rf"Discriminator{i + 1} average normalized loss: (\S+)",
                              log).group(1))
        sched = gan.ReduceLROnPlateau(old["sched"]["lr"], 0.75, patience=3)
        sched.best, sched.num_bad = old["sched"]["best"], old["sched"]["num_bad"]
        sched.step(avg)
        check(int(new["opt"][0]) == int(old["opt"][0]) + r_learns[w]
              and (new["sched"]["lr"], new["sched"]["best"], new["sched"]["num_bad"])
              == (sched.lr, sched.best, sched.num_bad),
              f"{phase} resume {name}: Adam count {new['opt'][0]} after {old['opt'][0]} + "
              f"{r_learns[w]}, scheduler {new['sched']} from {old['sched']} and {avg}")
    check(resume_launches["enc1"] == sum(r_learns.values()) + n_val * 2,
          f"{phase} resume: {resume_launches}, {r_learns} learns")
    cli_s = time.time() - t0

    clean, noisy = train_batch(torch, root, batch, cs)
    keyword, (network, _) = list(cks)[held], critics[held]
    dck = highest(exp, keyword)
    with cached_npz():
        t1 = time.time()
        times = gan_step_times(torch, gck, dck, clean, noisy, 32, reps=reps, network=network)
        t2 = time.time()
        cpu = gan_card_vs_cpu(torch, tmp, gck, dck, clean, noisy, 32, steps_before, network,
                              phase, n_pairs, age_cudnn)
    parts_s = {"cli": cli_s, "step_times": t2 - t1, "card_vs_cpu": time.time() - t2}
    emit(card, phase=phase, config="train_conf_utnet_std.yaml + " + " ".join(flags),
         batch=batch, cs=cs, validation_pairs=n_val, batches=len(lines), d_learns=learns,
         g_steps=g_steps, d_losses=d_losses, g_losses=g_losses, launches=launches,
         checkpoints=[os.path.basename(gck)] + [os.path.basename(highest(exp, n)) for n in cks],
         resumed_epoch=last + 1, resumed_d_learns=r_learns, resume_launches=resume_launches,
         parts_s=parts_s, step=times, card_vs_cpu=cpu, phase_s=time.time() - t0)
    return launches


K2_KERNELS = ("enc1_bf16_kernel", "enc1_f32_kernel")


def phase_trace(torch, card, tmp, kernel_mods, tif, ckpt):
    """``denoise_image_cli --trace_dir`` on the 6 MP TIFF in bf16: the
    Chrome trace written, K2's kernel named in it once per launch the run
    counted; the output bit-equal to the same run without the trace (run
    first; the card has run these shapes in the CLI phases); the wall of
    each. Returns the traced run's counts."""
    import glob

    import cv2

    from nind_denoise_tpu_torch.pipeline import denoise_image_cli

    t0 = time.time()
    d = os.path.join(tmp, "trace")
    os.makedirs(d)
    argv = ["-i", tif, "--network", "UtNet", "--model_path", ckpt, "--batch_size", "8"]
    plain_path, traced_path = os.path.join(d, "plain.tif"), os.path.join(d, "traced.tif")
    t1 = time.time()
    cli_run(denoise_image_cli, argv + ["-o", plain_path])
    plain_s = time.time() - t1
    t1 = time.time()
    _, launches = counted(torch, kernel_mods, lambda: cli_run(
        denoise_image_cli, argv + ["-o", traced_path, "--trace_dir", os.path.join(d, "trace")]))
    traced_s = time.time() - t1
    a, b = (cv2.imread(p, cv2.IMREAD_UNCHANGED) for p in (plain_path, traced_path))
    check(a is not None and a.shape == (*HW, 3) and str(a.dtype) == "uint16",
          f"trace: bad output {plain_path}")
    equal = bool((a == b).all())
    check(equal, "trace: the traced run's output differs from the plain run's")
    files = glob.glob(os.path.join(d, "trace", "*.pt.trace.json"))
    check(len(files) == 1, f"trace: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")
    k2 = {k: n for k, n in kernels.items() if any(name in k for name in K2_KERNELS)}
    check(launches["enc1"] == cli_batches(*HW) and sum(k2.values()) == launches["enc1"],
          f"trace: K2 launched {launches['enc1']} times, {k2} in the trace")
    emit(card, phase="trace", shape=[*HW, 3], compute_dtype="bfloat16", plain_wall_s=plain_s,
         traced_wall_s=traced_s, trace_bytes=os.path.getsize(files[0]), trace_events=len(events),
         kernel_events=sum(kernels.values()), k2_in_trace=k2, launches=launches,
         output_bit_equal=equal, top_kernels=dict(kernels.most_common(5)),
         phase_s=time.time() - t0)
    return launches


# -- the multi-device engines (phase 29) -------------------------------------------

PAR_DEVICES = None  # None: two distinct GPUs where there are two, else cuda:0 twice
PAR_HW2 = (1200, 1600)  # the int8_static and batch-engine crops, about 2 MP
POOL_SIZES = ((480, 480), (360, 640), (200, 300), (520, 700))  # 8 requests each
PAR_EVAL_HW = (512, 768)
TP_TOL = 1e-5
EVAL_2PROC_TOL = 1e-6
EVAL_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from nind_denoise_tpu_torch.eval import denoise_dir
from nind_denoise_tpu_torch.ops import deriche, enc1, gauss_blur, qconv, rl_fused
mods = dict(enc1=enc1, rl_iter=rl_fused, gauss_blur=gauss_blur, qconv=qconv, deriche=deriche)
overall = denoise_dir.main(sys.argv[2:])
print("RESULT " + json.dumps({"overall": overall,
                              "launches": {k: m.launches for k, m in mods.items()}}))
"""


def par_devices(torch):
    if PAR_DEVICES is not None:
        return [torch.device(d) for d in PAR_DEVICES], "as given"
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", 0), torch.device("cuda", 1)], "two distinct GPUs"
    return [torch.device("cuda", 0)] * 2, "cuda:0 twice: a rehearsal on one card"


def phase_parallel(torch, card, tmp, kernel_mods, tif, ckpt):
    """Phase 29 (see the module doc). Returns the launch counts by path."""
    import copy
    import shutil
    import socket
    import threading

    import numpy as np

    from nind_denoise_tpu_torch.core import imgio
    from nind_denoise_tpu_torch.core import tiles as tiles_mod
    from nind_denoise_tpu_torch.engine import tile_engine as te
    from nind_denoise_tpu_torch.eval import denoise_dir
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.ops import rl_deblur
    from nind_denoise_tpu_torch.ops.qconv import calib_from_image
    from nind_denoise_tpu_torch.parallel import (batch_engine, engine_pool, mesh, spatial,
                                                 tensor_parallel)

    t_phase = time.time()
    devs, how = par_devices(torch)
    d0 = devs[0]
    names = [str(d) for d in devs]
    model = params_io.load_generator(ckpt, "UtNet", "PReLU")
    raw, scale = imgio.load_img_raw(tif)
    by_path = {}

    def sync():
        for d in mesh.distinct(devs):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def timed(fn):
        """(result, warm wall s, device ms under the profiler) of ``fn``."""
        fn()
        sync()
        t0 = time.time()
        out = fn()
        sync()
        wall = time.time() - t0
        return out, wall, device_work(torch, fn)[0]

    def u8(out01):
        return rl_deblur.rl_to_u8_device(out01, 1.0, 10).cpu().numpy()

    def peak(d, fn):
        torch.cuda.reset_peak_memory_stats(d)
        fn()
        torch.cuda.synchronize(d)
        return torch.cuda.max_memory_allocated(d)

    # 1. row bands on the 6 MP TIFF against one engine
    sharded = te.make_sharded_denoiser("UtNet", model, devs, batch_size=8,
                                       compute_dtype="bfloat16")
    single = te.make_engine("UtNet", model, batch_size=8, compute_dtype="bfloat16", device=d0)
    ref, single_wall, single_ms = timed(lambda: single.denoise_raw(raw, scale))
    got, launches = counted(torch, kernel_mods, lambda: sharded.denoise_raw(raw, scale))
    _, wall, dev_ms = timed(lambda: sharded.denoise_raw(raw, scale))
    plan = single.plan_for(*raw.shape[:2])
    tpd, tpr = sharded.tiles_per_device, plan.iperhl + 1
    want = (plan.ipervl + 1) * math.ceil(tpr / tpd)
    check(launches["enc1"] == want and launches["rl_iter"] == 0,
          f"parallel sharded: launches {launches}, expected {want} K2")
    diff = float(np.abs(got - ref).max())
    tol = bf16_ulp(float(np.abs(ref).max()))
    check(diff <= tol, f"parallel sharded: canvas off one engine by {diff} > {tol}")
    q16 = [np.round(np.clip(a, 0, 1) * 65535).astype(np.int64) for a in (got, ref)]
    used = min(len(devs), plan.ipervl + 1)
    up = (plan.ipervl * plan.stride + 504 + (used - 1) * (504 - plan.stride)) \
        * raw.shape[1] * 3 * raw.itemsize
    down = (plan.grid_h + (used - 1) * plan.ol) * plan.grid_w * 3 * 4
    check((sharded.last_bytes_uploaded, sharded.last_bytes_downloaded) == (up, down),
          f"parallel sharded: bytes {sharded.last_bytes_uploaded}, "
          f"{sharded.last_bytes_downloaded}, JAX's formula {up}, {down}")
    emit(card, phase="parallel", case="sharded", devices=names, devices_are=how,
         shape=list(raw.shape), compute_dtype="bfloat16", tiles_per_device=tpd,
         launches=launches, max_abs_diff_vs_single=diff, tol=tol,
         max_lsb_uint16=int(np.abs(q16[0] - q16[1]).max()),
         share_equal_uint16=float((q16[0] == q16[1]).mean()),
         bytes_uploaded=up, bytes_downloaded=down, wall_s=wall, device_ms=dev_ms,
         single_wall_s=single_wall, single_device_ms=single_ms)
    by_path["parallel_sharded"] = launches

    # 2. int8_static through the row bands, on a 2 MP crop
    crop = np.ascontiguousarray(raw[:PAR_HW2[0], :PAR_HW2[1]])
    q = te.make_sharded_denoiser("UtNet", model, devs, batch_size=8,
                                 compute_dtype="int8_static",
                                 calib=calib_from_image(crop, scale=scale))
    f32 = te.make_engine("UtNet", model, batch_size=8, compute_dtype="float32",
                         precision="float32", device=d0)
    got_q, launches = counted(torch, kernel_mods,
                              lambda: u8(q.denoise_raw(crop, scale, "device")))
    db = psnr_u8(got_q, u8(f32.denoise_raw(crop, scale, "device")))
    cplan = f32.plan_for(*PAR_HW2)
    want = 21 * (cplan.ipervl + 1) * math.ceil((cplan.iperhl + 1) / tpd)
    check(launches["qconv"] == want and launches["rl_iter"] == 10,
          f"parallel int8_static: launches {launches}, expected {want} P1")
    check(db >= 42.0, f"parallel int8_static: PSNR {db:.2f} dB against float32 < 42")
    emit(card, phase="parallel", case="sharded_int8_static", devices=names,
         shape=[*PAR_HW2, 3], launches=launches, psnr_db_vs_float32=db, floor_db=42.0)
    by_path["parallel_int8_static"] = launches

    # 3. the batch engine: two same-shape crops, RL on each device
    crops = [crop, np.ascontiguousarray(raw[-PAR_HW2[0]:, -PAR_HW2[1]:])]
    check_fn = te.size_check("UtNet")
    batcher = batch_engine.DeviceBatchDenoiser([
        te.TileEngine(fn, 504, 480, batch_size=tpd, compute_dtype="bfloat16",
                      size_check=check_fn, device=d)
        for fn, d in zip(te.replicate_apply_fn("UtNet", model, "bfloat16", devs), devs)])
    one = te.make_engine("UtNet", model, batch_size=tpd, compute_dtype="bfloat16", device=d0)
    post = lambda i, out: u8(out)  # noqa: E731
    outs, launches = counted(torch, kernel_mods,
                             lambda: batcher.denoise_batch(crops, scale, post=post))
    refs, serial_wall, _ = timed(lambda: [u8(one.denoise_raw(c, scale, "device"))
                                          for c in crops])
    _, wall, _ = timed(lambda: batcher.denoise_batch(crops, scale, post=post))
    lsb = [max_lsb(o, r) for o, r in zip(outs, refs)]
    per_image = (cplan.ipervl + 1) * math.ceil((cplan.iperhl + 1) / tpd)
    check(launches["enc1"] == 2 * per_image and launches["rl_iter"] == 20,
          f"parallel batch: launches {launches}")
    check(max(lsb) <= 1, f"parallel batch: uint8 off engine + RL by {lsb} LSB")
    emit(card, phase="parallel", case="batch", devices=names, images=2,
         shape=[*PAR_HW2, 3], launches=launches, max_lsb_vs_engine_rl=lsb,
         wall_s=wall, serial_wall_s=serial_wall)
    by_path["parallel_batch"] = launches

    # 4. the pool: 32 requests of four sizes, two replicas against one
    rng = np.random.default_rng(29)
    reqs = [rng.integers(0, 65536, (*POOL_SIZES[i // 8], 3), dtype=np.uint16)
            for i in range(32)]

    def drive(pool):
        res = [None] * len(reqs)

        def post(engine, out01, meta):
            return u8(out01), meta["group"], meta["device"]

        def one_req(i):
            res[i] = pool.submit_denoise(reqs[i], 65535.0, post)

        threads = [threading.Thread(target=one_req, args=(i,)) for i in range(len(reqs))]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return res, time.time() - t0

    pools = {k: engine_pool.EnginePool("UtNet", model, d, batch_size=8,
                                       compute_dtype="bfloat16")
             for k, d in (("two", devs), ("one", devs[:1]))}
    try:
        for p in pools.values():
            drive(p)  # cold: cuDNN picks its algorithms for each shape
        (res, wall2), launches = counted(torch, kernel_mods, lambda: drive(pools["two"]))
        _, wall1 = drive(pools["one"])
        coalesced = pools["two"].coalesced
    finally:
        for p in pools.values():
            p.close()
    alone = te.AdaptiveEngine("UtNet", model, batch_size=8, compute_dtype="bfloat16",
                              device=d0)
    lsb = max(max_lsb(r[0], u8(alone.denoise_raw(x, 65535.0, "device")))
              for r, x in zip(res, reqs))
    groups = collections.Counter(r[1] for r in res)
    check(launches["rl_iter"] == 10 * len(reqs), f"parallel pool: launches {launches}")
    check(any(g > 1 for g in groups), f"parallel pool: no coalesced group ({groups})")
    check(lsb <= 1, f"parallel pool: uint8 off engine + RL by {lsb} LSB")
    emit(card, phase="parallel", case="pool", replicas=names, requests=len(reqs),
         sizes=[list(hw) for hw in POOL_SIZES], launches=launches,
         group_sizes={str(k): v for k, v in sorted(groups.items())},
         coalesced_requests=coalesced,
         per_replica=dict(collections.Counter(r[2] for r in res)),
         max_lsb_vs_engine_rl=lsb, req_per_s=len(reqs) / wall2,
         one_replica_req_per_s=len(reqs) / wall1)
    by_path["parallel_pool"] = launches

    # 5. the spatial forward at 6 MP with pad 8 against the whole forward
    img = imgio.load_img(tif)
    whole = te.make_engine("UtNet", model, compute_dtype="bfloat16", device=d0)
    with torch.inference_mode():
        whole_peak = peak(d0, lambda: whole.denoise_whole(img, pad=8))
        ref = whole.denoise_whole(img, pad=8)
    padded = tiles_mod.whole_image_pad(img, 8)
    nd = spatial.device_count(padded.shape[1], len(devs))
    fwd = spatial.SpatialShardedForward(
        te.replicate_apply_fn("UtNet", model, "bfloat16", devs[:nd]), devs[:nd],
        check_fn, torch.bfloat16)
    x, bands = fwd.prepare(padded.transpose(1, 2, 0))
    with torch.inference_mode():
        band_peaks = [peak(devs[i], lambda i=i: fwd.run_band(x, bands[i], i))
                      for i in range(len(bands))]
    y, launches = counted(torch, kernel_mods, lambda: fwd(padded.transpose(1, 2, 0)))
    got = y.transpose(2, 0, 1)[:, 8:-8, 8:-8]
    diff, tol = float(np.abs(got - ref).max()), bf16_ulp(float(np.abs(ref).max()))
    check(launches["enc1"] == len(bands), f"parallel spatial: launches {launches}")
    check(diff <= tol, f"parallel spatial: off the whole forward by {diff} > {tol}")
    check(max(band_peaks) < whole_peak,
          f"parallel spatial: band peaks {band_peaks} not below {whole_peak}")
    emit(card, phase="parallel", case="spatial", devices=names[:nd], shape=list(img.shape),
         pad=8, bands=bands, launches=launches, max_abs_diff_vs_whole=diff, tol=tol,
         band_peak_bytes=band_peaks, whole_peak_bytes=whole_peak)
    by_path["parallel_spatial"] = launches

    # 6. tensor parallel: 8 x 504^2 in fp32, TF32 off
    gen = torch.Generator(device=d0.type).manual_seed(41)
    xt = torch.rand(8, 3, 504, 504, device=d0, generator=gen)
    m32 = copy.deepcopy(model).to(d0).eval()
    tp = tensor_parallel.shard_params_tp(model, devs)
    with te._tf32(False), torch.inference_mode():
        ref = m32(xt)
        got, launches = counted(torch, kernel_mods, lambda: tensor_parallel.tp_forward(tp)(xt))
    rel = float((got - ref).abs().max() / ref.abs().max())
    check(launches["enc1"] == 1, f"parallel tp: launches {launches}")
    check(rel <= TP_TOL, f"parallel tp: {rel} relative off the single forward > {TP_TOL}")
    emit(card, phase="parallel", case="tensor_parallel", devices=names,
         batch=[8, 504, 504], dtype="float32",
         split_convs=sum(isinstance(m, tensor_parallel.TPConv) for m in tp.modules()),
         launches=launches, max_rel_err=rel, tol=TP_TOL)
    by_path["parallel_tp"] = launches
    del tp, m32, xt, got, ref

    # 7. eval.denoise_dir as two processes against one
    scenes = os.path.join(tmp, "par_scenes")
    write_scenes(scenes, PAR_EVAL_HW, seed=31, sets=("PA", "PB"))
    runs = {}
    for run in ("one", "two"):
        d = os.path.join(tmp, "par_eval", run, "model")
        os.makedirs(d)
        shutil.copy(ckpt, os.path.join(d, "generator_1.npz"))
        runs[run] = ["--model_path", os.path.join(d, "generator_1.npz"), "--noisy_dir",
                     scenes, "--network", "UtNet", "--devices", "1", "--device", DEV,
                     "--result_dir", os.path.join(tmp, "par_eval", run, "results")]
    ref = denoise_dir.main(runs["one"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", EVAL_CHILD, ROOT, *runs["two"]],
                              env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    two_wall = time.time() - t0
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr)
        check(p.returncode == 0, f"parallel eval: process {r} exited {p.returncode}")
    results = [json.loads(next(line for line in t.splitlines()
                               if line.startswith("RESULT "))[7:]) for t in texts]
    diffs = {k: abs(results[0]["overall"][k] - ref[k]) for k in ref}
    check(results[0]["overall"] == results[1]["overall"], "parallel eval: processes disagree")
    check(max(diffs.values()) <= EVAL_2PROC_TOL,
          f"parallel eval: two processes off one by {diffs} > {EVAL_2PROC_TOL}")
    launches = {k: sum(r["launches"][k] for r in results) for k in kernel_mods}
    check(launches["enc1"] > 0, f"parallel eval: launches {launches}")
    emit(card, phase="parallel", case="denoise_dir_two_processes", processes=2,
         scenes=2, images=6, shape=[*PAR_EVAL_HW, 3], launches=launches,
         max_abs_diff_set_means=diffs, tol=EVAL_2PROC_TOL, two_process_wall_s=two_wall)
    by_path["parallel_eval_2proc"] = launches
    emit(card, phase="parallel", case="summary", devices=names, devices_are=how,
         phase_s=time.time() - t_phase)
    return by_path


# -- data-parallel training ------------------------------------------------------

DP_DEV = "cuda:0"  # both ranks of the dp_train phase: two ranks on one card

# one rank of the dp_train phase: the trainer's command line (K2 counted as
# it launches, its first batched input kept for the check against the plain
# version); then, in the same group, the 30 crops scattered from rank 0
# (``DataParallel.batches``) and one cGAN batch on the rank's rows
# (``cgan_batch``: the critic's learn, then the generator step with the D1
# term; rank 0 keeps both steps' results), and CUDA-event times of warm
# generator steps and of the gradient all-reduce alone
DP_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as S
from nind_denoise_tpu_torch.ops import enc1
from nind_denoise_tpu_torch.parallel import data_parallel, mesh
from nind_denoise_tpu_torch.train import loop
k2_in, ckpt, dck, d_funit, batch, out, dev = sys.argv[2:9]
fn, seen = enc1.enc1, []
def spy(*args, **kw):
    if not seen and args[0].shape[0] > 1:
        seen.append([a.detach().cpu() for a in args])
    return fn(*args, **kw)
enc1.enc1 = spy
exp = loop.main(sys.argv[9:])
launches = enc1.launches
torch.save(seen[0] if seen else None, k2_in)

dp = data_parallel.start(mesh.rank_device(dev))
host = None
if dp.rank == 0:
    host = [tuple(t.permute(0, 2, 3, 1).numpy() for t in torch.load(batch))]
(clean, noisy), = list(dp.batches(host, lambda: False))
def replicas(m):
    data_parallel.convert_batch_norm(m)
    data_parallel.broadcast_module(m)
res = S.cgan_batch(torch, ckpt, dck, int(d_funit), dp.device, clean, noisy, replicas)
if dp.rank == 0:
    torch.save(res[:3], out)
state = res[4]
step_ms = S.time_ms(torch, res[3], 5)
reduce_ms = S.time_ms(torch, lambda: data_parallel.reduce_gradients(
    state.opt.params, {"w": torch.zeros((), device=dp.device)}), 10)
print("RESULT " + json.dumps({"experiment": exp, "enc1": launches, "backend": dp.backend,
                              "rows": len(clean), "step_ms": step_ms, "reduce_ms": reduce_ms,
                              "reduce_bytes": dp.reduce_bytes,
                              "digest": data_parallel.digest(res[5])}))
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(code, argvs, envs, timeout=300):
    """``python -c code argv`` once per entry, all at once; each one's
    RESULT line (a JSON object). Fails if any exits non-zero."""
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT, *a], env=e,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a, e in zip(argvs, envs)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr)
        check(p.returncode == 0, f"child {r} exited {p.returncode}")
    return [json.loads(next(line for line in t.splitlines() if line.startswith("RESULT "))[7:])
            for t in texts], time.time() - t0


def resumed_step(torch, ckpt, clean, noisy, lr):
    """One fp32 step on the card from ``ckpt`` resumed as the trainer
    resumes it: (loss, flat gradient, flat parameters, the step's closure)."""
    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.train import loop, steps

    tree = params_io.load_npz(ckpt)
    model = params_io.load_generator(ckpt).to(DEV).train()
    opt = steps.make_optimizer(model, lr, 0.75)
    loop.GeneratorWrapper.restore_opt(opt, model, tree["opt"], tree["params"])
    state = steps.TrainState(model, opt)
    step = steps.make_generator_train_step(steps.plain_apply, {"MSSSIM": 1}, clean.shape[-1])
    loss = float(step(state, clean, noisy)["weighted"])
    flat = [torch.cat([f(p).flatten().double().cpu() for p in model.parameters()])
            for f in (lambda p: p.grad, lambda p: p.detach())]
    return loss, flat[0], flat[1], lambda: step(state, clean, noisy)


def held_against(got, ref, lr):
    """Step ``got`` = (loss, gradient, parameters) held to ``ref`` at the
    train phase's tolerances: the record and whether it passes."""
    pd = (got[2] - ref[2]).abs()
    rec = {"loss_abs_diff": abs(got[0] - ref[0]),
           "grad_norm_rel_diff": ((got[1] - ref[1]).norm() / ref[1].norm()).item(),
           "param_max_abs_diff": pd.max().item(),
           "param_share_over_lr_1pct": (pd > lr / 100).double().mean().item(),
           "bit_equal": bool(got[2].equal(ref[2]))}
    ok = (rec["loss_abs_diff"] <= TRAIN_LOSS_TOL and rec["grad_norm_rel_diff"] <= TRAIN_GRAD_TOL
          and rec["param_max_abs_diff"] <= lr
          and rec["param_share_over_lr_1pct"] <= TRAIN_PARAM_SHARE)
    return rec, ok


def cgan_batch(torch, gck, dck, d_funit, dev, clean, noisy, convert=lambda m: None):
    """One cGAN batch on ``dev`` in which both networks learn, as the
    trainer runs it: the critic (Hul112Disc resumed from ``dck``) learns on
    the generator's forward (UtNet resumed from ``gck``) with seeded
    targets (fake targets not noisy: a fresh wrapper's loss is 1), then the
    generator steps with the D1 term of a second copy of the critic.
    ``convert`` goes over each critic's module first (a DP rank's global
    BatchNorm and broadcast). Returns the critic's step as
    ``disc_step_on``'s tuple, its scalar loss, the generator's (metrics,
    gradient, parameters), the generator step's closure, its state, and
    the modules that learned."""
    import types

    from nind_denoise_tpu_torch.train import steps

    state = resumed_generator(torch, gck, dev)
    disc, fool = (disc_wrapper(dck, d_funit, dev) for _ in range(2))
    for d in (disc, fool):
        convert(d.model)
    took, grads = [], []
    d_step, opt_step = disc._step, disc.optimizer.step

    def spy_step(*a, **k):
        took.append(d_step(*a, **k))
        return took[-1]

    def spy_opt():  # the summed (in DP, reduced) gradients, freed after the update
        grads.extend(p.grad.detach().cpu().double() for p in disc.optimizer.params)
        return opt_step()

    disc._step, disc.optimizer.step = spy_step, spy_opt
    cs = clean.shape[-1]
    disc.learn(clean, noisy, types.SimpleNamespace(
        infer=infer_fn(torch, steps.plain_apply, state.model)), cs,
        generator=torch.Generator(dev).manual_seed(11))
    disc._step, disc.optimizer.step = d_step, opt_step
    (loss_real, loss_fake, ranges), = took
    d = (float(loss_real), float(loss_fake), ranges.tolist(),
         {k: v.detach().cpu().double() for k, v in disc.model.state_dict().items()}, grads)
    gstep = steps.make_generator_train_step(steps.plain_apply, GAN_WEIGHTS, cs,
                                            disc_fns=(fool.pred_fn, None))
    m = gstep(state, clean, noisy)
    flat = [torch.cat([f(p).flatten().double().cpu() for p in state.model.parameters()])
            for f in (lambda p: p.grad, lambda p: p.detach())]
    return (d, disc.loss, ({k: float(v) for k, v in m.items()}, *flat),
            lambda: gstep(state, clean, noisy), state, [state.model, disc.model])


def phase_dp_train(torch, card, tmp, kernel_mods, batch=30, cs=184, lr=1e-4, d_funit=32,
                   extra=()):
    """Phase 30 (see the module doc). Returns the two ranks' launch counts.
    ``DP_DEV`` is both ranks' device; ``extra`` goes to the trainer. The
    held cGAN batch's critic is the gan phase's, aged ``GAN_DISC_STEPS``
    steps (d_funit ``d_funit``)."""
    import glob

    import torch.distributed as dist

    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.parallel import data_parallel, mesh

    t0 = time.time()
    root, val = os.path.join(tmp, "train", "SYN_192_184"), os.path.join(tmp, "train", "val.yaml")
    (exp,) = glob.glob(os.path.join(tmp, "train", "models", "*"))
    ckpt = highest(exp, "generator")
    dck = os.path.join(tmp, "gan", "held", f"discriminator_{GAN_DISC_STEPS}.npz")
    last = params_io.load_npz(ckpt)["epoch"]
    work = os.path.join(tmp, "dp")
    os.makedirs(work)
    clean, noisy = train_batch(torch, root, batch, cs)
    bpath, held = os.path.join(work, "batch.pt"), os.path.join(work, "held.pt")
    torch.save((clean, noisy), bpath)
    cfg = os.path.join(ROOT, "nind_denoise_tpu_torch", "configs", "train_conf_utnet_std.yaml")
    argv = ["--config", cfg, "--train_data", root, "--validation_set_yaml", val,
            "--test_reserve", "0", "--threads", "1", "--device", DP_DEV,
            "--weight_D1", "0.2", "--d_lr", "1e-4", "--g_model_path", ckpt,
            "--epochs", str(last + 2), "--models_dpath", os.path.join(work, "models"), *extra]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    k2_in = [os.path.join(work, f"k2_rank{r}.pt") for r in range(2)]

    # 1. two ranks on one card (gloo): one epoch of the cGAN through the
    # trainer's command line, then the held cGAN batch and the times
    ranks, ranks_s = run_children(
        DP_CHILD, [[k2_in[r], ckpt, dck, str(d_funit), bpath, held, DP_DEV, *argv]
                   for r in range(2)],
        [dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)])
    exps = [r["experiment"] for r in ranks]
    check(os.path.basename(exps[1]) == os.path.basename(exps[0])[:249] + "_rank1",
          f"dp_train: experiments {exps}")
    logs = []
    for e in exps:
        with open(os.path.join(e, "train.log")) as f:
            logs.append(f.read())
    for r, text in enumerate(logs):
        check(text.startswith(f"Data-parallel over 2 processes on gloo: rank {r} on {DP_DEV}, "
                              f"{batch // 2} of each batch's {batch} rows"),
              f"dp_train: rank {r}'s first line {text.splitlines()[0]}")
    digests = [re.findall(r"Data-parallel replica digest: (\w+)", t) for t in logs]
    check(len(digests[0]) == 1 and digests[0] == digests[1],
          f"dp_train: the ranks' replicas differ: {digests}")
    check(ranks[0]["digest"] == ranks[1]["digest"],
          f"dp_train: the ranks' replicas differ after the held batch: {ranks}")
    lines = [[ln for ln in t.splitlines() if re.match(r"Epoch \d+ batch \d+/", ln)]
             for t in logs]
    learns = sum("loss D1: " in ln for ln in lines[0])
    check(lines[0] == lines[1] and learns > 0,
          f"dp_train: the ranks' batches differ or no discriminator step: {lines}")
    n_val = 3
    k2 = [r["enc1"] for r in ranks]
    check(k2 == [learns + n_val * 2, learns],
          f"dp_train: K2 launches {k2}, expected {learns} learns a rank and "
          f"{n_val} x 2 validations on rank 0")
    check(not [f for f in os.listdir(exps[1]) if f.endswith(".npz")]
          and os.path.exists(os.path.join(exps[0], f"generator_{last + 1}.npz")),
          f"dp_train: checkpoints {os.listdir(exps[0])} / {os.listdir(exps[1])}")
    args = torch.load(k2_in[0])
    check(args is not None and args[0].shape[0] == batch // 2, f"dp_train: K2 input {args}")
    with torch.inference_mode():
        k2_rec = enc1_record(torch, E, [a.to(DEV) for a in args], 10)
    check(k2_rec["max_abs_err"] == 0, f"dp_train: K2 fp32 not bit-equal: {k2_rec}")

    # 2. the DP cGAN batch against one process's on the same 30 crops, at
    # the gan phase's tolerances
    (dp_d, dp_dloss, dp_g) = torch.load(held)
    cd, nd = clean.to(DEV), noisy.to(DEV)
    one = cgan_batch(torch, ckpt, dck, d_funit, DEV, cd, nd)
    (ref_d, ref_dloss, ref_g), one_step = one[:3], one[3]
    d_rec = dict(step_vs([dp_d], [ref_d]), d_loss_abs_diff=abs(dp_dloss - ref_dloss),
                 ranges_max_abs_diff=max(abs(a - b) for a, b in zip(dp_d[2], ref_d[2])),
                 d_loss_one_process=ref_dloss, d_loss_dp=dp_dloss)
    check(d_rec["loss_abs_diff"] <= GAN_LOSS_TOL and d_rec["d_loss_abs_diff"] <= GAN_LOSS_TOL
          and d_rec["ranges_max_abs_diff"] <= GAN_LOSS_TOL
          and d_rec["bn_stat_rel_diff"] <= GAN_BN_TOL and d_rec["param_max_abs_diff"] <= 1e-4
          and d_rec["param_share_over_lr_1pct"] <= TRAIN_PARAM_SHARE,
          f"dp_train: the DP critic's learn against one process {d_rec}")
    g_rec, ok = held_against((dp_g[0]["weighted"], *dp_g[1:]), (ref_g[0]["weighted"], *ref_g[1:]),
                             lr)
    g_rec.update(metrics_dp=dp_g[0], metrics_one_process=ref_g[0],
                 metrics_max_abs_diff=max(abs(dp_g[0][k] - v) for k, v in ref_g[0].items()))
    check(ok and set(dp_g[0]) == set(ref_g[0]) and "D1" in ref_g[0]
          and g_rec["metrics_max_abs_diff"] <= GAN_LOSS_TOL,
          f"dp_train: the DP generator step with D1 against one process {g_rec}")
    one_ms = time_ms(torch, one_step, 5)
    del one, one_step

    # 3. a one-rank nccl group in this process: the DP step at 15 rows against
    # the plain step, and the gradient reducer on the card
    t1 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        torch.cuda.set_device(0)
        dp = data_parallel.start(torch.device("cuda", 0))
        check(dp.backend == "nccl", f"dp_train: one-rank group on {dp.backend}")
        got = resumed_step(torch, ckpt, cd[:batch // 2], nd[:batch // 2], lr)
        data_parallel.stop()
        plain = resumed_step(torch, ckpt, cd[:batch // 2], nd[:batch // 2], lr)
        nccl_step, ok = held_against(got[:3], plain, lr)
        check(ok, f"dp_train: the one-rank nccl step against the plain step {nccl_step}")
        dp = data_parallel.start(torch.device("cuda", 0))
        model = params_io.load_generator(ckpt).to(DEV)
        params = list(model.parameters())
        for p in params:
            p.grad = torch.randn_like(p)
        before = [p.grad.clone() for p in params]
        w = torch.tensor(0.5, device=DEV)
        out = data_parallel.reduce_gradients(params, {"w": w})
        check(all(torch.equal(p.grad, b) for p, b in zip(params, before))
              and float(out["w"]) == 0.5, "dp_train: a one-rank reduce changed the gradients")
        nccl_ms = time_ms(torch, lambda: data_parallel.reduce_gradients(params, {"w": w}), 20)
        nccl_bytes = dp.reduce_bytes
        # the reducer's parts, each timed alone on the same buffer
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        pieces = [v.view_as(g) for g, v in zip(grads, flat.split([g.numel() for g in grads]))]
        nccl_parts = {
            "cat": time_ms(torch, lambda: torch.cat([g.reshape(-1) for g in grads]), 20),
            "all_reduce_": time_ms(torch, lambda: mesh.all_reduce_(flat, "sum", dp.group), 20),
            "div_": time_ms(torch, lambda: flat.div_(1.0), 20),
            "copy_back": time_ms(torch, lambda: torch._foreach_copy_(grads, pieces), 20)}
        # cat, div_ and the copy back each read and write the buffer once
        nccl_bound = 6 * nccl_bytes / PEAK_BYTES * 1e3
    finally:
        data_parallel.stop()
        dist.destroy_process_group()
    del model, params, before, cd, nd, grads, flat, pieces
    launches = {name: 0 for name in kernel_mods}
    launches["enc1"] = sum(k2)
    emit(card, phase="dp_train", devices="cuda:0 twice: a rehearsal on one card, not a "
         "scaling figure", backend="gloo", config="train_conf_utnet_std.yaml + --weight_D1 0.2",
         batch=batch, rows_a_rank=batch // 2, cs=cs, resumed_from=os.path.basename(ckpt),
         epoch=last + 1, batches=len(lines[0]), d_learns=learns, enc1_launches_by_rank=k2,
         replica_digests_equal=True, ranks_s=ranks_s, enc1_input=list(args[0].shape),
         enc1_fp32=k2_rec, held_disc_learn=d_rec, held_gen_step_with_d1=g_rec,
         held_critic=f"{os.path.relpath(dck, tmp)}, d_funit {d_funit}",
         tolerance={"gen": {"loss": TRAIN_LOSS_TOL, "grad_norm_rel": TRAIN_GRAD_TOL,
                            "param_max": lr, "param_share_over_lr_1pct": TRAIN_PARAM_SHARE,
                            "metrics": GAN_LOSS_TOL},
                    "disc": {"losses_d_loss_ranges": GAN_LOSS_TOL, "bn_stat_rel": GAN_BN_TOL,
                             "param_max": 1e-4, "param_share_over_lr_1pct": TRAIN_PARAM_SHARE}},
         gen_step_d1_ms_a_rank=[r["step_ms"] for r in ranks],
         gen_step_d1_ms_one_process=one_ms,
         allreduce_gloo={"bytes": ranks[0]["reduce_bytes"],
                         "ms": [r["reduce_ms"] for r in ranks]},
         nccl_one_rank={"step_vs_plain": nccl_step, "allreduce_bytes": nccl_bytes,
                        "allreduce_ms": nccl_ms, "allreduce_parts_ms": nccl_parts,
                        "allreduce_bound_ms": nccl_bound, "s": time.time() - t1},
         phase_s=time.time() - t0)
    return launches


# -- the trainer's whole-image test sharded over data-parallel ranks ----------------

DP_TEST_WEIGHTS = {"MSSSIM": 1.0, "MSE": 1.0}  # the test's loss, both terms
DP_TEST_LOSS_TOL = 1e-5  # sharded against rank 0's unsharded test loss (the CPU tests' bar)
DP_TEST_IMAGE_TOL = 1e-4  # the gathered image against the whole forward, fp32 without TF32
DP_TEST_UTNET_HW = (2008, 3000)  # 6 MP, a size UtNet takes (8 mod 16 both ways)

# one rank of the dp_test phase: a two-rank group (torchrun's variables), the
# trainer's ``test_generator`` on the 24 MP NIND-shaped pair with UNet (each
# rank its band), then rank 0's whole forward of the same test alone; the
# same with UtNet funit 64 on a 6 MP pair (K2 counted around the sharded
# test, its band input kept for the check against the plain version). Each
# generator forward's peak memory above what was allocated before it, and
# its seconds (first calls at their shapes: cold).
DP_TEST_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
import chip_smoke as S
from nind_denoise_tpu_torch.core import imgio
from nind_denoise_tpu_torch.ops import enc1
from nind_denoise_tpu_torch.parallel import data_parallel, mesh
from nind_denoise_tpu_torch.train import dataset, loop
scenes, unet_ck, utnet_ck, pair, k2_in, dev = sys.argv[2:8]
mesh.init_distributed()
dp = data_parallel.start(mesh.rank_device(dev))
fn, seen, bands, kept = enc1.enc1, [], [], []
def spy(*args, **kw):
    if not seen:
        seen.append([a.detach().cpu() for a in args])
    return fn(*args, **kw)
enc1.enc1 = spy
run_band, gather = loop.spatial.run_rank_band, mesh.gather_rows
def spy_band(forward, x, band):
    bands.append([*band, x.shape[2]])
    return run_band(forward, x, band)
def spy_gather(*a, **k):
    kept.append(gather(*a, **k))
    return kept[-1]
loop.spatial.run_rank_band, mesh.gather_rows = spy_band, spy_gather
def run(gen, test_set, sharded):
    peaks, secs, outs, infer = [], [], [], gen.infer
    def measured(x):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        y = infer(x)
        torch.cuda.synchronize()
        secs.append(time.time() - t)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        outs.append(y)
        return y
    gen.infer = measured
    bands.clear()
    kept.clear()
    enc1.launches = 0
    t0 = time.time()
    if sharded:
        loss = loop.test_generator(gen, test_set, dp=dp)
    else:
        with data_parallel.local():
            loss = loop.test_generator(gen, test_set)
    torch.cuda.synchronize()
    gen.infer = infer
    image = kept[0] if sharded else outs[0]
    return ({"loss": loss, "s": time.time() - t0, "forward_peak_bytes": peaks,
             "forward_s": secs, "bands": list(bands), "enc1": enc1.launches}, image)
def alone(f):  # rank 0 alone, while the other ranks wait with an empty cache
    torch.cuda.empty_cache()
    dist.barrier()
    out = f() if dp.rank == 0 else (None, None)
    torch.cuda.empty_cache()
    dist.barrier()
    return out
rec = {"backend": dp.backend, "rank": dp.rank}
for name, ck, sets in (("unet", unet_ck, dataset.TestDenoiseDataset(scenes, ["TS"])),
                       ("utnet", utnet_ck, [tuple(imgio.load_img(p) for p in pair.split(","))])):
    gen = S.trainer_gen(ck, "UNet" if name == "unet" else "UtNet", dp.device, S.DP_TEST_WEIGHTS)
    data_parallel.convert_batch_norm(gen.state.model)
    before = data_parallel.digest([gen.state.model])
    rec[name], sharded = run(gen, sets, True)
    if name == "utnet":
        torch.save(seen[0] if seen else None, k2_in)
    rec[name]["state_unchanged"] = data_parallel.digest([gen.state.model]) == before
    rec[name]["digest"] = before
    rec[name + "_whole"], whole = alone(lambda: run(gen, sets, False))
    if dp.rank == 0:
        rec[name]["image_max_abs_diff"] = (sharded.clamp(0, 1) - whole.clamp(0, 1)).abs().max().item()
    del gen, sharded, whole
print("RESULT " + json.dumps(rec))
"""


def trainer_gen(ckpt, network, device, weights):
    """The trainer's generator as ``train.loop.test_generator`` reads it:
    the model of ``ckpt`` on ``device`` in train mode, its forward
    (``GeneratorWrapper.infer``: no TF32, a UNet's batch statistics with
    the running stats untouched), the loss weights."""
    import types

    import torch

    from nind_denoise_tpu_torch.models import params_io
    from nind_denoise_tpu_torch.train import loop, steps

    model = params_io.load_generator(ckpt, network).to(device).train()
    gen = types.SimpleNamespace(network=network, device=torch.device(device),
                                weights=steps.normalize_weights(weights),
                                apply_fn=steps.plain_apply,
                                state=types.SimpleNamespace(model=model))
    gen.infer = types.MethodType(loop.GeneratorWrapper.infer, gen)
    return gen


def phase_dp_test(torch, card, tmp, kernel_mods, utnet_ckpt, big_hw=BIG_HW,
                  utnet_hw=DP_TEST_UTNET_HW):
    """Phase 31 (see the module doc). Returns the two ranks' launch counts
    on the sharded UtNet test. The pairs are uncompressed 16-bit TIFFs
    (NIND's scenes are PNGs; the same pixels, decoded faster). This process
    first returns its cached device memory: the two ranks' UNet bands and
    rank 0's whole forward need about 46 and 42 GB of the card."""
    import gc

    from nind_denoise_tpu_torch.ops import enc1 as E
    from nind_denoise_tpu_torch.parallel import spatial
    from nind_denoise_tpu_torch.tools import fixtures

    t0 = time.time()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parent_bytes = {"allocated": torch.cuda.memory_allocated(),
                    "reserved": torch.cuda.memory_reserved()}
    work = os.path.join(tmp, "dp_test")
    scenes, pair_root = os.path.join(work, "NIND"), os.path.join(work, "pair")
    os.makedirs(work)
    write_scenes(scenes, big_hw, seed=23, sets=("TS",),
                 isos=(SCENE_ISOS[0], SCENE_ISOS[-1]), ext=".tif")
    pair = write_scenes(pair_root, utnet_hw, seed=29, sets=("TU",),
                        isos=(SCENE_ISOS[0], SCENE_ISOS[-1]), ext=".tif")
    unet_ck = os.path.join(work, "unet.npz")
    fixtures.write_unet_checkpoint(unet_ck, 3)
    k2_in = [os.path.join(work, f"k2_rank{r}.pt") for r in range(2)]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    ranks, ranks_s = run_children(
        DP_TEST_CHILD, [[scenes, unet_ck, utnet_ckpt, ",".join(pair), k2_in[r], DP_DEV]
                        for r in range(2)],
        [dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)])
    check([r["backend"] for r in ranks] == ["gloo", "gloo"], f"dp_test: backends {ranks}")
    recs = {}
    for name, hw, network in (("unet", (big_hw[0] // 64 * 64, big_hw[1] // 64 * 64), "UNet"),
                              ("utnet", utnet_hw, "UtNet")):
        want = spatial.rank_bands(*hw, 2, network)
        sharded, whole = [r[name] for r in ranks], ranks[0][name + "_whole"]
        got = [tuple(r["bands"][0][:4]) for r in sharded]
        check(want is not None and all(len(r["bands"]) == 1 for r in sharded)
              and got == [tuple(b) for b in want]
              and all(r["bands"][0][4] == r["bands"][0][1] - r["bands"][0][0] < hw[0]
                      for r in sharded), f"dp_test {name}: bands {got}, expected {want}")
        check(whole["bands"] == [] and len(whole["forward_peak_bytes"]) == 1,
              f"dp_test {name}: the unsharded test {whole}")
        losses = [r["loss"] for r in sharded]
        diff = abs(losses[0] - whole["loss"])
        check(losses[0] == losses[1] and diff <= DP_TEST_LOSS_TOL,
              f"dp_test {name}: sharded losses {losses} against {whole['loss']}")
        check(all(r["state_unchanged"] for r in sharded)
              and sharded[0]["digest"] == sharded[1]["digest"],
              f"dp_test {name}: replicas changed or differ")
        img_diff = sharded[0]["image_max_abs_diff"]
        check(img_diff <= DP_TEST_IMAGE_TOL,
              f"dp_test {name}: gathered image off the whole forward by {img_diff}")
        peaks = [r["forward_peak_bytes"][0] for r in sharded]
        whole_peak = whole["forward_peak_bytes"][0]
        check(all(p < whole_peak for p in peaks),
              f"dp_test {name}: band peaks {peaks} not below the whole forward's {whole_peak}")
        recs[name] = {
            "network": network, "image": list(hw), "bands": got,
            "band_rows_over_height": [(e - s) / hw[0] for s, e, _, _ in got],
            "loss_sharded": losses[0], "loss_unsharded": whole["loss"], "loss_abs_diff": diff,
            "image_max_abs_diff": img_diff,
            "band_forward_peak_bytes": peaks, "whole_forward_peak_bytes": whole_peak,
            "band_peak_over_whole": [p / whole_peak for p in peaks],
            "test_s_sharded": [r["s"] for r in sharded], "test_s_unsharded": whole["s"],
            "forward_s_sharded": [r["forward_s"][0] for r in sharded],
            "forward_s_unsharded": whole["forward_s"][0]}
    k2 = [r["utnet"]["enc1"] for r in ranks]
    check(k2 == [1, 1], f"dp_test: K2 launches {k2} on the sharded UtNet test, expected 1 a rank")
    k2_recs = []
    for r, path in enumerate(k2_in):
        args = torch.load(path)
        s, e = ranks[r]["utnet"]["bands"][0][:2]
        check(args is not None and list(args[0].shape) == [1, 3, e - s + 4, utnet_hw[1] + 4]
              and args[0].dtype == torch.float32, f"dp_test: rank {r}'s K2 input {args}")
        with torch.inference_mode():
            k2_recs.append(enc1_record(torch, E, [a.to(DEV) for a in args], 10))
        check(k2_recs[-1]["max_abs_err"] == 0,
              f"dp_test: K2 fp32 not bit-equal at the band shape: {k2_recs[-1]}")
    launches = {name: 0 for name in kernel_mods}
    launches["enc1"] = sum(k2)
    emit(card, phase="dp_test", devices="cuda:0 twice: a rehearsal on one card, not a "
         "scaling figure", backend="gloo", weights=DP_TEST_WEIGHTS, unet=recs["unet"],
         utnet=dict(recs["utnet"], funit=64, enc1_launches_by_rank=k2, enc1_fp32=k2_recs),
         tolerance={"loss": DP_TEST_LOSS_TOL, "image": DP_TEST_IMAGE_TOL, "enc1": 0},
         this_process_device_bytes=parent_bytes, ranks_s=ranks_s, phase_s=time.time() - t0)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    try:
        from nind_denoise_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port is not next to this script: {e}")
    card = card_line()

    t0 = time.time()
    _build.build_all()
    emit(card, phase="build", seconds=time.time() - t0, sources=_build.sources())

    from nind_denoise_tpu_torch.ops import deriche, enc1, gauss_blur, qconv, rl_fused

    kernel_mods = {"enc1": enc1, "rl_iter": rl_fused, "gauss_blur": gauss_blur,
                   "qconv": qconv, "deriche": deriche}
    enc1_rec = phase_enc1(torch, card)
    rl_rec = phase_rl(torch, card)
    blur_rec = phase_gauss_blur(torch, card)
    qconv_rec = phase_qconv(torch, card)
    deriche_rec = phase_deriche(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        e2e, e2e_out = phase_end_to_end(torch, card, tmp, kernel_mods)
        by_path = {"denoise_cli": e2e}
        # phase_end_to_end's 6 MP TIFF and checkpoint
        tif, ckpt = os.path.join(tmp, "img.tif"), os.path.join(tmp, "generator_1.npz")
        # the NIND tree the dataset_tools and eval phases read, downloaded here
        scenes = os.path.join(tmp, "NIND")
        by_path["fetch"] = phase_fetch(torch, card, tmp, kernel_mods, tif, ckpt, e2e_out,
                                       scenes, HW)
        by_path["serve"], serve_inputs, model = phase_serve(torch, card, tmp, kernel_mods)
        by_path["cli_plugin"] = phase_cli_plugin(torch, card, tmp, kernel_mods, tif)
        by_path["cli_raw"] = phase_cli_raw(torch, card, tmp, kernel_mods, ckpt)
        by_path["cli_dir"] = phase_cli_dir(torch, card, tmp, kernel_mods, ckpt)
        by_path["whole_image"] = phase_whole_image(torch, card, tmp, kernel_mods, ckpt, tif)
        by_path.update(phase_int8(torch, card, tmp, kernel_mods, tif, ckpt))
        by_path["int8_static_serve"] = phase_int8_serve(torch, card, tmp, kernel_mods, ckpt)
        by_path.update(phase_rl_variants(torch, card, tmp, kernel_mods, tif, ckpt))
        by_path["train"] = phase_train(torch, card, tmp, kernel_mods)
        by_path["gan"], by_path["gan_device_cache"] = phase_gan(torch, card, tmp, kernel_mods)
        by_path["dataset_tools"] = phase_dataset_tools(torch, card, tmp, kernel_mods, scenes, HW)
        by_path["eval"] = phase_eval(torch, card, tmp, kernel_mods, scenes, ckpt, HW)
        by_path["unet_cli"] = phase_unet_cli(torch, card, tmp, kernel_mods, tif)
        by_path["unet_train"] = phase_unet_train(torch, card, tmp, kernel_mods)
        by_path["hul_gen_train"] = phase_hul_gen_train(torch, card, tmp, kernel_mods)
        phase_zoo(torch, card)
        by_path["zoo_gan"] = phase_zoo_gan(torch, card, tmp, kernel_mods)
        phase_relics(torch, card)
        by_path["relic_gan"] = phase_zoo_gan(torch, card, tmp, kernel_mods, phase="relic_gan",
                                             **RELIC_GAN)
        by_path["trace"] = phase_trace(torch, card, tmp, kernel_mods, tif, ckpt)
        by_path.update(phase_parallel(torch, card, tmp, kernel_mods, tif, ckpt))
        by_path["dp_train"] = phase_dp_train(torch, card, tmp, kernel_mods)
        by_path["dp_test"] = phase_dp_test(torch, card, tmp, kernel_mods, ckpt)
    phase_serve_kernels(torch, card, serve_inputs, model)

    def row(name, source, replaces, rec):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {k: p[name] for k, p in by_path.items()},
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "ms_over_bound": rec["ms"] / rec["bound_ms"],
                "library_ms": rec.get("library_ms")}

    print(json.dumps({"kernels": [
        row("enc1", "nind_denoise_tpu_torch/csrc/enc1.cu",
            "nind_denoise_tpu/ops/pallas_enc1.py:262", enc1_rec),
        row("rl_iter", "nind_denoise_tpu_torch/csrc/rl_iter.cu",
            "nind_denoise_tpu/ops/pallas_blur.py:621", rl_rec),
        row("gauss_blur", "nind_denoise_tpu_torch/csrc/gauss_blur.cu",
            "nind_denoise_tpu/ops/pallas_blur.py:217", blur_rec),
        # the port's own kernels: no Pallas counterpart, they replace XLA ops
        row("qconv", "nind_denoise_tpu_torch/csrc/qconv.cu",
            "nind_denoise_tpu/ops/qconv.py:227 (XLA int8 conv, no Pallas kernel)", qconv_rec),
        row("deriche", "nind_denoise_tpu_torch/csrc/deriche.cu",
            "nind_denoise_tpu/ops/rl_deblur.py:132 (lax.scan, no Pallas kernel)", deriche_rec),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
