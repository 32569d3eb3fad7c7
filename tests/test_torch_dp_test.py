"""The trainer's whole-image test sharded over data-parallel ranks
(``train/loop.test_generator``, ``parallel/spatial.rank_bands`` /
``run_rank_band``, ``data_parallel.owned_rows``, ``mesh.gather_rows``) on
the CPU: ``gloo`` ranks at 127.0.0.1, run as subprocesses of the port only
(``tests/_torch_dp_child.py wholetest`` and ``loop``), two torch threads
each.

Against JAX's ``loop.test_generator`` on the conftest's eight CPU devices,
which shards H over its mesh (``SpatialShardedForward``, counted here) when
eight divides the height, from one JAX checkpoint:

* UNet (default widths) on a 640 x 64 pair: two bands, inputs ``[0, 512)``
  and ``[128, 640)``; its train-mode BatchNorm takes the statistics of the
  whole image in both packages. The two ranks' loss within ``LOSS_TOL``
  (1e-5, the data-parallel test's loss bar) of JAX's; the gathered image
  within ``IMAGE_TOL`` of the port's one-process forward (torch sums the
  statistics in another order: 3e-6 seen); the running stats untouched and
  the replicas' digests equal. Two planted faults each put the loss
  outside ``LOSS_TOL``: the halo rows counted in the statistics, and each
  band normalized by its own rows.
* UtNet funit 8 at 520 x 136 (a size it takes; 2 and 8 divide 520) and
  Hulb128Net funit 2 at 704 x 128 (704 and 128 are sizes it takes, and JAX's
  test runs there): the loss against JAX's at ``LOSS_TOL``.
* Rank 0's whole forward where the test is not sharded (three ranks and a
  height three does not divide; an image too short for two bands): no band
  forwarded, the loss bit-equal to one process's.
* The trainer's command line, UNet with ``--test_interval 1`` as two ranks
  against one process: ``trainres.json``'s ``test_loss`` within
  ``LOSS_TOL``, the chief's test image within one 16-bit step.

The Hul generators' halo is measured as ``spatial.HALO`` was: in float64 at
random weights, the kept rows equal the whole forward at ``HUL_HALO`` and
not one step (9 rows) below it.
"""

import json
import os
import socket
import subprocess
import sys
import types

import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.ndimage import gaussian_filter

import jax

from nind_denoise_tpu.models.hul_gen import Hulb128Net as JaxHulb128Net
from nind_denoise_tpu.models.unet import UNet as JaxUNet
from nind_denoise_tpu.models.utnet import UtNet as JaxUtNet
from nind_denoise_tpu.parallel import spatial as jax_spatial
from nind_denoise_tpu.train import loop as jax_loop
from nind_denoise_tpu.train import steps as jax_steps
from nind_denoise_tpu_torch.core import imgio
from nind_denoise_tpu_torch.models.hul_gen import Hulb128Net, Hulbs128Net
from nind_denoise_tpu_torch.models import params_io
from nind_denoise_tpu_torch.parallel import data_parallel, mesh, spatial
from nind_denoise_tpu_torch.tools import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_dp_child.py")
CHILD_TIMEOUT = 240
LOSS_TOL = 1e-5  # tests/test_torch_train_dp.py's loss bar
IMAGE_TOL = 1e-5  # the gathered image against one process's forward
WEIGHTS = {"MSE": 1.0, "L1": 0.5}
CASES = {"unet": ("UNet", (640, 64)), "utnet": ("UtNet", (520, 136)),
         "hul": ("Hulb128Net", (704, 128)), "short": ("UNet", (64, 64))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2")
    return env


def _start(argvs):
    return [subprocess.Popen(a, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for a in argvs]


def _wait(procs):
    """The processes' outputs, once all have exited (each must exit 0)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


def _pair(rng, h, w):
    """A seeded smooth (clean, noisy) CHW pair with a vertical ramp, so that
    a band's statistics are not the image's."""
    c = gaussian_filter(rng.random((3, h, w)), (0, 3, 3))
    c = (c - c.min()) / np.ptp(c)
    c = 0.15 + 0.7 * (0.6 * c + 0.4 * np.linspace(0, 1, h)[None, :, None])
    n = np.clip(c + rng.normal(0, 0.05, c.shape), 0, 1)
    return c.astype(np.float32), n.astype(np.float32)


def _checkpoints(tmp):
    paths = {"UNet": str(tmp / "unet.npz"), "UtNet": str(tmp / "utnet.npz"),
             "Hulb128Net": str(tmp / "hul.npz")}
    fixtures.write_unet_checkpoint(paths["UNet"], 3)
    fixtures.write_jax_checkpoint(paths["UtNet"], 8, seed=4)
    fixtures.write_hul_gen_checkpoint(paths["Hulb128Net"], "Hulb128Net", 2, 5)
    return paths


def _write_cases(path, names, pairs, ckpts):
    kw = {"cases": np.array(names)}
    for k in names:
        network = CASES[k][0]
        c, n = pairs[k]
        kw.update({f"{k}_ckpt": ckpts[network], f"{k}_network": network,
                   f"{k}_clean": c[None], f"{k}_noisy": n[None],
                   f"{k}_weights": json.dumps(WEIGHTS)})
    np.savez(path, **kw)


def _jax_gen(network, ckpt):
    """JAX's generator as its ``test_generator`` reads it, from ``ckpt``."""
    tree = jax.tree_util.tree_map(np.asarray, params_io.load_npz(ckpt))
    if network == "UNet":
        apply_fn = lambda p, x, ms: JaxUNet.apply(p, x, ms, train=True)  # noqa: E731
        params, state = tree["params"], tree["state"]
    elif network == "UtNet":
        apply_fn = lambda p, x: JaxUtNet.apply_fast(p, x, activation="PReLU")  # noqa: E731
        params, state = tree, None
    else:
        apply_fn = lambda p, x: JaxHulb128Net.apply(p, x, activation="PReLU")  # noqa: E731
        params, state = tree, None
    gen = types.SimpleNamespace(stateful=state is not None, apply_fn=apply_fn,
                                weights=jax_steps.normalize_weights(WEIGHTS),
                                state=types.SimpleNamespace(params=params, model_state=state))
    gen.infer = lambda p, x: apply_fn(p, x, state)[0] if state is not None else apply_fn(p, x)
    return gen


def _jax_losses(pairs, ckpts):
    """JAX's test loss of each sharded case, and how many of its forwards
    went through ``SpatialShardedForward``."""
    sharded, call = [], jax_spatial.SpatialShardedForward.__call__

    def counted(self, *a, **k):
        out = call(self, *a, **k)
        sharded.append(self.ndev)
        return out

    losses = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_spatial.SpatialShardedForward, "__call__", counted)
        for k in ("unet", "utnet", "hul"):
            network = CASES[k][0]
            losses[k] = jax_loop.test_generator(_jax_gen(network, ckpts[network]), [pairs[k]])
    return losses, sharded


# -- the trainer's command line -----------------------------------------------------

def _cli_data(base, rng):
    root = base / "SYN_64_36"
    for xx in (0, 64):
        clean = gaussian_filter(rng.random((64, 64, 3)), (3, 3, 0))
        clean = (clean - clean.min()) / np.ptp(clean)
        for iso, sigma in (("ISO200", 0.0), ("ISO3200", 0.08)):
            d = root / "scene0" / iso
            d.mkdir(parents=True, exist_ok=True)
            img = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 1)
            cv2.imwrite(str(d / f"SYN_scene0_{iso}_{xx}_0_36.png"),
                        (img * 65535).astype(np.uint16))
    d = root / "scene0"
    vy = base / "val.yaml"
    vy.write_text(yaml.safe_dump([[str(d / "ISO200" / "SYN_scene0_ISO200_0_0_36.png"),
                                   str(d / "ISO3200" / "SYN_scene0_ISO3200_0_0_36.png")]]))
    # a test scene that crops to 640 x 64 (TestDenoiseDataset's multiples of 64)
    clean, noisy = _pair(rng, 650, 70)
    scene = base / "orig" / "TS"
    scene.mkdir(parents=True)
    for iso, img in (("ISO200", clean), ("ISO6400", noisy)):
        imgio.save_img(img, str(scene / f"NIND_TS_{iso}.png"))
    return ["--train_data", str(root), "--test_reserve", "TS", "--orig_data",
            str(base / "orig"), "--test_interval", "1", "--g_network", "UNet",
            "--g_model_path", str(base / "unet.npz"), "--cs", "36", "--loss_cs", "32",
            "--batch_size", "2", "--g_lr", "1e-6", "--beta1", "0.9", "--weight_MSSSIM", "0",
            "--weight_MSE", "1", "--validation_set_yaml", str(vy), "--threads", "1",
            "--epochs", "2", "--device", "cpu", "--debug_options", "output_test_images"]


def _loop_child(port, rank, world, argv):
    return [sys.executable, CHILD, "loop", f"127.0.0.1:{port}", str(rank), str(world), *argv]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every subprocess started at once (the two- and three-rank
    ``wholetest`` children, the command line as one process and as two
    ranks), JAX's references computed while they run."""
    tmp = tmp_path_factory.mktemp("dp_test")
    rng = np.random.default_rng(3)
    ckpts = _checkpoints(tmp)
    pairs = {k: _pair(rng, *hw) for k, (_, hw) in CASES.items()}
    _write_cases(str(tmp / "two.npz"), list(CASES), pairs, ckpts)
    _write_cases(str(tmp / "three.npz"), ["unet"], pairs, ckpts)
    (tmp / "two").mkdir()
    (tmp / "three").mkdir()
    argv = _cli_data(tmp, rng)
    ports = [_free_port() for _ in range(3)]
    groups = {
        "two": _start([[sys.executable, CHILD, "wholetest", f"127.0.0.1:{ports[0]}", str(r), "2",
                        str(tmp / "two.npz"), str(tmp / "two")] for r in range(2)]),
        "three": _start([[sys.executable, CHILD, "wholetest", f"127.0.0.1:{ports[1]}", str(r),
                          "3", str(tmp / "three.npz"), str(tmp / "three")] for r in range(3)]),
        "cli_one": _start([_loop_child(0, 0, 1, argv + ["--models_dpath", str(tmp / "one")])]),
        "cli_two": _start([_loop_child(ports[2], r, 2, argv + ["--models_dpath",
                                                               str(tmp / "cli_two")])
                           for r in range(2)])}
    try:
        jax_ref = _jax_losses(pairs, ckpts)
    finally:
        outs = {k: _wait(procs) for k, procs in groups.items()}
    ranks = {k: [dict(np.load(tmp / k / f"wholetest{r}.npz")) for r in range(n)]
             for k, n in (("two", 2), ("three", 3))}
    return {"pairs": pairs, "jax": jax_ref, "ranks": ranks, "outs": outs}


def test_jax_shards_its_test_on_eight_devices(run):
    """The reference took its sharded path on every case."""
    _, sharded = run["jax"]
    assert sharded == [8, 8, 8]


def test_unet_sharded_test_matches_jax_and_one_process(run):
    ranks = run["ranks"]["two"]
    ref = run["jax"][0]["unet"]
    losses = [float(r["unet/none/loss"]) for r in ranks]
    assert losses[0] == losses[1]
    assert abs(losses[0] - ref) <= LOSS_TOL, (losses[0], ref)
    one = float(ranks[0]["unet/one_process_loss"])
    assert abs(losses[0] - one) <= LOSS_TOL and abs(one - ref) <= LOSS_TOL
    image = ranks[0]["unet/image"]
    assert "unet/image" not in ranks[1] and image.shape == (1, 3, 640, 64)
    assert float(np.abs(image - ranks[0]["unet/one_process_image"]).max()) <= IMAGE_TOL


def test_unet_bands_are_cut_and_the_replicas_untouched(run):
    """Two bands, each shorter than the image and with halo rows, owning
    the image's rows between them; running stats unchanged on both ranks,
    the replicas' digests equal."""
    ranks = run["ranks"]["two"]
    bands = [tuple(r["unet/none/bands"][0]) for r in ranks]
    assert all(len(r["unet/none/bands"]) == 1 for r in ranks)
    assert bands == [(0, 512, 0, 320, 512), (128, 640, 320, 640, 512)]
    for s, e, o0, o1, forwarded in bands:
        assert forwarded == e - s < 640 and (s < o0 or e > o1)
    for r in ranks:
        assert bool(r["unet/state_unchanged"])
    assert str(ranks[0]["unet/digest"]) == str(ranks[1]["unet/digest"])


@pytest.mark.parametrize("fault", ["halo", "local"])
def test_planted_statistics_faults_break_the_loss_bar(run, fault):
    """The halo rows counted in the statistics, or each band normalized by
    its own owned rows: the loss leaves ``LOSS_TOL`` of JAX's."""
    ranks = run["ranks"]["two"]
    ref = run["jax"][0]["unet"]
    got = float(ranks[0][f"unet/{fault}/loss"])
    assert len(ranks[0][f"unet/{fault}/bands"]) == 1
    assert abs(got - ref) > 10 * LOSS_TOL, (fault, got, ref)


@pytest.mark.parametrize("case", ["utnet", "hul"])
def test_stateless_generators_sharded_test_matches_jax(run, case):
    ranks = run["ranks"]["two"]
    h = CASES[case][1][0]
    for r in ranks:
        ((s, e, o0, o1, forwarded),) = r[f"{case}/none/bands"]
        assert forwarded == e - s < h and (s < o0 or e > o1)
    losses = [float(r[f"{case}/none/loss"]) for r in ranks]
    ref = run["jax"][0][case]
    assert losses[0] == losses[1] and abs(losses[0] - ref) <= LOSS_TOL, (losses, ref)
    image = ranks[0][f"{case}/image"]
    assert float(np.abs(image - ranks[0][f"{case}/one_process_image"]).max()) <= IMAGE_TOL


@pytest.mark.parametrize("world,case", [(3, "unet"), (2, "short")])
def test_unsharded_test_is_rank_zeros_whole_forward(run, world, case):
    """Three ranks on a 640-row image, and an image too short for two
    bands: no rank forwards a band, and the loss is one process's, bit for
    bit."""
    ranks = run["ranks"]["three" if world == 3 else "two"]
    one = float(ranks[0][f"{case}/one_process_loss"])
    for r in ranks:
        assert len(r[f"{case}/none/bands"]) == 0
        assert float(r[f"{case}/none/loss"]) == one
        assert f"{case}/image" not in r


def _cli_result(out):
    exp = next(ln[11:] for ln in out.splitlines() if ln.startswith("EXPERIMENT "))
    bands = json.loads(next(ln[6:] for ln in out.splitlines() if ln.startswith("BANDS ")))
    with open(os.path.join(exp, "trainres.json")) as f:
        return exp, bands, json.load(f)


def test_two_rank_cli_shards_the_test_and_matches_one_process(run):
    """``--test_interval 1`` on UNet: each rank forwards one band, and the
    chief's ``test_loss`` and test image are one process's."""
    one_exp, one_bands, one_res = _cli_result(run["outs"]["cli_one"][0])
    (chief, b0, res0), (_, b1, res1) = (_cli_result(o) for o in run["outs"]["cli_two"])
    assert one_bands == []
    assert b0 == [[0, 512, 0, 320, 512]] and b1 == [[128, 640, 320, 640, 512]]
    assert res0["1"]["test_loss"] == res1["1"]["test_loss"]
    assert abs(res0["1"]["test_loss"] - one_res["1"]["test_loss"]) <= LOSS_TOL
    got, ref = (cv2.imread(os.path.join(e, "testimages", "1", "0.tif"), cv2.IMREAD_UNCHANGED)
                for e in (chief, one_exp))
    assert got.shape == (640, 64, 3)
    assert int(np.abs(got.astype(np.int64) - ref).max()) <= 1


# -- geometry, the owned rows and the gather, in one process ---------------------

def test_rank_bands_follow_jaxs_predicate_and_the_network():
    assert spatial.rank_bands(640, 64, 1, "UNet") is None
    assert spatial.rank_bands(640, 64, 3, "UNet") is None  # 3 does not divide 640
    assert spatial.rank_bands(64, 64, 2, "UNet") is None  # one band only
    assert spatial.rank_bands(600, 64, 2, "UNet") is None  # not a UNet size
    assert spatial.rank_bands(640, 64, 2, "UtNet") is None  # not a UtNet size
    assert spatial.rank_bands(640, 64, 2, "Hulb128Net") is None
    assert spatial.rank_bands(704, 128, 2, "Hulb128Net") == [(0, 470, 0, 351),
                                                             (234, 704, 351, 704)]
    bands = spatial.rank_bands(3968, 5952, 4, "UNet")
    assert [b[2:] for b in bands] == [(0, 1024), (1024, 1984), (1984, 2944), (2944, 3968)]
    for s, e, o0, o1 in bands:
        assert s % 64 == 0 and e % 64 == 0 and s == max(0, o0 - spatial.HALO)
    # the inference path cuts the same bands
    fwd = spatial.SpatialShardedForward([None] * 4, ["cpu"] * 4, size_check=None,
                                        compute_dtype=torch.float32)
    assert fwd.bands(3968) == bands


def test_owned_rows_scale_with_each_layer():
    x = torch.arange(2 * 16 * 4, dtype=torch.float32).reshape(1, 2, 16, 4)
    assert torch.equal(data_parallel.owned(x, (4, 12, 16)), x[:, :, 4:12])
    assert torch.equal(data_parallel.owned(x[:, :, ::4], (4, 12, 16)), x[:, :, 4:12:4])
    with pytest.raises(ValueError, match="owned rows"):
        data_parallel.owned(x[:, :, :6], (4, 12, 16))


def test_band_batch_norm_is_a_forward_only_and_one_process_is_local():
    """Without a run ``owned_rows`` and ``gather_rows`` change nothing; in
    a run a band's BatchNorm refuses autograd."""
    x = torch.randn(1, 3, 8, 5)
    with data_parallel.owned_rows(0, 4, 8):
        assert data_parallel.active() is None
    assert mesh.gather_rows(x, [8]) is x
    bn = torch.nn.BatchNorm2d(3)
    data_parallel.convert_batch_norm(torch.nn.Sequential(bn))
    bn.dp = data_parallel.DataParallel(world=1, rank=0, backend="gloo", group=None,
                                       device=torch.device("cpu"), band=(0, 4, 8))
    with pytest.raises(RuntimeError, match="forward only"):
        bn(x.requires_grad_())


@pytest.mark.parametrize("net", [Hulb128Net, Hulbs128Net])
def test_hul_halo_is_the_smallest_exact_one(net):
    """In float64 at random weights, a band cut at a multiple of 9 keeps rows
    equal to the whole forward (to rounding) with ``HUL_HALO`` rows of halo,
    and not with 9 fewer."""
    torch.manual_seed(1)
    model = net(funit=2).double().eval()
    x = torch.rand(1, 3, 704, 128, dtype=torch.float64)
    o0 = 351
    with torch.no_grad():
        ref = model(x)
        diffs = []
        for halo in (spatial.HUL_HALO - 9, spatial.HUL_HALO):
            s = o0 - halo
            diffs.append(float((model(x[:, :, s:])[:, :, o0 - s:] - ref[:, :, o0:]).abs().max()))
    assert diffs[1] <= 1e-15 and diffs[0] > 1e-13, diffs
