"""One rank of the port's two-process data-parallel checks on the CPU
(``tests/test_torch_train_dp.py``), port only, two torch threads.

    python tests/_torch_dp_child.py steps <host:port> <rank> <in.npz> <out_dir>
    python tests/_torch_dp_child.py shutdown <host:port> <rank> <stop_at> <loop argv...>
    python tests/_torch_dp_child.py wholetest <host:port> <rank> <world> <in.npz> <out_dir>
    python tests/_torch_dp_child.py loop <host:port> <rank> <world> <loop argv...>

``steps``: joins a two-process ``gloo`` group and runs, on this rank's rows
of the global batches in ``in.npz`` (``data_parallel.rank_rows``), two DP
generator steps of UtNet (``--grad_accum`` 1 and 2, AMSGrad), two of UNet
(its BatchNorm over the global batch; plain SGD), and two discriminator steps and one
``learn`` of a Hul112Disc resumed from ``in.npz``'s checkpoint path, with
the global fuzzy-target draws the file holds. Writes ``rank<r>.npz``.

``shutdown``: ``train.loop.main`` with a shutdown flag that only rank 1
raises, at its ``stop_at``-th poll (one poll a batch).

``wholetest`` (``tests/test_torch_dp_test.py``): joins a ``world``-process
group and runs ``train.loop.test_generator`` as a data-parallel run on
each case of ``in.npz`` (a generator checkpoint and a test set), then the
same test in one process (the run stopped); UNet cases also run it with
two planted faults: the halo rows counted in the band's statistics, and
each band's statistics its own (no reduce). Records each loss, each band
(its rows and the rows it forwarded), the gathered image on rank 0, the
running stats before and after, and the replica's digest, in
``wholetest<r>.npz``.

``loop``: ``train.loop.main`` as rank ``rank`` of ``world`` (one process
without a group where ``world`` is 1), printing its experiment directory
and every band the whole-image test forwarded on this rank.
"""

import contextlib
import copy
import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from nind_denoise_tpu_torch.models import params_io  # noqa: E402
from nind_denoise_tpu_torch.parallel import data_parallel, mesh  # noqa: E402
from nind_denoise_tpu_torch.train import gan, loop, steps  # noqa: E402

WORLD = 2

# the gradient all-reduces that ran in an active run, counted around
# ``data_parallel.reduce_gradients`` (the steps call it through the module)
REDUCED = []
_reduce_gradients = data_parallel.reduce_gradients


def _counted_reduce(params, metrics):
    REDUCED.append(data_parallel.active() is not None)
    return _reduce_gradients(params, metrics)


data_parallel.reduce_gradients = _counted_reduce


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _flat(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


class SGD:
    """Plain SGD with the step's optimizer interface: an update linear in
    the gradient, where a fresh AMSGrad moves an element whose gradient is
    fp32 rounding noise (UNet's conv biases before BatchNorm) by about its
    learning rate."""

    def __init__(self, model, lr):
        self.params, self.lr = list(model.parameters()), lr

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            p.sub_(self.lr * p.grad)


def _generator_steps(model, batches, weights, loss_cs, opt, accum, rank):
    data_parallel.start(torch.device("cpu"), accum)
    REDUCED.clear()
    data_parallel.broadcast_module(model)
    data_parallel.convert_batch_norm(model)
    state = steps.TrainState(model, opt)
    step = steps.make_generator_train_step(steps.plain_apply, weights, loss_cs,
                                           grad_accum=accum)
    losses, stats = [], []
    for clean, noisy in batches:
        rows = data_parallel.rank_rows(len(clean), WORLD, rank, accum)
        m = step(state, _nchw(clean[rows]), _nchw(noisy[rows]))
        losses.append({k: float(v) for k, v in m.items()})
        stats.append({k: v.numpy().copy() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))})
    assert REDUCED == [True] * len(batches)
    data_parallel.stop()
    return losses, stats


def run_steps(rank, inp, out_dir):
    d = np.load(inp, allow_pickle=True)
    out = {}
    # UtNet, grad_accum 1 and 2
    utnet = d["utnet"].item()
    batches = [(d["u_clean"][i], d["u_noisy"][i]) for i in range(len(d["u_clean"]))]
    for accum in (1, 2):
        model = params_io.generator_from_state_dict(params_io.state_dict_from_jax(utnet))
        opt = steps.make_optimizer(model, float(d["u_lr"]), float(d["u_beta1"]))
        losses, _ = _generator_steps(model, batches, {"MSE": 1.0}, int(d["u_loss_cs"]), opt,
                                     accum, rank)
        out[f"utnet{accum}_loss"] = np.array([m["weighted"] for m in losses])
        for k, v in _flat(model.state_dict()).items():
            out[f"utnet{accum}/{k}"] = v
    # UNet with its BatchNorm state
    params, state = d["unet_params"].item(), d["unet_state"].item()
    model = params_io.generator_from_state_dict(
        params_io.unet_state_dict_from_jax(params, state), network="UNet").train()
    batches = [(d["n_clean"][i], d["n_noisy"][i]) for i in range(len(d["n_clean"]))]
    losses, stats = _generator_steps(model, batches, {"MSE": 1.0, "L1": 0.5},
                                     int(d["n_loss_cs"]), SGD(model, float(d["n_lr"])), 1, rank)
    out["unet_loss"] = np.array([m["weighted"] for m in losses])
    for k, v in stats[0].items():
        out[f"unet_step1/{k}"] = v
    for k, v in _flat(model.state_dict()).items():
        out[f"unet/{k}"] = v
    # the discriminator, resumed from the JAX wrapper's checkpoint
    data_parallel.start(torch.device("cpu"))
    REDUCED.clear()
    args = types.SimpleNamespace(beta1=0.5, models_dpath=None)
    disc = gan.DiscriminatorWrapper(args, "Hul112Disc", funit=1, lr=1e-4, conditional=True,
                                    seed=9, patience=2, model_path=str(d["d_ckpt"]),
                                    device="cpu")
    data_parallel.convert_batch_norm(disc.model)
    data_parallel.broadcast_module(disc.model)
    rows = data_parallel.rank_rows(len(d["d_clean"][0]), WORLD, rank)
    res = []
    for i, fake_is_noisy in enumerate((False, True)):
        crops = [_nchw(d[f"d_{k}"][i][rows]) for k in ("clean", "generated", "noisy")]
        draws = tuple(torch.from_numpy(d[f"d_draws_{s}"][i]) for s in ("real", "fake"))
        lr_, lf_, ranges = disc._step(*crops, fake_is_noisy, draws=draws)
        res.append(np.concatenate([[float(lr_), float(lf_)], ranges.numpy()]))
    out["d_steps"] = np.stack(res)
    # a copy: the tree's arrays share the live tensors' memory
    out["d_ckpt"] = np.array(copy.deepcopy(disc.checkpoint()), dtype=object)
    disc.loss = 0.2  # fake targets noisy
    ident = types.SimpleNamespace(infer=lambda x: x)
    draws = tuple(torch.from_numpy(d[f"d_learn_draws_{s}"]) for s in ("real", "fake"))
    rows = data_parallel.rank_rows(len(d["d_learn_clean"]), WORLD, rank)
    disc.learn(_nchw(d["d_learn_clean"][rows]), _nchw(d["d_learn_noisy"][rows]), ident,
               int(d["d_loss_cs"]), draws=draws)
    out["d_learn_loss"] = np.array(disc.loss)
    for k, v in _flat(disc.model.state_dict()).items():
        out[f"d_learned/{k}"] = v
    assert REDUCED == [True] * 3
    data_parallel.stop()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _test_gen(ckpt, network, weights):
    """The trainer's generator as ``test_generator`` reads it: the model
    from ``ckpt``, its forward (``GeneratorWrapper.infer``), the loss
    weights, the device."""
    model = params_io.load_generator(ckpt, network).train()
    gen = types.SimpleNamespace(network=network, device=torch.device("cpu"),
                                weights=steps.normalize_weights(weights), apply_fn=steps.plain_apply,
                                state=types.SimpleNamespace(model=model))
    gen.infer = types.MethodType(loop.GeneratorWrapper.infer, gen)
    return gen


@contextlib.contextmanager
def _planted(fault):
    """``halo``: the band's statistics count its halo rows; ``local``: each
    band normalizes by its own owned rows (the statistics not reduced)."""
    if fault == "halo":
        keep, data_parallel.owned = data_parallel.owned, lambda x, band: x
    elif fault == "local":
        keep, mesh.all_reduce = mesh.all_reduce, lambda t, op="sum", group=None: t.clone()
    try:
        yield
    finally:
        if fault == "halo":
            data_parallel.owned = keep
        elif fault == "local":
            mesh.all_reduce = keep


def run_wholetest(rank, world, inp, out_dir):
    d = np.load(inp, allow_pickle=True)
    out = {}
    dp = data_parallel.start(torch.device("cpu"))
    seen, gathered = [], []
    run_band, gather = loop.spatial.run_rank_band, mesh.gather_rows

    def spy_band(forward, x, band):
        seen.append([*band, x.shape[2]])
        return run_band(forward, x, band)

    def spy_gather(*a, **k):
        got = gather(*a, **k)
        gathered.append(got)
        return got

    loop.spatial.run_rank_band, mesh.gather_rows = spy_band, spy_gather
    for case in d["cases"]:
        gen = _test_gen(str(d[f"{case}_ckpt"]), str(d[f"{case}_network"]),
                        json.loads(str(d[f"{case}_weights"])))
        data_parallel.convert_batch_norm(gen.state.model)
        test_set = list(zip(d[f"{case}_clean"], d[f"{case}_noisy"]))
        before = _flat(gen.state.model.state_dict())
        faults = ("none", "halo", "local") if gen.network == "UNet" else ("none",)
        for fault in faults:
            seen.clear()
            gathered.clear()
            with _planted(fault):
                out[f"{case}/{fault}/loss"] = np.array(loop.test_generator(gen, test_set,
                                                                           dp=dp))
            out[f"{case}/{fault}/bands"] = np.array(seen, dtype=np.int64).reshape(-1, 5)
            if fault == "none" and gathered and gathered[0] is not None:
                out[f"{case}/image"] = gathered[0].numpy()
        after = _flat(gen.state.model.state_dict())
        out[f"{case}/state_unchanged"] = np.array(
            before.keys() == after.keys() and all(np.array_equal(before[k], after[k])
                                                  for k in before))
        out[f"{case}/digest"] = np.array(data_parallel.digest([gen.state.model]))
        data_parallel.stop()
        out[f"{case}/one_process_loss"] = np.array(loop.test_generator(gen, test_set))
        out[f"{case}/one_process_image"] = gen.infer(torch.from_numpy(test_set[0][1][None])).numpy()
        dp = data_parallel.start(torch.device("cpu"))
    data_parallel.stop()
    np.savez(os.path.join(out_dir, f"wholetest{rank}.npz"), **out)


class _OneRankShutdown(loop.GracefulShutdown):
    """Raised on rank 1 alone, at its ``STOP_AT``-th poll."""
    STOP_AT = 0
    RANK = 0

    def __init__(self):
        super().__init__()
        self._polls = 0

    @property
    def requested(self):
        self._polls += 1
        return self.RANK == 1 and self._polls >= self.STOP_AT

    @requested.setter
    def requested(self, value):
        pass


def main():
    mode, coordinator, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    if mode == "steps":
        mesh.init_distributed(coordinator=coordinator, num_processes=WORLD, process_id=rank)
        run_steps(rank, sys.argv[4], sys.argv[5])
    elif mode == "wholetest":
        world = int(sys.argv[4])
        mesh.init_distributed(coordinator=coordinator, num_processes=world, process_id=rank)
        run_wholetest(rank, world, sys.argv[5], sys.argv[6])
    elif mode == "loop":
        world, seen = int(sys.argv[4]), []
        run_band = loop.spatial.run_rank_band

        def spy_band(forward, x, band):
            seen.append([*band, x.shape[2]])
            return run_band(forward, x, band)

        loop.spatial.run_rank_band = spy_band
        join = ["--coordinator", coordinator, "--num_processes", str(world),
                "--process_id", str(rank)] if world > 1 else []
        print("EXPERIMENT " + loop.main(sys.argv[5:] + join))
        print("BANDS " + json.dumps(seen))
    elif mode == "shutdown":
        _OneRankShutdown.STOP_AT, _OneRankShutdown.RANK = int(sys.argv[4]), rank
        loop.GracefulShutdown = _OneRankShutdown
        print("EXPERIMENT " + loop.main(sys.argv[5:] + [
            "--coordinator", coordinator, "--num_processes", str(WORLD),
            "--process_id", str(rank)]))
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
