"""P1's epilogue options (``ops/qconv.conv_int8``: the decoder's fp32
addend and bias map, a one-weight PReLU, the static quantize to int8)
against the torch composition they replace in the int8 forward, bit for
bit, on the CPU: ``dequant_reference`` then ``(z_a + z_b + bmap + b)`` in
fp32, the cast to the work dtype, ``ops/conv.prelu`` and
``quant_act_static``, in fp32 and bf16, with per-sample and scalar
activation scales and the level-4 parity weight scales; and the wrapper's
checks of the options."""

import numpy as np
import pytest
import torch

from nind_denoise_tpu_torch.ops import qconv as Q
from nind_denoise_tpu_torch.ops.conv import prelu

N, H, W, CIN, COUT = 2, 9, 11, 16, 24
PADS, DIL = (2, 2, 2, 2), 1


def _case(seed, parity, per_sample):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (N, H, W, CIN), dtype=np.int8))
    k = 4 if parity else 3
    pads, dil = ((3, 3, 3, 3), 2) if parity else (PADS, DIL)
    wk = torch.from_numpy(rng.integers(-127, 128, (COUT, k, k, CIN), dtype=np.int8))
    sx = torch.from_numpy(rng.random(N if per_sample else 1, dtype=np.float32) * 1e-2 + 1e-3)
    sw = torch.from_numpy(rng.random((2, COUT) if parity else (COUT,), dtype=np.float32)
                          * 1e-3 + 1e-4)
    ho, wo = Q.out_hw(H, W, k, k, pads, dil)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    return dict(xq=xq, wk=wk, pads=pads, dil=dil, sx=sx, sw=sw, bias=f(COUT) * 0.5,
                addend=f(N, ho, wo, COUT), bmap=f(1, ho, wo, COUT),
                a=torch.tensor([0.25]), s=torch.tensor(0.02))


@pytest.mark.parametrize("work", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_sample", [True, False])
@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("form", ["raw", "act", "sum", "act_int8", "sum_int8"])
def test_fused_epilogue_equals_the_torch_composition(work, per_sample, parity, form):
    c = _case(len(form) + 7 * parity + 3 * per_sample, parity, per_sample)
    acc = Q.conv_i32_reference(c["xq"], c["wk"], c["pads"], c["dil"])
    raw = acc.to(torch.float32) * Q._scale_grid(c["sx"], c["sw"], N, acc.shape[2])
    if form == "raw":
        got = Q.conv_int8(c["xq"], c["wk"], c["pads"], c["dil"], sx=c["sx"], sw=c["sw"])
        assert torch.equal(got, raw)
        return
    kw = dict(sx=c["sx"], sw=c["sw"], bias=c["bias"], out_dtype=work, prelu=c["a"])
    if form.startswith("sum"):
        kw.update(addend=c["addend"], bias_map=c["bmap"])
        want = (c["addend"] + raw + c["bmap"] + c["bias"]).to(work)
    else:
        want = (raw + c["bias"]).to(work)
    want = prelu(want, c["a"])
    if form.endswith("int8"):
        kw["out_scale"] = c["s"]
        want = Q.quant_act_static(want, c["s"])[0]
    got = Q.conv_int8(c["xq"], c["wk"], c["pads"], c["dil"], **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _bad(**over):
    c = _case(1, False, True)
    kw = dict(sx=c["sx"], sw=c["sw"], bias=c["bias"], out_dtype=torch.bfloat16,
              addend=c["addend"], bias_map=c["bmap"], prelu=c["a"], out_scale=c["s"])
    kw.update(over)
    return lambda: Q.conv_int8(c["xq"], c["wk"], c["pads"], c["dil"], **kw)


@pytest.mark.parametrize("name,bad,err", [
    ("addend", torch.zeros(N, 3, 3, COUT), ValueError),
    ("addend", torch.zeros(N, 13, 15, COUT, dtype=torch.bfloat16), TypeError),
    ("addend", torch.zeros(N, 13, 15, COUT, device="meta"), ValueError),
    ("bias_map", torch.zeros(2, 13, 15, COUT), ValueError),
    ("bias_map", torch.zeros(13, 15, COUT, dtype=torch.float64), TypeError),
    ("prelu", torch.zeros(2), ValueError),
    ("prelu", torch.zeros(1, device="meta"), ValueError),
    ("out_scale", torch.zeros(3), ValueError),
    ("out_scale", torch.zeros((), dtype=torch.int32), TypeError),
    ("out_dtype", torch.int32, ValueError)])
def test_wrapper_rejects_bad_options(name, bad, err):
    with pytest.raises(err):
        _bad(**{name: bad})()


def test_bias_map_may_drop_its_batch_axis():
    c = _case(2, False, False)
    kw = dict(sx=c["sx"], sw=c["sw"], bias=c["bias"], out_dtype=torch.bfloat16,
              addend=c["addend"], prelu=c["a"])
    a = Q.conv_int8(c["xq"], c["wk"], c["pads"], c["dil"], bias_map=c["bmap"], **kw)
    b = Q.conv_int8(c["xq"], c["wk"], c["pads"], c["dil"], bias_map=c["bmap"][0], **kw)
    assert torch.equal(a, b)
