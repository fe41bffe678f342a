"""The split-TF32 arithmetic of the fp32 routes of flash attention, short
attention and the LN-GEGLU FFN, emulated on the CPU.

On a card these routes take each fp32 GEMM operand as big = tf32(x) and
small = tf32(x - big) and each product as small * big + big * small +
big * big on the tensor cores (csrc/flash_attention.cu,
csrc/short_attention.cu, csrc/ln_geglu_ffn.cu); they cannot run here.
This file emulates that arithmetic in PyTorch, rounding to TF32 with the
port's bit mask (`kernels.tf32_round`), the products summed in float64,
at C = 320 (a few hundred rows), at L = 512, D = 64 and at L = 25, D =
64, and holds it to a float64 result with the bounds chip_smoke.py holds
the kernels to (`TOL_FP32`): the three-term split sits inside them, a
single TF32 product (the correction terms dropped) does not. It also
reads the arguments the fp32 wrappers hand their C entries (use_kernel
forced True, the launch recorded)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import TOL_FP32
from mofa_tpu_torch import kernels
from mofa_tpu_torch.kernels import split_tf32_plain, tf32_round
from mofa_tpu_torch.kernels import flash_attention as flash_mod
from mofa_tpu_torch.kernels import geglu_ffn as ffn_mod
from mofa_tpu_torch.kernels._build import _SIGNATURES
from tests.torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _split_product(a, b, terms):
    """a @ b (fp32 operands) as the kernels take it: big * big, plus with
    terms = 3 small * big + big * small, each product exact and summed in
    float64."""
    ab, as_ = (t.double() for t in split_tf32_plain(a))
    bb, bs = (t.double() for t in split_tf32_plain(b))
    out = ab @ bb
    return out + as_ @ bb + ab @ bs if terms == 3 else out


def _ffn_split(x, ls, lb, w0, b0, w2, b2, terms):
    """The fp32 FFN route's arithmetic: xn = LN(x) in fp32, the gate GEMM
    on its split, h in fp32, the out GEMM on its split, + b2 + x."""
    xn = ffn_mod.ffn_ln_rows_plain(x, ls, lb)
    a, g = (_split_product(xn, w0.t(), terms) + b0.double()).chunk(2, dim=-1)
    h = (a * F.gelu(g)).float()
    return _split_product(h, w2.t(), terms) + b2.double() + x.double()


def _attention_split(q, k, v, terms):
    """The fp32 flash route's arithmetic on [B, L, H, D]: S = Q K^T on the
    split, the softmax exact, P in fp32, O = P V on the split."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = _split_product(qh, kh.transpose(-1, -2), terms) * q.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1).float()
    return _split_product(p, vh, terms).transpose(1, 2)


def _rng_tensors(seed, *shapes, scales=None):
    rng = np.random.RandomState(seed)
    scales = scales or [1.0] * len(shapes)
    return [torch.from_numpy((rng.randn(*s) * sc).astype(np.float32))
            for s, sc in zip(shapes, scales)]


def test_tf32_round_is_round_to_nearest_away():
    """10 mantissa bits, ties away from zero, the low 13 bits cleared; big +
    small holds x to 2^-21 of itself."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      3.14159265, -2.71828183, 1e-30, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         3.140625, -2.71875])
    got = tf32_round(x)
    assert torch.equal(got[:6], want[:6])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    big, small = split_tf32_plain(x)
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()


@pytest.mark.parametrize("terms", [3, 1])
def test_ffn_split_against_the_fp32_bound(terms):
    """The FFN at C = 320, 384 rows (the training operands' scales): the
    three-term split within TOL_FP32["ln_geglu_ffn"] of float64, one TF32
    product outside it."""
    c, rows = 320, 384
    x, ls, lb, w0, b0, w2, b2 = _rng_tensors(
        7, (rows, c), (c,), (c,), (8 * c, c), (8 * c,), (c, 4 * c), (c,),
        scales=[1.0, 0.2, 0.2, c ** -0.5, 0.1, (4 * c) ** -0.5, 0.1])
    ls = ls + 1.0
    ref = ffn_mod.ln_ffn_plain(*(t.double() for t in (x, ls, lb, w0, b0, w2, b2)))
    err = (_ffn_split(x, ls, lb, w0, b0, w2, b2, terms) - ref).abs().max().item()
    tol = TOL_FP32["ln_geglu_ffn"]
    assert (err <= tol) == (terms == 3), (terms, err, tol)


@pytest.mark.parametrize("terms", [3, 1])
def test_flash_split_against_the_fp32_bound(terms):
    """Attention at [1, 512, 2, 64]: the three-term split within
    TOL_FP32["flash_attention"] of float64, one TF32 product outside it."""
    q, k, v = _rng_tensors(11, *[(1, 512, 2, 64)] * 3)
    ref = flash_mod.attention_plain(q.double(), k.double(), v.double())
    err = (_attention_split(q, k, v, terms) - ref).abs().max().item()
    tol = TOL_FP32["flash_attention"]
    assert (err <= tol) == (terms == 3), (terms, err, tol)


@pytest.mark.parametrize("terms", [3, 1])
def test_short_split_against_the_fp32_bound(terms):
    """Short attention at [64, 25, 5, 64] (classic; tmajor runs the same
    body): the fp32 route's arithmetic (S = Q K^T and O = P V each on the
    split, its fragments split in registers) within TOL_FP32 of float64 for
    both layouts' kernels, one TF32 product (the planted fault) outside
    them."""
    q, k, v = _rng_tensors(13, *[(64, 25, 5, 64)] * 3)
    ref = flash_mod.attention_plain(q.double(), k.double(), v.double())
    err = (_attention_split(q, k, v, terms) - ref).abs().max().item()
    for name in ("short_attention", "short_attention_tmajor"):
        assert (err <= TOL_FP32[name]) == (terms == 3), (name, terms, err)


def test_fp32_wrappers_hand_the_entries_their_scratch(monkeypatch):
    """On a card (use_kernel forced True, the C entry recorded instead of
    called) the fp32 routes pass as many arguments as the entries'
    signatures hold, with scratch for the TF32 planes: flash 2 B H D (Lq +
    Lk + Lp) floats, Lp = Lk rounded up to 64; the FFN xn [2, R, C], h [2,
    R, 4C] and 24 C^2 floats of W0's and W2's planes; one launch each."""
    seen = {}
    allocated = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        allocated.append(t)
        return t

    def launch(entry, device, *args):
        assert len(args) + 1 == len(_SIGNATURES[entry])     # + the stream
        seen[entry] = args

    for mod in (flash_mod, ffn_mod):
        monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
        monkeypatch.setattr(mod.torch, "empty", empty)
    monkeypatch.setattr("mofa_tpu_torch.kernels._build.launch", launch)
    kernels.reset_launch_counts()
    q, k, v = _rng_tensors(3, (2, 100, 3, 64), (2, 130, 3, 64), (2, 130, 3, 64))
    with torch.no_grad():
        flash_mod.flash_attention(q, k, v)
    scratch = [t for t in allocated if t.data_ptr() == seen["mofa_flash_attention"][4]]
    assert scratch[0].numel() == 2 * 2 * 3 * 64 * (100 + 130 + 192)
    assert seen["mofa_flash_attention"][5:] == (2, 100, 130, 3, 64, 0)

    allocated.clear()
    c, rows = 320, 33
    x, ls, lb, w0, b0, w2, b2 = _rng_tensors(
        5, (rows, c), (c,), (c,), (8 * c, c), (8 * c,), (c, 4 * c), (c,))
    with torch.no_grad():
        ffn_mod.ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2)
    args = seen["mofa_ln_geglu_ffn"]
    by_ptr = {t.data_ptr(): t for t in allocated}
    assert tuple(by_ptr[args[7]].shape) == (2, rows, c)
    assert tuple(by_ptr[args[8]].shape) == (2, rows, 4 * c)
    assert by_ptr[args[9]].numel() == 24 * c * c
    assert args[11:] == (rows, c, 0, 0, 0)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["ln_geglu_ffn"] == 1
