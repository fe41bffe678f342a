"""The attention kernels' wrappers and dispatch, on the CPU.

The CUDA kernels cannot run on the CPU, but what surrounds them can: the checks
that refuse what a kernel does not take (head width, sequence length,
dtype, alignment) raise before any launch, and the dispatch sends each
site of the SVD-XT UNet and of the micro test widths where it always did.
The dispatch is read on `meta` tensors (shapes only), with the kernel
wrappers replaced by their names.
"""

import pytest
import torch

from mofa_tpu_torch.kernels import attention
from mofa_tpu_torch.kernels.flash_attention import kernel_operands as flash_operands
from mofa_tpu_torch.kernels.short_attention import kernel_operands as short_operands
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)

BF, F32 = torch.bfloat16, torch.float32


def _misaligned(*shape, dtype=BF):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte line."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.zeros(n + 16, dtype=dtype)
    return flat[1:1 + n].view(*shape)


@pytest.mark.parametrize("case", ["d32", "fp16", "mixed", "misaligned", "grid"])
def test_flash_operands_refuse_what_the_kernel_does_not_take(case):
    q = torch.zeros(2, 130, 3, 64, dtype=BF)
    k = v = q
    if case == "d32":
        q = k = v = torch.zeros(2, 130, 3, 32, dtype=BF)
    elif case == "fp16":
        q = k = v = q.half()
    elif case == "mixed":
        v = q.float()
    elif case == "misaligned":
        q = _misaligned(2, 130, 3, 64)
    else:                                  # B*H past the grid's 65535
        q = k = v = torch.zeros(16384, 1, 4, 64, dtype=BF)
    with pytest.raises(ValueError):
        flash_operands(q, k, v)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_operands_take_both_widths_contiguous(d, dtype):
    q = torch.zeros(2, 3, 130, d, dtype=dtype).transpose(1, 2)   # strided view
    got = flash_operands(q, q, q)
    assert all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in got)
    torch.testing.assert_close(got[0], q, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["L33", "L0", "d96", "fp16", "mixed", "misaligned"])
def test_short_operands_refuse_what_the_body_does_not_take(case):
    length, d = 25, 64
    q = torch.zeros(4, length, 2, d, dtype=BF)
    k = v = q
    if case == "L33":
        length = 33
        q = k = v = torch.zeros(4, 33, 2, d, dtype=BF)
    elif case == "L0":
        length = 0
        q = k = v = torch.zeros(4, 0, 2, d, dtype=BF)
    elif case == "d96":
        d = 96
        q = k = v = torch.zeros(4, length, 2, 96, dtype=BF)
    elif case == "fp16":
        q = k = v = q.half()
    elif case == "mixed":
        k = q.float()
    else:
        q = _misaligned(4, length, 2, d)
    with pytest.raises(ValueError):
        short_operands(q, k, v, length, d)


@pytest.mark.parametrize("length", [1, 8, 25, 32])
def test_short_operands_take_every_length_up_to_32(length):
    q = torch.zeros(3 * length, 144, 5 * 64, dtype=BF)
    got = short_operands(q, q, q, length, 64)
    assert all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in got)


def _route(monkeypatch):
    for name in ("flash_attention", "short_attention", "attention_plain",
                 "short_attention_tmajor", "tmajor_plain"):
        monkeypatch.setattr(attention, name, lambda *a, name=name: name)


def _meta(*shape):
    return torch.empty(*shape, dtype=BF, device="meta")


# (q shape, k shape, route): SVD-XT at 576x1024, T=25, CFG batch 2; the
# composition check's 256x384, T=8 classic sites; the micro widths (D=16)
SITES = {
    "spatial /8": ((50, 9216, 5, 64), (50, 9216, 5, 64), "flash_attention"),
    "spatial /16": ((50, 2304, 10, 64), (50, 2304, 10, 64), "flash_attention"),
    "spatial /32": ((50, 576, 20, 64), (50, 576, 20, 64), "flash_attention"),
    "trunk /32, D=128": ((50, 576, 10, 128), (50, 576, 10, 128), "flash_attention"),
    "spatial /64": ((50, 144, 20, 64), (50, 144, 20, 64), "attention_plain"),
    # past the flash grid's 65535 batch·heads, which the kernel refuses
    "spatial /32, B*H = 65540": ((13108, 576, 5, 64), (13108, 576, 5, 64),
                                 "attention_plain"),
    "cross /8": ((50, 9216, 5, 64), (50, 1, 5, 64), "attention_plain"),
    "classic temporal /8": ((18432, 25, 5, 64), (18432, 25, 5, 64), "short_attention"),
    "classic temporal /16": ((4608, 25, 10, 64), (4608, 25, 10, 64), "attention_plain"),
    "classic T=8 /8": ((3072, 8, 5, 64), (3072, 8, 5, 64), "short_attention"),
    "classic T=8 /32": ((192, 8, 20, 64), (192, 8, 20, 64), "short_attention"),
    "micro spatial, D=16": ((6, 600, 2, 16), (6, 600, 2, 16), "attention_plain"),
    "micro classic, D=16": ((128, 3, 2, 16), (128, 3, 2, 16), "attention_plain"),
}


@pytest.mark.parametrize("site", list(SITES))
def test_dispatch_routes_each_site_as_before(site, monkeypatch):
    qs, ks, want = SITES[site]
    _route(monkeypatch)
    assert attention.dot_product_attention(_meta(*qs), _meta(*ks), _meta(*ks)) == want


@pytest.mark.parametrize("rows,heads,frames,want", [
    ((50, 9216, 320), 5, 25, "short_attention_tmajor"),
    ((50, 2304, 640), 10, 25, "short_attention_tmajor"),
    ((50, 144, 1280), 20, 25, "short_attention_tmajor"),
    ((16, 48, 5 * 128), 5, 8, "short_attention_tmajor"),
    ((6, 40, 32), 2, 3, "tmajor_plain"),           # micro widths, D=16
    ((66, 40, 320), 5, 33, "tmajor_plain")])       # more frames than a tile
def test_tmajor_gate_routes_each_site_as_before(rows, heads, frames, want, monkeypatch):
    _route(monkeypatch)
    x = _meta(*rows)
    assert attention.temporal_attention_tmajor(x, x, x, frames, heads) == want
