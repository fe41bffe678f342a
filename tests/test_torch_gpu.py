"""The port's CUDA kernels against their plain versions, on a GPU only.

Needs neither JAX nor mofa_tpu, so it runs where only the port is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite.)
Elsewhere it skips. chip_smoke.py makes the same comparison at the main
path's shapes; this test uses small ones, including ragged sizes.
"""

import pytest
import torch

from mofa_tpu_torch import kernels
from mofa_tpu_torch.kernels.flash_attention import flash_attention
from mofa_tpu_torch.kernels.geglu_ffn import ln_geglu_ffn
from mofa_tpu_torch.kernels.short_attention import short_attention_tmajor
from mofa_tpu_torch.kernels.softsplat import splat_raw


@pytest.mark.gpu
def test_kernels_on_card():
    """CUDA kernels vs their plain versions on small shapes (GPU only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    # fp32: max |diff| <= 1e-4 * max(1, max |ref|), other summation order.
    # bf16: max |diff| <= 2e-2 * max |ref| and ||diff|| / ||ref|| <= 1e-2,
    # the loosest of chip_smoke.py's TOL_BF16 bounds (bf16 outputs and
    # roundings at other points; attention outputs are far below 1, so the
    # bounds scale with the reference).
    for dt, tol, rms_tol in ((torch.float32, 1e-4, None),
                             (torch.bfloat16, 2e-2, 1e-2)):
        q, k, v = (rn(2, 700, 3, 64).to(dt) for _ in range(3))
        q2, k2, v2 = (rn(14, 50, 3 * 128).to(dt) for _ in range(3))
        x = rn(5000, 320).to(dt)
        w0, w2 = (rn(2560, 320) / 18).to(dt), (rn(320, 1280) / 36).to(dt)
        b0, b2 = rn(2560).to(dt), rn(320).to(dt)
        ls, lb = rn(320) + 1, rn(320)
        calls = [lambda: flash_attention(q, k, v),
                 lambda: short_attention_tmajor(q2, k2, v2, 7, 3),
                 lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2)]
        if dt == torch.float32:
            calls.append(lambda: splat_raw(rn(3, 9, 11, 5), rn(3, 9, 11, 2) * 3))
        for fn in calls:
            state = g.get_state()
            got = fn()
            g.set_state(state)
            with kernels.plain_reference():
                ref = fn()
            diff, ref = got.float() - ref.float(), ref.float()
            ref_max = ref.abs().max().item()
            if rms_tol is None:
                assert diff.abs().max().item() <= tol * max(1.0, ref_max)
            else:
                assert diff.abs().max().item() <= tol * ref_max
                assert (diff.norm() / ref.norm()).item() <= rms_tol
