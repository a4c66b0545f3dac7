"""The flash-attention CUDA kernel against its plain PyTorch version on
the card, f32 and bf16 inputs, causal and not. Every test here is marked
``cuda`` and skips without a CUDA device (a CUDA kernel has no CPU
mode). The file imports no JAX, so on a machine without it the tests
run with ``python -m pytest --noconftest -m cuda
tests/test_torch_*cuda*.py``."""

import pytest
import torch

from colearn_federated_learning_tpu_torch.ops import (
    flash_attention as fa,
)

torch.set_num_threads(1)

# (B·H, T, hd): the BERT-tiny path's shape, ViT's ragged 197, and the
# lengths and head dims of tests/test_pallas_attention.py
_SHAPES = [(32, 80, 64), (4, 197, 64), (6, 50, 16), (6, 48, 16),
           (3, 50, 128), (3, 48, 128)]


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (8 significant bits), exact:
    the power of two of x's exponent field, times 2⁻⁷."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return (mag.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0**-7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_kernel_matches_plain_on_card(shape, dtype):
    """One launch per mask on the same random q/k/v. f32 within 2e-5 abs
    + 2e-5 rel (tests/test_pallas_attention.py's tolerance); bf16 within
    one bf16 ulp of the plain version plus 2e-5: both compute in f32 and
    round once, and near zero, where the f32 sums cancel, the two orders
    of summation differ by more than a bf16 ulp.

    f32 also runs the inputs where a fault of the 3xTF32 split or of the
    warps' merge shows: q and k
    scaled ×2 (scores 4× as spread, peaked softmaxes, where the low parts
    of q and k decide p), and v at magnitudes from 1e-3 to 1e3 (the low
    parts carried over six decades). Both go as far as the f32 plain
    version itself stays within half the tolerance of the exact answer
    (tools/flash_f32_compare.py --accuracy on an NVIDIA H100 80GB HBM3,
    700.00 W): q and k ×2 put it 0.31 of the tolerance away, ×3 0.67
    and ×4 1.39, while the kernel stays within 0.36 at all three; and
    with v of mixed signs, outputs that cancel put it past the
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for causal in (True, False):
        gen = torch.Generator(device="cuda").manual_seed(sum(shape) + causal)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        cases = [(q, k, v)]
        if dtype == torch.float32:
            mag = 10.0 ** (torch.rand(shape, device="cuda", generator=gen) * 6
                           - 3)
            cases += [(2 * q, 2 * k, v), (q, k, v.abs() * mag)]
        for qc, kc, vc in cases:
            want = fa.attention_reference(qc, kc, vc, causal)
            before = (fa.flash_attention.launches,
                      fa.flash_attention.f32_launches)
            got = fa.attention_forward(qc, kc, vc, causal)
            torch.cuda.synchronize()
            f32 = int(dtype == torch.float32)
            assert (fa.flash_attention.launches,
                    fa.flash_attention.f32_launches) == (before[0] + 1,
                                                         before[1] + f32)
            assert got.dtype == dtype and got.shape == q.shape
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
            else:
                err = (got.float() - want.float()).abs()
                assert bool((err <= _bf16_ulp(want) + 2e-5).all()), \
                    (causal, float(err.max()))
    assert fa.LIBRARY.path().exists()
