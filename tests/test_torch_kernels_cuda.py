"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips
without a CUDA device (a CUDA kernel has no CPU mode). The flash-
attention kernel's cases against its plain version are in
tests/test_torch_flash_attention_cuda.py. These files import no JAX,
so on a machine without it the tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_*cuda*.py``."""

import pytest
import torch

from colearn_federated_learning_tpu_torch.ops import (
    flash_attention as fa,
)
from colearn_federated_learning_tpu_torch.ops import reduce_apply, server_apply
from colearn_federated_learning_tpu_torch.ops.attention import (
    causal_attention,
)
from colearn_federated_learning_tpu_torch.ops.reduce_apply import (
    fused_reduce_apply,
    new_stack,
    reduce_apply_reference,
)
from colearn_federated_learning_tpu_torch.ops.server_apply import (
    delta_apply_reference,
    fused_delta_apply,
)

torch.set_num_threads(1)


@pytest.mark.cuda
# ResNet-18's length, MobileNetV2's (2 mod 4: the scalar tail runs) and
# an odd one
@pytest.mark.parametrize("n", [11_173_962, 1_000_003, 2_302_718])
@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_kernel_matches_plain_on_card(n, beta):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(n)
    p = torch.randn(n, device="cuda", generator=gen)
    d = torch.randn(n, device="cuda", generator=gen) * 0.01
    m = torch.randn(n, device="cuda", generator=gen) if beta else None
    want_p, want_m = delta_apply_reference(p, d, 0.7, m, beta)
    before = fused_delta_apply.launches
    fused_delta_apply(p, d, 0.7, m, beta)
    torch.cuda.synchronize()
    assert fused_delta_apply.launches == before + 1
    # bit for bit: each operation rounded once in f32, as the plain ops
    assert torch.equal(p, want_p)
    if beta:
        assert torch.equal(m, want_m)
    assert server_apply.library_path().exists()


@pytest.mark.cuda
def test_kernel_wrapper_rejects_misaligned_buffers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    p = torch.zeros(1025, device="cuda")
    d = torch.zeros(1025, device="cuda")
    before = fused_delta_apply.launches
    with pytest.raises(ValueError, match="16-byte"):
        fused_delta_apply(p[1:], d[1:], 1.0)
    assert fused_delta_apply.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [11_173_962, 1_000_003])
@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_reduce_apply_kernel_matches_plain_on_card(n, beta):
    """Random weights, a one-hot row and an all-zero row, K = 16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    k = 16
    gen = torch.Generator(device="cuda").manual_seed(n + 1)
    stack = new_stack(k, n, "cuda")
    stack.copy_(torch.randn(k, n, device="cuda", generator=gen) * 0.01)
    rows = {"random": torch.rand(k, device="cuda", generator=gen) / k,
            "one_hot": torch.eye(k, device="cuda")[5],
            "zero": torch.zeros(k, device="cuda")}
    for w in rows.values():
        p = torch.randn(n, device="cuda", generator=gen)
        m = torch.randn(n, device="cuda", generator=gen) if beta else None
        want_p, want_m, want_d = reduce_apply_reference(stack, w, p, 0.7, m,
                                                        beta)
        before = fused_reduce_apply.launches
        _, _, d = fused_reduce_apply(stack, w, p, 0.7, m, beta)
        torch.cuda.synchronize()
        assert fused_reduce_apply.launches == before + 1
        torch.testing.assert_close(d, want_d, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(p, want_p, atol=1e-6, rtol=1e-6)
        if beta:
            torch.testing.assert_close(m, want_m, atol=1e-6, rtol=1e-6)
    assert not d.any()  # the last row, all zero, gives the zero aggregate
    assert reduce_apply.LIBRARY.path().exists()


@pytest.mark.cuda
def test_reduce_apply_rejects_a_dense_stack_of_odd_rows():
    """A dense [K, N] stack with N % 4 != 0 puts odd rows 8 bytes off a
    16-byte boundary: the wrapper refuses it rather than launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 1_000_002
    p = torch.zeros(n, device="cuda")
    before = fused_reduce_apply.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_reduce_apply(torch.zeros(3, n, device="cuda"),
                           torch.ones(3, device="cuda"), p, 1.0)
    assert fused_reduce_apply.launches == before


@pytest.mark.cuda
def test_flash_attention_grads_on_card():
    """The autograd.Function (kernel forward, recomputed backward)
    against autograd of the plain causal attention, f32, within 2e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(16, 80, 128, device="cuda", generator=gen)
               for _ in range(3))
    g = torch.randn(16, 80, 128, device="cuda", generator=gen)
    got = torch.autograd.grad(
        fa.flash_attention(*(x.requires_grad_() for x in (q, k, v)), 2),
        (q, k, v), g)
    want = torch.autograd.grad(causal_attention(q, k, v, 2), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q = torch.zeros(4, 80, 64, device="cuda")
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        fa.attention_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                             q, q)
    with pytest.raises(ValueError, match="k is"):
        fa.attention_forward(q, q[:, :40], q)
    with pytest.raises(ValueError, match="head dims"):
        x = torch.zeros(4, 80, 48, device="cuda")
        fa.attention_forward(x, x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        x = q.half()
        fa.attention_forward(x, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        # the bf16 kernel's cp.async reads 16-byte vectors
        buf = torch.zeros(q.numel() + 1, device="cuda", dtype=torch.bfloat16)
        x = buf[1:].view(q.shape)
        fa.attention_forward(x, x, x)
    assert fa.flash_attention.launches == before
