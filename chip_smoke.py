#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``
(the kernels are built from ``colearn_federated_learning_tpu_torch/ops/
csrc`` at first use, one ``nvcc`` per source, all at once). Phases, each
of which fails the run:

1. build the hand-written CUDA kernels (``fused_delta_apply``,
   ``fused_reduce_apply``, ``flash_attention``);
2. hold ``fused_delta_apply`` against its plain PyTorch version on
   random f32 vectors of the ResNet-18 length, of MobileNetV2's length
   (2 mod 4: the scalar tail runs) and of an odd length, both branches
   (no momentum / momentum), bit for bit;
3. hold ``fused_reduce_apply`` against its plain version on a K = 16
   stack at the same lengths, both branches, with random weights, a
   one-hot row and an all-zero row, within the same tolerance;
4. hold ``flash_attention`` against its plain version, causal and not,
   at (B·H, T, hd) = (32, 80, 64) (the BERT-tiny path's shape), at ViT's
   ragged T = 197 (hd 64), at T = 50 and 48 with hd 16 and 128, at
   T = 50 with hd 32 and at ViT-B/16's eval shape (768, 197, 64), in f32
   within 2e-5 abs + 2e-5 rel and in bf16
   within one bf16 ulp of the plain output plus 2e-5 (both compute in
   f32 and round once; the 2e-5 covers outputs near zero, where the f32
   sums cancel and the two orders of summation differ by more than a
   bf16 ulp); and one backward through its ``autograd.Function``
   against autograd of the plain causal attention, f32, within 2e-5;
5. time each kernel, its plain version and the library calls that
   compute the same (or part of the same) function, beside the card's
   bound for the bytes the pass must move and the operations it does
   (``flash_attention``: each branch, causal, at the path's shape, and
   the f32 branch also non-causal at ViT's eval shape, beside
   ``scaled_dot_product_attention`` on the same inputs, as device time
   with the host held off, since at the path's size a call costs the
   host more than the card;
   ``fused_delta_apply`` also at MobileNetV2's length beside
   ``torch.add``, with the L2 cold before each call, as the path's one
   call a round finds it);
6. drive the first path — ``fit`` of ``cifar10_fedavg_100`` (ResNet-18
   at full width, synthetic CIFAR-10 at its real 50,000 / 1,000
   cardinality, cohort 16, bf16 local training, the fused server apply)
   for 3 rounds — and check finite losses, params that moved, one
   ``fused_delta_apply`` launch per round; ``evaluate`` the checkpoint
   through the CLI in a fresh process and require the final
   ``eval_loss`` bit for bit;
7. drive the second path — ``fit`` of ``cifar10_krum_byzantine`` (the
   same federation under a sign-flipping adversary, defended by Krum,
   with the fused apply) for 3 rounds — and check finite losses, params
   that moved, one ``fused_reduce_apply`` launch per round and none of
   ``fused_delta_apply``, and ``byzantine_count`` in every round's
   record; then, on one round's stack, the fused route (Krum's one-hot
   row through the kernel) and the unfused route (``robust_reduce`` +
   the plain apply) must agree within 1e-6;
8. drive both CIFAR-10 paths again for 2 rounds each under
   ``server.optimizer=fedavgm`` (server momentum β = 0.9) and check
   finite losses, one launch a round of the momentum branch of each
   path's kernel and none of the others, and on the Krum path the fused
   route against the unfused one, momentum included, within 1e-6;
9. drive the third path — ``fit`` of ``shakespeare_fedavg`` (BERT-tiny
   at its published geometry, 128 natural clients of the synthetic
   Markov-chain corpus, cohort 32, bf16 compute) with
   ``model.kwargs.attention=pallas`` for 3 rounds, evaluating after the
   third — and check finite losses, params that moved, a bf16
   ``flash_attention`` launch for each layer of every local step run
   and every eval batch (counted from the round's masks and eval's
   batches), and no launch of the two apply kernels; it also prints the
   first round's train loss under ``attention=full`` from the same
   init, beside the ``pallas`` one (not gated); then the same path at
   f32 compute and local params for 2 rounds, whose launches must all
   be of the f32 branch;
10. drive the fourth path — ``fit`` of ``femnist_fedprox_500`` (FedProx,
   μ = 0.01, of MobileNetV2 at width 1.0 over 500 synthetic FEMNIST
   clients, cohort 32, bf16 local training, the fused server apply) for
   12 rounds, evaluating after the last — and check finite losses, one
   ``fused_delta_apply`` launch per round and none of the other kernels,
   ``algorithm: "fedprox"`` in every round's record, a final eval loss
   below the untrained model's and below ln 62 (a uniform guess over the
   62 classes, which an untrained model that only calibrated its logits
   would reach), and eval accuracy above chance (1/62);
11. drive the fifth path — ``fit`` of ``cifar10_fedavg_1000`` (ResNet-18
   at full width, 1000 Dirichlet clients over synthetic CIFAR-10's
   50,000 examples, cohort 64, bf16 local training, the fused server
   apply) for 2 rounds — and check finite losses and one
   ``fused_delta_apply`` launch per round and none of the others.

Each path is driven with every launch count set to 0 just before it and
read just after. The lines before the last report the card
(``nvidia-smi`` name and power limit), the timings and a
``{"kernels": [...]}`` summary; the last line is ``{"ok": true,
"device": {...}}`` and is printed only when every phase passed. Without
a CUDA device, or outside the repository, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_RESNET18 = 11_173_962  # ResNet-18 (width 64) parameter count
N_MOBILENET = 2_302_718  # MobileNetV2 (width 1.0, 62 classes)
N_ODD = 1_000_003
K_COHORT = 16  # the cohort of both configs
ATOL = RTOL = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
ROUNDS = 3
FEMNIST_ROUNDS = 12
SHORT_ROUNDS = 2  # the fedavgm paths, shakespeare in f32, cifar10_fedavg_1000
DATA_SETS = ("data.synthetic_train_size=50000",
             "data.synthetic_test_size=1000")
PALLAS = "colearn_federated_learning_tpu/ops/pallas_apply.py"
PALLAS_ATTENTION = "colearn_federated_learning_tpu/ops/pallas_attention.py"
CSRC = "colearn_federated_learning_tpu_torch/ops/csrc/"
# flash_attention's checks: (B·H, T, hd); the first is the path's shape,
# the last ViT-B/16's eval (batch 64 x 12 heads, 197 tokens, non-causal)
VIT_SHAPE = (768, 197, 64)
ATTN_SHAPES = ((32, 80, 64), (4, 197, 64), (6, 50, 16), (6, 48, 16),
               (3, 50, 128), (3, 48, 128), (5, 50, 32), VIT_SHAPE)
ATTN_ATOL = ATTN_RTOL = 2e-5
BERT_HEADS = 2
VIT_HEADS = 12
# each kernel's count of its second branch, beside ``launches``
BRANCH_COUNTS = {"fused_delta_apply": "momentum_launches",
                 "fused_reduce_apply": "momentum_launches",
                 "flash_attention": "f32_launches"}
FEDAVGM = "server.optimizer=fedavgm"
F32_SETS = ("run.compute_dtype=float32", "run.local_param_dtype=float32")
SHAKESPEARE_F32 = "shakespeare_fedavg (float32)"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events around the whole run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, warmup: int = 10,
              sleep_cycles: int = 400_000_000, tries: int = 3) -> dict:
    """Device time of ``fn`` when the host is out of the way: a sleep
    kernel holds the stream while the host enqueues ``iters`` calls, and
    CUDA events around the calls time only their execution (for launches
    that cost the host more than the device). A sleep that ends before
    the enqueue does would let host time in, so it is retried four
    times longer, and after ``tries`` such runs this raises (as it must
    when ``iters`` calls hold more launches than the device queues:
    the host then waits for the sleeping card).
    ``back_to_back_ms`` is the plain event timing of :func:`time_ms`,
    host time included."""
    import torch

    back_to_back = time_ms(fn, iters, warmup)
    sleep_start = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(tries):
        torch.cuda.synchronize()
        sleep_start.record()
        torch.cuda._sleep(sleep_cycles)  # 400M cycles: ~0.2 s of clock
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if sleep_start.elapsed_time(start) > enqueue_ms:
            return {"ms": start.elapsed_time(end) / iters,
                    "back_to_back_ms": back_to_back}
        sleep_cycles *= 4
    raise RuntimeError(f"device_ms: the sleep did not outlast the host's "
                       f"enqueue of {iters} calls in {tries} tries")


def cold_ms(fn, iters: int = 21, flush_bytes: int = 256 << 20) -> float:
    """Median device time of one call of ``fn`` with the 50 MB L2 cold:
    before each call a ``flush_bytes`` write evicts it and keeps the
    card busy while the host enqueues the call, and CUDA events around
    the call time it alone (for a pass whose data fits in L2, which
    back-to-back calls would find there)."""
    import torch

    flush = torch.empty(flush_bytes // 4, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]


def bound_ms(nbytes: int, flops: int,
             flops_per_s: float = F32_FLOPS_PER_S) -> dict:
    """Least time for a pass on this card: ``nbytes`` moved (each input
    read once, each output written once) against the memory rate, and
    ``flops`` against the peak for their type (f32 by default); the
    larger bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def delta_bound(n: int, momentum: bool) -> dict:
    return bound_ms((5 if momentum else 3) * 4 * n,
                    (4 if momentum else 2) * n)


def reduce_bound(k: int, n: int, momentum: bool) -> dict:
    """K stack rows and p (and m) read, p (and m) and Δ̄ written; a
    multiply and an add per row, then the apply."""
    return bound_ms((k + (5 if momentum else 3)) * 4 * n,
                    (2 * k + (4 if momentum else 2)) * n)


def attention_bound(bh: int, t: int, hd: int, elem_bytes: int,
                    causal: bool) -> dict:
    """q, k, v read and o written once; the two products over the
    (query, key) pairs the mask keeps, at the bf16 tensor-core peak."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return bound_ms(4 * bh * t * hd * elem_bytes, 2 * 2 * bh * pairs * hd,
                    BF16_FLOPS_PER_S)


def bf16_ulp(x):
    """One bf16 ulp at each element of ``x``, exact: the power of two of
    x's exponent field, times 2⁻⁷."""
    import torch

    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return (mag.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0**-7


def assert_close(pairs, what: str, atol: float = ATOL,
                 rtol: float = RTOL) -> float:
    """Max abs error over ``(got, want)`` pairs; raises past the
    tolerance."""
    import torch

    err = 0.0
    for got, want in pairs:
        err = max(err, float((got - want).abs().max()))
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(
                f"{what}: disagrees with its plain version, max abs err "
                f"{err}")
    return err


def build_phase(libraries) -> None:
    from colearn_federated_learning_tpu_torch.ops._build import build_all

    t0 = time.perf_counter()
    build_all(libraries)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for lib in libraries:
        log = lib.path().with_suffix(".log")
        ptxas[lib.source.name] = (
            [ln.strip() for ln in log.read_text().splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln] if log.exists() else [])
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": [os.path.relpath(lib.path(), ROOT)
                        for lib in libraries], "ptxas": ptxas})


def check_delta_kernel(server_apply, n: int, momentum: bool,
                       seed: int) -> float:
    """``fused_delta_apply`` vs its plain version on the same random
    inputs; returns the max abs error and raises unless every element is
    bit for bit the plain version's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    d = torch.randn(n, device="cuda", generator=gen) * 0.01
    m = torch.randn(n, device="cuda", generator=gen) * 0.01 if momentum else None
    lr, beta = 0.7, 0.9
    want_p, want_m = server_apply.delta_apply_reference(p, d, lr, m, beta)
    server_apply.fused_delta_apply(p, d, lr, m, beta)
    torch.cuda.synchronize()
    pairs = [(p, want_p)] + ([(m, want_m)] if momentum else [])
    return assert_close(pairs, f"fused_delta_apply (n={n}, "
                               f"momentum={momentum})", atol=0.0, rtol=0.0)


def delta_kernel_phase(server_apply) -> dict:
    import torch

    errs = {}
    for n in (N_RESNET18, N_MOBILENET, N_ODD):
        for momentum in (False, True):
            errs[(n, momentum)] = check_delta_kernel(server_apply, n,
                                                     momentum,
                                                     seed=n + momentum)
    emit({"phase": "delta_kernel_vs_plain", "tolerance": "bit for bit",
          "max_abs_err": {f"n={n},momentum={mo}": e
                          for (n, mo), e in errs.items()}})

    n, lr, beta = N_RESNET18, 1.0, 0.9
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    d = torch.randn(n, device="cuda", generator=gen) * 1e-4
    m = torch.zeros(n, device="cuda")
    rows = {}
    for momentum in (False, True):
        mo = m if momentum else None
        rows[momentum] = {
            "max_abs_err": max(e for (_, mom), e in errs.items()
                               if mom == momentum),
            "ms": time_ms(lambda: server_apply.fused_delta_apply(
                p, d, lr, mo, beta)),
            "plain_ms": time_ms(lambda: server_apply.delta_apply_reference(
                p, d, lr, mo, beta)),
            "library_ms": None if momentum else time_ms(
                lambda: torch.add(p, d, alpha=lr)),
            **delta_bound(n, momentum),
        }
    # the mean branch at the femnist path's length: its 27.6 MB fit in
    # L2, which back-to-back calls would find there; the path's one call
    # a round finds them cold
    small = p[:N_MOBILENET].clone(), d[:N_MOBILENET].clone()
    mobilenet = dict(
        delta_bound(N_MOBILENET, False),
        cold_ms=cold_ms(lambda: server_apply.fused_delta_apply(*small, lr)),
        library_cold_ms=cold_ms(lambda: torch.add(*small, alpha=lr)))
    emit({"phase": "delta_kernel_timing", "n": n,
          "mean": rows[False], "fedavgm": rows[True],
          "mean_at_mobilenet_n": dict(mobilenet, n=N_MOBILENET)})
    return rows


def reduce_inputs(reduce_apply, n: int, seed: int):
    """A K-row stack (rows 16-byte aligned) of small deltas, and the
    weight rows the paths feed the kernel: random FedAvg-like weights,
    Krum's one-hot row and the all-zero row of an empty round."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    stack = reduce_apply.new_stack(K_COHORT, n, "cuda")
    for r in range(K_COHORT):
        stack[r].copy_(torch.randn(n, device="cuda", generator=gen) * 0.01)
    random_w = torch.rand(K_COHORT, device="cuda", generator=gen)
    weights = {"random": random_w / random_w.sum(),
               "one_hot": torch.eye(K_COHORT, device="cuda")[7],
               "zero": torch.zeros(K_COHORT, device="cuda")}
    return stack, weights, gen


def reduce_kernel_phase(reduce_apply) -> dict:
    import torch

    errs = {}
    lr, beta = 0.7, 0.9
    for n in (N_RESNET18, N_ODD):
        stack, weights, gen = reduce_inputs(reduce_apply, n, seed=n)
        for momentum in (False, True):
            for wname, w in weights.items():
                p = torch.randn(n, device="cuda", generator=gen) * 0.05
                m = (torch.randn(n, device="cuda", generator=gen) * 0.01
                     if momentum else None)
                want_p, want_m, want_d = reduce_apply.reduce_apply_reference(
                    stack, w, p, lr, m, beta)
                _, _, d = reduce_apply.fused_reduce_apply(stack, w, p, lr, m,
                                                          beta)
                torch.cuda.synchronize()
                pairs = [(d, want_d), (p, want_p)]
                if momentum:
                    pairs.append((m, want_m))
                errs[(n, momentum, wname)] = assert_close(
                    pairs, f"fused_reduce_apply (n={n}, momentum={momentum}, "
                           f"weights={wname})")
        del stack
    emit({"phase": "reduce_kernel_vs_plain", "k": K_COHORT, "atol": ATOL,
          "rtol": RTOL,
          "max_abs_err": {f"n={n},momentum={mo},weights={w}": e
                          for (n, mo, w), e in errs.items()}})

    n = N_RESNET18
    stack, weights, gen = reduce_inputs(reduce_apply, n, seed=2)
    w = weights["random"]
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    m = torch.zeros(n, device="cuda")
    d = torch.empty(n, device="cuda")
    rows = {}
    for momentum in (False, True):
        mo = m if momentum else None
        row = {
            "max_abs_err": max(e for (_, mom, _), e in errs.items()
                               if mom == momentum),
            "ms": time_ms(lambda: reduce_apply.fused_reduce_apply(
                stack, w, p, lr, mo, beta, delta=d)),
            "plain_ms": time_ms(lambda: reduce_apply.reduce_apply_reference(
                stack, w, p, lr, mo, beta), iters=20),
            "library_ms": None,
            "library_call": None,
            **reduce_bound(K_COHORT, n, momentum),
        }
        if not momentum:
            # no single PyTorch call returns both p′ and Δ̄: addmv gives
            # p′ alone, mv + add_ gives both in two calls
            row["library_ms"] = time_ms(
                lambda: torch.addmv(p, stack.T, w, alpha=lr))
            row["library_call"] = ("torch.addmv(p, S.T, w, alpha=lr) "
                                   "(params' only)")
            row["mv_add_ms"] = time_ms(
                lambda: p.clone().add_(torch.mv(stack.T, w), alpha=lr))
            row["mv_add_call"] = ("torch.mv(S.T, w) then p.add_(d, alpha=lr) "
                                  "(both outputs; includes a clone of p)")
        rows[momentum] = row
    emit({"phase": "reduce_kernel_timing", "k": K_COHORT, "n": n,
          "mean": rows[False], "fedavgm": rows[True]})
    return rows


def flash_kernel_phase(fa) -> dict:
    """``flash_attention`` against its plain version at ATTN_SHAPES, both
    masks, f32 and bf16; one backward; then its timing at the path's
    shape."""
    import torch

    from colearn_federated_learning_tpu_torch.ops.attention import (
        causal_attention,
    )

    errs, ulp_ratio = {}, 0.0
    for shape in ATTN_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device="cuda").manual_seed(
                    sum(shape) + causal)
                q, k, v = (torch.randn(shape, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(3))
                want = fa.attention_reference(q, k, v, causal)
                got = fa.attention_forward(q, k, v, causal)
                torch.cuda.synchronize()
                what = (f"flash_attention {shape} causal={causal} "
                        f"{str(dtype)[6:]}")
                err = (got.float() - want.float()).abs()
                if dtype == torch.float32:
                    ok = bool((err <= ATTN_ATOL
                               + ATTN_RTOL * want.abs()).all())
                else:
                    # one bf16 ulp, plus the f32 tolerance's absolute term
                    # for outputs near zero, whose f32 sums cancel
                    ratio = float((err / (bf16_ulp(want) + ATTN_ATOL)).max())
                    ulp_ratio = max(ulp_ratio, ratio)
                    ok = ratio <= 1.0
                if not ok or got.shape != q.shape or got.dtype != dtype:
                    raise AssertionError(
                        f"{what}: disagrees with its plain version, max abs "
                        f"err {float(err.max())}")
                errs[what] = float(err.max())

    # the backward: the kernel's forward, the recomputed gradient
    b, t, d = 16, 80, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, g = (torch.randn(b, t, d, device="cuda", generator=gen)
                  for _ in range(4))
    got = torch.autograd.grad(
        fa.flash_attention(*(x.requires_grad_() for x in (q, k, v)),
                           BERT_HEADS), (q, k, v), g)
    want = torch.autograd.grad(causal_attention(q, k, v, BERT_HEADS),
                               (q, k, v), g)
    grad_err = assert_close(list(zip(got, want)), "flash_attention grads",
                            ATTN_ATOL, ATTN_RTOL)
    f32_err = max(e for w, e in errs.items() if w.endswith("float32"))
    bf16_err = max(e for w, e in errs.items() if w.endswith("bfloat16"))
    emit({"phase": "flash_kernel_vs_plain", "atol_f32": ATTN_ATOL,
          "rtol_f32": ATTN_RTOL, "bf16_tolerance": "1 bf16 ulp + 2e-5",
          "max_abs_err": errs, "bf16_max_err_over_tolerance": ulp_ratio,
          "grad_max_abs_err": grad_err})

    path = attention_timing(fa, ATTN_SHAPES[0], torch.bfloat16, True,
                            BERT_HEADS)
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.add_(1.0))
    rows = {
        "bf16": dict(path, max_abs_err=bf16_err,
                     # a one-element kernel: what any launch costs here
                     launch_floor_ms=floor["ms"],
                     launch_floor_back_to_back_ms=floor["back_to_back_ms"]),
        # the f32 branch at the path's shape, and at ViT's eval shape
        "f32": dict(attention_timing(fa, ATTN_SHAPES[0], torch.float32,
                                     True, BERT_HEADS),
                    max_abs_err=f32_err,
                    vit=attention_timing(fa, VIT_SHAPE, torch.float32, False,
                                         VIT_HEADS)),
    }
    emit({"phase": "flash_kernel_timing", **rows})
    return rows


def attention_timing(fa, shape, dtype, causal: bool, heads: int) -> dict:
    """Device times of the kernel, its plain version and
    ``scaled_dot_product_attention`` on the same random ``shape`` inputs,
    with the host held off (``device_ms``): at the path's size one call
    costs the host more than the card."""
    import torch

    bh, t, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    # scaled_dot_product_attention on the same tensors as [B, H, T, hd]
    bhtd = (bh // heads, heads, t, hd)
    q4, k4, v4 = (x.view(bhtd) for x in (q, k, v))
    kernel = device_ms(lambda: fa.attention_forward(q, k, v, causal))
    # the plain version launches ~30 kernels a call: 20 calls stay below
    # the device's queue of pending launches, past which the host waits
    # for the sleeping card and the enqueue can never be hidden
    plain = device_ms(lambda: fa.attention_reference(q, k, v, causal),
                      iters=20)
    library = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
    return {"shape": list(shape), "dtype": str(dtype)[6:], "causal": causal,
            "ms": kernel["ms"], "plain_ms": plain["ms"],
            "library_ms": library["ms"],
            "library_call": "torch.nn.functional.scaled_dot_product_"
                            f"attention(q, k, v, is_causal={causal}) on "
                            f"{list(bhtd)} {str(dtype)[6:]}",
            "back_to_back_ms": {"kernel": kernel["back_to_back_ms"],
                                "plain": plain["back_to_back_ms"],
                                "library": library["back_to_back_ms"]},
            **attention_bound(bh, t, hd, q.element_size(), causal)}


def reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0
        setattr(fn, BRANCH_COUNTS[fn.__name__], 0)


def read_counts(kernels) -> dict:
    return {fn.__name__: {"launches": fn.launches,
                          BRANCH_COUNTS[fn.__name__]: getattr(
                              fn, BRANCH_COUNTS[fn.__name__])}
            for fn in kernels}


def make_experiment(name: str, sets, out_dir: str):
    """The config's ``Experiment`` on the card, with the device's peak
    memory counted from here; returns it and its set-up time."""
    import torch

    from colearn_federated_learning_tpu_torch.cli import parse_overrides
    from colearn_federated_learning_tpu_torch.config import resolve_config
    from colearn_federated_learning_tpu_torch.server.round_driver import (
        Experiment,
    )

    cfg = resolve_config(name, {"run.out_dir": out_dir,
                                **parse_overrides(sets)})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exp = Experiment(cfg, device="cuda")
    return exp, time.perf_counter() - t0


def fit_and_check(exp, kernels, rounds: int = ROUNDS,
                  state=None) -> dict:
    """Drive ``fit`` for ``rounds`` rounds with every launch count at 0;
    check finite losses and moved params; return the records, counts and
    timings."""
    import torch

    if state is None:
        state = exp.init_state()
    p0 = state["params"].clone()
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state = exp.fit(state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts(kernels)
    records = [r for r in exp.logger.history if "train_loss" in r]
    losses = [r["train_loss"] for r in records]
    if len(losses) != rounds or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite per round: {losses}")
    if torch.equal(p0, state["params"]):
        raise AssertionError("params did not change over the fit")
    return {"state": state, "records": records, "losses": losses,
            "counts": counts, "fit_s": fit_s}


def steady_round_s(exp, state, first: int = ROUNDS) -> float:
    """Best wall time of 2 more rounds on warm caches, from round
    ``first``."""
    import torch

    steady = []
    for r in range(first, first + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = exp.run_round(state, r)
        float(state.pop("_metrics").train_loss)
        steady.append(time.perf_counter() - t0)
    return min(steady)


def only_kernel(counts, name: str, rounds: int, path: str,
                momentum: bool = False) -> None:
    """One launch a round of ``name``'s momentum branch (``momentum``) or
    of its other branch, and no launch of any other kernel, or raise."""
    want = {fn: {"launches": 0, branch: 0}
            for fn, branch in BRANCH_COUNTS.items()}
    want[name] = {"launches": rounds,
                  BRANCH_COUNTS[name]: rounds * momentum}
    if counts != want:
        raise AssertionError(f"the {path} path launched {counts} in "
                             f"{rounds} rounds (want {want})")


def path_numbers(exp, run, setup_s: float, round_s: float) -> dict:
    import torch

    cohort = exp.cfg.server.cohort_size
    return {"setup_s": round(setup_s, 3), "fit_s": round(run["fit_s"], 3),
            "steady_round_s": round(round_s, 4),
            "rounds_per_sec": round(1.0 / round_s, 4),
            "client_updates_per_sec": round(cohort / round_s, 4),
            "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}


def fedavg_path_phase(kernels) -> dict:
    out_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    sets = DATA_SETS + (f"server.num_rounds={ROUNDS}",
                        "server.fused_apply=true")
    exp, setup_s = make_experiment("cifar10_fedavg_100", sets, out_dir)
    run = fit_and_check(exp, kernels)
    counts = run["counts"]
    only_kernel(counts, "fused_delta_apply", ROUNDS, "cifar10_fedavg_100")
    state = run["state"]
    final = exp.evaluate(state["params"])
    if not math.isfinite(final["eval_loss"]):
        raise AssertionError(f"eval loss not finite: {final}")

    cmd = [sys.executable, "-m", "colearn_federated_learning_tpu_torch",
           "evaluate", "--config", "cifar10_fedavg_100", "--out-dir", out_dir,
           "--device", "cuda"]
    for s in sets:
        cmd += ["--set", s]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"evaluate failed: {proc.stderr[-2000:]}")
    reloaded = json.loads(proc.stdout.strip().splitlines()[-1])
    if reloaded["eval_loss"] != final["eval_loss"]:
        raise AssertionError(
            f"evaluate from the checkpoint gave {reloaded['eval_loss']!r}, "
            f"fit ended at {final['eval_loss']!r}")
    round_s = steady_round_s(exp, state)
    emit({"phase": "fedavg_path", "config": "cifar10_fedavg_100",
          "rounds": ROUNDS, "launches": counts, "train_loss": run["losses"],
          "eval_loss": final["eval_loss"], "eval_acc": final["eval_acc"],
          "evaluate_eval_loss": reloaded["eval_loss"],
          **path_numbers(exp, run, setup_s, round_s)})
    return counts


def krum_path_phase(kernels, reduce_apply, server_apply) -> dict:
    sets = DATA_SETS + (f"server.num_rounds={ROUNDS}",
                        "server.fused_apply=true")
    exp, setup_s = make_experiment("cifar10_krum_byzantine", sets, "")
    run = fit_and_check(exp, kernels)
    counts = run["counts"]
    only_kernel(counts, "fused_reduce_apply", ROUNDS,
                "cifar10_krum_byzantine")
    records = run["records"]
    if any("byzantine_count" not in r for r in records):
        raise AssertionError(f"byzantine_count missing from {records}")
    state = run["state"]
    # before the route check, whose second stack is not the path's
    numbers = path_numbers(exp, run, setup_s, steady_round_s(exp, state))

    route = krum_route_check(exp, state, reduce_apply, server_apply)
    emit({"phase": "krum_path", "config": "cifar10_krum_byzantine",
          "rounds": ROUNDS, "launches": counts, "train_loss": run["losses"],
          "byzantine_count": [r["byzantine_count"] for r in records],
          "krum_selected_byzantine": [r.get("krum_selected_byzantine")
                                      for r in records],
          "compromised_winners": sum(r.get("krum_selected_byzantine", 0)
                                     for r in records),
          "n_compromised": int(len(exp.compromised)), **route, **numbers})
    return counts


def krum_route_check(exp, state, reduce_apply, server_apply) -> dict:
    """On one more round's stack, the fused route (Krum's one-hot row
    through the kernel) against the unfused one (``robust_reduce`` + the
    plain apply), with the server momentum under ``fedavgm``: Δ̄, the
    params and the momentum must agree within 1e-6."""
    import numpy as np
    import torch

    from colearn_federated_learning_tpu_torch.server.aggregation import (
        krum_select,
        krum_weights,
        robust_reduce,
    )

    params = state["params"]
    trace = state["server_opt_state"]["opt"].get("trace")
    cfg = exp.cfg
    beta = cfg.server.server_momentum if trace is not None else 0.0
    cohort, idx, mask, n_ex, step_counts = exp._round_inputs(ROUNDS + 2)
    byz = np.isin(np.asarray(cohort), exp.compromised).astype(np.float32)
    n_ex = np.asarray(n_ex, np.float32)
    stack, _ = exp.round_fn.upload_stack(params, exp.train_x, exp.train_y,
                                         idx, mask, n_ex, step_counts, byz)
    part = torch.as_tensor(n_ex, device="cuda") > 0
    f = cfg.server.krum_byzantine
    winner, m = krum_select(stack, part, f, exp.layout)
    p_fused = params.clone()
    m_fused = None if trace is None else trace.clone()
    _, _, d_fused = reduce_apply.fused_reduce_apply(
        stack, krum_weights(winner, m, stack.shape[0]), p_fused,
        cfg.server.server_lr, m_fused, beta)
    d_unfused = robust_reduce(stack, part, "krum", exp.layout,
                              byzantine_f=f)
    p_unfused, m_unfused = server_apply.delta_apply_reference(
        params, d_unfused, cfg.server.server_lr, trace, beta)
    torch.cuda.synchronize()
    pairs = [(d_fused, d_unfused), (p_fused, p_unfused)]
    if trace is not None:
        pairs.append((m_fused, m_unfused))
    return {"fused_vs_unfused_max_abs_err": assert_close(
                pairs, "fused vs unfused Krum route"),
            "route_check_winner_slot": int(winner),
            "route_check_winner_byzantine": int(byz[int(winner)]),
            "stack_gb": round(stack.numel() * 4 / 1e9, 3)}


def fedavgm_path_phase(kernels, reduce_apply, server_apply) -> dict:
    """The two CIFAR-10 paths for SHORT_ROUNDS rounds under
    ``server.optimizer=fedavgm`` (β = ``server.server_momentum``): one
    launch a round of the momentum branch of each path's kernel and none
    of the others, finite losses, and on the Krum path the fused route
    against the unfused one, momentum included."""
    counts = {}
    for config, kernel in (("cifar10_fedavg_100", "fused_delta_apply"),
                           ("cifar10_krum_byzantine", "fused_reduce_apply")):
        sets = DATA_SETS + (f"server.num_rounds={SHORT_ROUNDS}",
                            "server.fused_apply=true", FEDAVGM)
        exp, setup_s = make_experiment(config, sets, "")
        run = fit_and_check(exp, kernels, SHORT_ROUNDS)
        path = f"{config} ({FEDAVGM})"
        only_kernel(run["counts"], kernel, SHORT_ROUNDS, path, momentum=True)
        route = (krum_route_check(exp, run["state"], reduce_apply,
                                  server_apply)
                 if kernel == "fused_reduce_apply" else {})
        emit({"phase": "fedavgm_path", "config": config,
              "server_momentum": exp.cfg.server.server_momentum,
              "rounds": SHORT_ROUNDS, "launches": run["counts"],
              "train_loss": run["losses"], "setup_s": round(setup_s, 3),
              "fit_s": round(run["fit_s"], 3), **route})
        counts[path] = run["counts"]
        del exp, run
    return counts


def shakespeare_path_phase(kernels, f32: bool = False) -> dict:
    """``shakespeare_fedavg`` under ``attention=pallas``, eval after the
    last round: at its preset's bf16 compute for ROUNDS rounds, which
    runs the kernel's bf16 branch in local training and eval alike, or
    (``f32``) at f32 compute and local params for SHORT_ROUNDS rounds,
    which runs its f32 branch."""
    rounds = SHORT_ROUNDS if f32 else ROUNDS
    sets = (f"server.num_rounds={rounds}", f"server.eval_every={rounds}",
            "model.kwargs.attention=pallas") + (F32_SETS if f32 else ())
    exp, setup_s = make_experiment("shakespeare_fedavg", sets, "")
    run = fit_and_check(exp, kernels, rounds)
    counts = run["counts"]
    # one launch per layer for every local step run (a step whose mask is
    # all zero is skipped) and for every eval batch, all of the branch of
    # the compute dtype
    steps_run = sum(int((exp._round_inputs(r)[4] > 0).sum())
                    for r in range(rounds))
    eval_batches = int(exp._eval_data[0].shape[0])
    layers = exp.model.layers
    want = layers * (steps_run + eval_batches)
    if (counts["flash_attention"] != {"launches": want,
                                      "f32_launches": want * f32}
            or counts["fused_delta_apply"]["launches"]
            or counts["fused_reduce_apply"]["launches"]):
        raise AssertionError(
            f"the shakespeare path launched {counts}; want {want} "
            f"{'f32' if f32 else 'bf16'} flash_attention launches ({layers} "
            f"layers x ({steps_run} local steps + {eval_batches} eval "
            f"batches)) and no other kernel")
    final = run["records"][-1]
    if not math.isfinite(final.get("eval_loss", math.nan)):
        raise AssertionError(f"eval loss not finite: {final}")
    if f32:
        emit({"phase": "shakespeare_f32_path", "config": "shakespeare_fedavg",
              "sets": list(sets), "rounds": rounds, "launches": counts,
              "local_steps_run": steps_run, "eval_batches": eval_batches,
              "train_loss": run["losses"], "eval_loss": final["eval_loss"],
              "setup_s": round(setup_s, 3), "fit_s": round(run["fit_s"], 3)})
        return counts
    numbers = path_numbers(exp, run, setup_s,
                           steady_round_s(exp, run.pop("state")))
    del exp

    # the first round under full attention from the same init (not gated)
    full, _ = make_experiment("shakespeare_fedavg", (
        f"server.num_rounds={ROUNDS}", "model.kwargs.attention=full"), "")
    first = full.run_round(full.init_state(), 0)
    full_loss = float(first["_metrics"].train_loss)
    emit({"phase": "shakespeare_path", "config": "shakespeare_fedavg",
          "attention": "pallas", "rounds": ROUNDS, "launches": counts,
          "flash_launches_expected": want, "local_steps_run": steps_run,
          "eval_batches": eval_batches, "train_loss": run["losses"],
          "eval_loss": final["eval_loss"], "eval_acc": final["eval_acc"],
          "first_round_train_loss_full_attention": full_loss,
          **numbers})
    return counts


def femnist_path_phase(kernels) -> dict:
    rounds = FEMNIST_ROUNDS
    sets = (f"server.num_rounds={rounds}", f"server.eval_every={rounds}",
            "server.fused_apply=true")
    exp, setup_s = make_experiment("femnist_fedprox_500", sets, "")
    state = exp.init_state()
    untrained = exp.evaluate(state["params"])
    run = fit_and_check(exp, kernels, rounds, state)
    counts = run["counts"]
    only_kernel(counts, "fused_delta_apply", rounds, "femnist_fedprox_500")
    records = run["records"]
    if any(r.get("algorithm") != "fedprox" for r in records):
        raise AssertionError(f"algorithm 'fedprox' missing from {records}")
    final = records[-1]
    classes = exp.cfg.model.num_classes
    loss, acc = final.get("eval_loss", math.inf), final.get("eval_acc", 0.0)
    if not (loss < min(untrained["eval_loss"], math.log(classes))
            and acc > 1.0 / classes):
        raise AssertionError(
            f"after {rounds} rounds eval loss {loss} is not below both the "
            f"untrained model's {untrained['eval_loss']} and ln {classes} "
            f"= {math.log(classes)}, or eval accuracy {acc} is not above "
            f"1/{classes}")
    round_s = steady_round_s(exp, run["state"], rounds)
    emit({"phase": "femnist_path", "config": "femnist_fedprox_500",
          "algorithm": exp.cfg.algorithm, "prox_mu": exp.cfg.client.prox_mu,
          "params": exp.layout.numel, "rounds": rounds, "launches": counts,
          "train_loss": run["losses"],
          "untrained_eval_loss": untrained["eval_loss"],
          "untrained_eval_acc": untrained["eval_acc"],
          "eval_loss": final["eval_loss"], "eval_acc": final["eval_acc"],
          "local_steps_run": sum(int((exp._round_inputs(r)[4] > 0).sum())
                                 for r in range(rounds)),
          **path_numbers(exp, run, setup_s, round_s)})
    return counts


def fedavg_1000_path_phase(kernels) -> dict:
    rounds = SHORT_ROUNDS
    sets = (f"server.num_rounds={rounds}", "server.fused_apply=true")
    exp, setup_s = make_experiment("cifar10_fedavg_1000", sets, "")
    run = fit_and_check(exp, kernels, rounds)
    counts = run["counts"]
    only_kernel(counts, "fused_delta_apply", rounds, "cifar10_fedavg_1000")
    round_s = steady_round_s(exp, run["state"], rounds)
    emit({"phase": "fedavg_1000_path", "config": "cifar10_fedavg_1000",
          "clients": exp.fed.num_clients,
          "train_examples": int(exp.fed.train_x.shape[0]),
          "rounds": rounds, "launches": counts, "train_loss": run["losses"],
          "local_steps_run": sum(int((exp._round_inputs(r)[4] > 0).sum())
                                 for r in range(rounds)),
          **path_numbers(exp, run, setup_s, round_s)})
    return counts


def kernel_rows(delta, reduce, flash, counts_by_path) -> list:
    """The six rows of the kernel table, one a branch. ``launches`` is
    each branch's count on the path that runs it; ``launches_by_path``
    gives it on every path."""
    def row(name, source, replaces, timing, fn_name, branch, path):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        counter = BRANCH_COUNTS[fn_name]
        by_path = {p: (c[fn_name][counter] if branch
                       else c[fn_name]["launches"] - c[fn_name][counter])
                   for p, c in counts_by_path.items()}
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": replaces, "launches": by_path[path],
               "launches_by_path": by_path}
        out.update({k: timing[k] for k in keys})
        if "library_call" in timing:
            out["library_call"] = timing["library_call"]
        return out

    flash_src = f"{PALLAS_ATTENTION}:141"
    return [
        row("fused_delta_apply", "server_apply.cu", f"{PALLAS}:222",
            delta[False], "fused_delta_apply", False, "cifar10_fedavg_100"),
        row("fused_delta_apply (momentum)", "server_apply.cu",
            f"{PALLAS}:209", delta[True], "fused_delta_apply", True,
            f"cifar10_fedavg_100 ({FEDAVGM})"),
        row("fused_reduce_apply (momentum)", "reduce_apply.cu",
            f"{PALLAS}:262", reduce[True], "fused_reduce_apply", True,
            f"cifar10_krum_byzantine ({FEDAVGM})"),
        row("fused_reduce_apply", "reduce_apply.cu", f"{PALLAS}:275",
            reduce[False], "fused_reduce_apply", False,
            "cifar10_krum_byzantine"),
        row("flash_attention (bf16)", "flash_attention.cu", flash_src,
            flash["bf16"], "flash_attention", False, "shakespeare_fedavg"),
        row("flash_attention (f32)", "flash_attention.cu", flash_src,
            flash["f32"], "flash_attention", True, SHAKESPEARE_F32),
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    try:
        from colearn_federated_learning_tpu_torch.ops import (
            flash_attention,
            reduce_apply,
            server_apply,
        )
    except ImportError as e:
        print(f"error: run from the repository root ({e})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    kernels = (server_apply.fused_delta_apply,
               reduce_apply.fused_reduce_apply,
               flash_attention.flash_attention)
    try:
        build_phase([server_apply.LIBRARY, reduce_apply.LIBRARY,
                     flash_attention.LIBRARY])
        delta = delta_kernel_phase(server_apply)
        reduce = reduce_kernel_phase(reduce_apply)
        flash = flash_kernel_phase(flash_attention)
        counts = {
            "cifar10_fedavg_100": fedavg_path_phase(kernels),
            "cifar10_krum_byzantine": krum_path_phase(kernels, reduce_apply,
                                                      server_apply),
            **fedavgm_path_phase(kernels, reduce_apply, server_apply),
            "shakespeare_fedavg": shakespeare_path_phase(kernels),
            SHAKESPEARE_F32: shakespeare_path_phase(kernels, f32=True),
            "femnist_fedprox_500": femnist_path_phase(kernels),
            "cifar10_fedavg_1000": fedavg_1000_path_phase(kernels),
        }
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"error: chip smoke failed: {e}", file=sys.stderr)
        return 1
    emit({"kernels": kernel_rows(delta, reduce, flash, counts)})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
