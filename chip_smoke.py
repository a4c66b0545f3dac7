#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``
(the kernel is built from ``colearn_federated_learning_tpu_torch/ops/
csrc`` at first use). Phases, each of which fails the run:

1. build the hand-written CUDA kernel (``fused_delta_apply``);
2. hold it against its plain PyTorch version on random f32 vectors of
   the ResNet-18 length and of an odd length, both branches
   (no momentum / momentum), within 1e-6 absolute + 1e-6 relative;
3. time the kernel, its plain version and one library call computing
   the same function (``torch.add(p, d, alpha=lr)``), beside the
   card's bound for the bytes the pass must move;
4. drive the port's main path — ``fit`` of ``cifar10_fedavg_100``
   (ResNet-18 at full width, synthetic CIFAR-10 at its real 50,000 /
   1,000 cardinality, cohort 16, bf16 local training, the fused server
   apply) for 3 rounds — and check finite losses, params that moved,
   and one kernel launch per round;
5. ``evaluate`` the run's checkpoint through the CLI in a fresh process
   and require the final ``eval_loss`` bit for bit.

The lines before the last report the card (``nvidia-smi`` name and
power limit), the timings and a ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}`` and is printed only when every
phase passed. Without a CUDA device, or outside the repository, the
script exits non-zero and prints no result.
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
N_ODD = 1_000_003
ATOL = RTOL = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
ROUNDS = 3
DATA_SETS = ("data.synthetic_train_size=50000",
             "data.synthetic_test_size=1000")


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


def bound_ms(n: int, momentum: bool) -> dict:
    """Least time for the pass on this card: each input read once, each
    output written once (f32), against the f32 peak for the flops."""
    nbytes = (5 if momentum else 3) * 4 * n
    flops = (4 if momentum else 2) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def check_kernel(server_apply, n: int, momentum: bool, seed: int) -> float:
    """Kernel vs plain version on the same random inputs; returns the
    max abs error and raises past the tolerance."""
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
    err = 0.0
    for got, want in pairs:
        err = max(err, float((got - want).abs().max()))
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError(
                f"kernel disagrees with its plain version (n={n}, "
                f"momentum={momentum}): max abs err {err}")
    return err


def kernel_phase(server_apply) -> dict:
    import torch

    t0 = time.perf_counter()
    lib = server_apply.build()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    emit({"phase": "build", "library": os.path.relpath(lib, ROOT),
          "seconds": round(build_s, 3),
          "ptxas": [ln.strip() for ln in log.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
          if log.exists() else []})
    errs = {}
    for n in (N_RESNET18, N_ODD):
        for momentum in (False, True):
            errs[(n, momentum)] = check_kernel(server_apply, n, momentum,
                                               seed=n + momentum)
    emit({"phase": "kernel_vs_plain", "atol": ATOL, "rtol": RTOL,
          "max_abs_err": {f"n={n},momentum={mo}": e
                          for (n, mo), e in errs.items()}})

    n, lr, beta = N_RESNET18, 1.0, 0.9
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    d = torch.randn(n, device="cuda", generator=gen) * 1e-4
    m = torch.zeros(n, device="cuda")
    times = {}
    for momentum in (False, True):
        mo = m if momentum else None
        times[momentum] = {
            "ms": time_ms(lambda: server_apply.fused_delta_apply(
                p, d, lr, mo, beta)),
            "plain_ms": time_ms(lambda: server_apply.delta_apply_reference(
                p, d, lr, mo, beta)),
            "library_ms": None if momentum else time_ms(
                lambda: torch.add(p, d, alpha=lr)),
            **bound_ms(n, momentum),
        }
    emit({"phase": "kernel_timing", "n": n,
          "mean": times[False], "fedavgm": times[True]})
    return {"max_abs_err": max(errs[(N_RESNET18, False)],
                               errs[(N_ODD, False)]),
            **times[False]}


def main_path_phase(server_apply) -> dict:
    import torch

    from colearn_federated_learning_tpu_torch.cli import parse_overrides
    from colearn_federated_learning_tpu_torch.config import resolve_config
    from colearn_federated_learning_tpu_torch.server.round_driver import (
        Experiment,
    )

    out_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    sets = DATA_SETS + (f"server.num_rounds={ROUNDS}",
                        "server.fused_apply=true")
    cfg = resolve_config("cifar10_fedavg_100",
                         {"run.out_dir": out_dir, **parse_overrides(sets)})
    t0 = time.perf_counter()
    exp = Experiment(cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    state = exp.init_state()
    p0 = state["params"].clone()

    server_apply.fused_delta_apply.launches = 0
    t0 = time.perf_counter()
    state = exp.fit(state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = server_apply.fused_delta_apply.launches

    records = [r for r in exp.logger.history if "train_loss" in r]
    losses = [r["train_loss"] for r in records]
    if len(losses) != ROUNDS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite per round: {losses}")
    if launches != ROUNDS:
        raise AssertionError(
            f"fused_delta_apply launched {launches} times in {ROUNDS} rounds")
    if torch.equal(p0, state["params"]):
        raise AssertionError("params did not change over the fit")
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

    # steady-state round time after the fit (warm caches, same state)
    steady = []
    for r in range(ROUNDS, ROUNDS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = exp.run_round(state, r)
        float(state.pop("_metrics").train_loss)
        steady.append(time.perf_counter() - t0)
    round_s = min(steady)
    emit({"phase": "main_path", "config": "cifar10_fedavg_100",
          "rounds": ROUNDS, "launches": launches, "train_loss": losses,
          "eval_loss": final["eval_loss"], "eval_acc": final["eval_acc"],
          "evaluate_eval_loss": reloaded["eval_loss"],
          "setup_s": round(setup_s, 3), "fit_s": round(fit_s, 3),
          "steady_round_s": round(round_s, 4),
          "rounds_per_sec": round(1.0 / round_s, 4),
          "client_updates_per_sec": round(cfg.server.cohort_size / round_s, 4),
          "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)})
    return {"launches": launches}


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
        from colearn_federated_learning_tpu_torch.ops import server_apply
    except ImportError as e:
        print(f"error: run from the repository root ({e})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    try:
        kernel = kernel_phase(server_apply)
        path = main_path_phase(server_apply)
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"error: chip smoke failed: {e}", file=sys.stderr)
        return 1
    emit({"kernels": [{
        "name": "fused_delta_apply",
        "route": "cuda",
        "source": "colearn_federated_learning_tpu_torch/ops/csrc/"
                  "server_apply.cu",
        "replaces": "colearn_federated_learning_tpu/ops/pallas_apply.py:222",
        "launches": path["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"],
    }]})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
