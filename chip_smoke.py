#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``
(the kernels are built from ``colearn_federated_learning_tpu_torch/ops/
csrc`` at first use, one ``nvcc`` per source, all at once). Phases, each
of which fails the run:

1. build the hand-written CUDA kernels (``fused_delta_apply``,
   ``fused_reduce_apply``);
2. hold ``fused_delta_apply`` against its plain PyTorch version on
   random f32 vectors of the ResNet-18 length and of an odd length, both
   branches (no momentum / momentum), within 1e-6 absolute + 1e-6
   relative;
3. hold ``fused_reduce_apply`` against its plain version on a K = 16
   stack at the same lengths, both branches, with random weights, a
   one-hot row and an all-zero row, within the same tolerance;
4. time each kernel, its plain version and the library calls that
   compute the same (or part of the same) function, beside the card's
   bound for the bytes the pass must move;
5. drive the first path — ``fit`` of ``cifar10_fedavg_100`` (ResNet-18
   at full width, synthetic CIFAR-10 at its real 50,000 / 1,000
   cardinality, cohort 16, bf16 local training, the fused server apply)
   for 3 rounds — and check finite losses, params that moved, one
   ``fused_delta_apply`` launch per round; ``evaluate`` the checkpoint
   through the CLI in a fresh process and require the final
   ``eval_loss`` bit for bit;
6. drive the second path — ``fit`` of ``cifar10_krum_byzantine`` (the
   same federation under a sign-flipping adversary, defended by Krum,
   with the fused apply) for 3 rounds — and check finite losses, params
   that moved, one ``fused_reduce_apply`` launch per round and none of
   ``fused_delta_apply``, and ``byzantine_count`` in every round's
   record; then, on one round's stack, the fused route (Krum's one-hot
   row through the kernel) and the unfused route (``robust_reduce`` +
   the plain apply) must agree within 1e-6.

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
N_ODD = 1_000_003
K_COHORT = 16  # the cohort of both configs
ATOL = RTOL = 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
ROUNDS = 3
DATA_SETS = ("data.synthetic_train_size=50000",
             "data.synthetic_test_size=1000")
PALLAS = "colearn_federated_learning_tpu/ops/pallas_apply.py"
CSRC = "colearn_federated_learning_tpu_torch/ops/csrc/"


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


def bound_ms(nbytes: int, flops: int) -> dict:
    """Least time for a pass on this card: ``nbytes`` moved (each input
    read once, each output written once) against the memory rate, and
    ``flops`` against the f32 peak; the larger bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


def assert_close(pairs, what: str) -> float:
    """Max abs error over ``(got, want)`` pairs; raises past the
    tolerance."""
    import torch

    err = 0.0
    for got, want in pairs:
        err = max(err, float((got - want).abs().max()))
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
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
             if "registers" in ln or "spill" in ln] if log.exists() else [])
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": [os.path.relpath(lib.path(), ROOT)
                        for lib in libraries], "ptxas": ptxas})


def check_delta_kernel(server_apply, n: int, momentum: bool,
                       seed: int) -> float:
    """``fused_delta_apply`` vs its plain version on the same random
    inputs; returns the max abs error and raises past the tolerance."""
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
                               f"momentum={momentum})")


def delta_kernel_phase(server_apply) -> dict:
    import torch

    errs = {}
    for n in (N_RESNET18, N_ODD):
        for momentum in (False, True):
            errs[(n, momentum)] = check_delta_kernel(server_apply, n,
                                                     momentum,
                                                     seed=n + momentum)
    emit({"phase": "delta_kernel_vs_plain", "atol": ATOL, "rtol": RTOL,
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
            "max_abs_err": max(errs[(N_RESNET18, momentum)],
                               errs[(N_ODD, momentum)]),
            "ms": time_ms(lambda: server_apply.fused_delta_apply(
                p, d, lr, mo, beta)),
            "plain_ms": time_ms(lambda: server_apply.delta_apply_reference(
                p, d, lr, mo, beta)),
            "library_ms": None if momentum else time_ms(
                lambda: torch.add(p, d, alpha=lr)),
            **delta_bound(n, momentum),
        }
    emit({"phase": "delta_kernel_timing", "n": n,
          "mean": rows[False], "fedavgm": rows[True]})
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


def reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0
        fn.momentum_launches = 0


def read_counts(kernels) -> dict:
    return {fn.__name__: {"launches": fn.launches,
                          "momentum_launches": fn.momentum_launches}
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


def fit_and_check(exp, kernels) -> dict:
    """Drive ``fit`` with every launch count at 0; check finite losses
    and moved params; return the records, counts and timings."""
    import torch

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
    if len(losses) != ROUNDS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses not finite per round: {losses}")
    if torch.equal(p0, state["params"]):
        raise AssertionError("params did not change over the fit")
    return {"state": state, "records": records, "losses": losses,
            "counts": counts, "fit_s": fit_s}


def steady_round_s(exp, state) -> float:
    """Best wall time of 2 more rounds on warm caches."""
    import torch

    steady = []
    for r in range(ROUNDS, ROUNDS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = exp.run_round(state, r)
        float(state.pop("_metrics").train_loss)
        steady.append(time.perf_counter() - t0)
    return min(steady)


def fedavg_path_phase(kernels) -> dict:
    import torch

    out_dir = os.path.join(ROOT, "runs", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    sets = DATA_SETS + (f"server.num_rounds={ROUNDS}",
                        "server.fused_apply=true")
    exp, setup_s = make_experiment("cifar10_fedavg_100", sets, out_dir)
    run = fit_and_check(exp, kernels)
    counts = run["counts"]
    if counts["fused_delta_apply"]["launches"] != ROUNDS:
        raise AssertionError(f"fused_delta_apply launched {counts} in "
                             f"{ROUNDS} rounds")
    if counts["fused_reduce_apply"]["launches"] != 0:
        raise AssertionError(f"the FedAvg path reached the reduce kernel: "
                             f"{counts}")
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
          "setup_s": round(setup_s, 3), "fit_s": round(run["fit_s"], 3),
          "steady_round_s": round(round_s, 4),
          "rounds_per_sec": round(1.0 / round_s, 4),
          "client_updates_per_sec": round(K_COHORT / round_s, 4),
          "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)})
    return counts


def krum_path_phase(kernels, reduce_apply, server_apply) -> dict:
    import numpy as np
    import torch

    from colearn_federated_learning_tpu_torch.server.aggregation import (
        krum_select,
        krum_weights,
        robust_reduce,
    )

    sets = DATA_SETS + (f"server.num_rounds={ROUNDS}",
                        "server.fused_apply=true")
    exp, setup_s = make_experiment("cifar10_krum_byzantine", sets, "")
    run = fit_and_check(exp, kernels)
    counts = run["counts"]
    if (counts["fused_reduce_apply"]["launches"] != ROUNDS
            or counts["fused_delta_apply"]["launches"] != 0):
        raise AssertionError(f"the Krum path launched {counts} in {ROUNDS} "
                             f"rounds (want one fused_reduce_apply a round "
                             f"and no fused_delta_apply)")
    records = run["records"]
    if any("byzantine_count" not in r for r in records):
        raise AssertionError(f"byzantine_count missing from {records}")
    state = run["state"]
    round_s = steady_round_s(exp, state)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the fused and the unfused route on one round's stack
    params = state["params"]
    cfg = exp.cfg
    cohort, idx, mask, n_ex, step_counts = exp._round_inputs(ROUNDS + 2)
    byz = np.isin(np.asarray(cohort), exp.compromised).astype(np.float32)
    n_ex = np.asarray(n_ex, np.float32)
    stack, _ = exp.round_fn.upload_stack(params, exp.train_x, exp.train_y,
                                         idx, mask, n_ex, step_counts, byz)
    part = torch.as_tensor(n_ex, device="cuda") > 0
    f = cfg.server.krum_byzantine
    winner, m = krum_select(stack, part, f, exp.layout)
    p_fused = params.clone()
    _, _, d_fused = reduce_apply.fused_reduce_apply(
        stack, krum_weights(winner, m, stack.shape[0]), p_fused,
        cfg.server.server_lr)
    d_unfused = robust_reduce(stack, part, "krum", exp.layout,
                              byzantine_f=f)
    p_unfused, _ = server_apply.delta_apply_reference(
        params, d_unfused, cfg.server.server_lr)
    torch.cuda.synchronize()
    route_err = assert_close([(d_fused, d_unfused), (p_fused, p_unfused)],
                             "fused vs unfused Krum route")
    emit({"phase": "krum_path", "config": "cifar10_krum_byzantine",
          "rounds": ROUNDS, "launches": counts, "train_loss": run["losses"],
          "byzantine_count": [r["byzantine_count"] for r in records],
          "krum_selected_byzantine": [r.get("krum_selected_byzantine")
                                      for r in records],
          "compromised_winners": sum(r.get("krum_selected_byzantine", 0)
                                     for r in records),
          "n_compromised": int(len(exp.compromised)),
          "fused_vs_unfused_max_abs_err": route_err,
          "route_check_winner_slot": int(winner),
          "route_check_winner_byzantine": int(byz[int(winner)]),
          "setup_s": round(setup_s, 3), "fit_s": round(run["fit_s"], 3),
          "steady_round_s": round(round_s, 4),
          "rounds_per_sec": round(1.0 / round_s, 4),
          "client_updates_per_sec": round(K_COHORT / round_s, 4),
          "stack_gb": round(stack.numel() * 4 / 1e9, 3),
          "peak_mem_gb": round(peak_gb, 3)})
    return counts


def kernel_rows(delta, reduce, fedavg_counts, krum_counts) -> list:
    """The four rows of the kernel table; each branch's launches come
    from the path that runs it."""
    def launches(counts, name, momentum):
        c = counts[name]
        return (c["momentum_launches"] if momentum
                else c["launches"] - c["momentum_launches"])

    def row(name, source, replaces, timing, n_launches):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": f"{PALLAS}:{replaces}", "launches": n_launches}
        out.update({k: timing[k] for k in keys})
        if "library_call" in timing:
            out["library_call"] = timing["library_call"]
        return out

    both = {name: {k: fedavg_counts[name][k] + krum_counts[name][k]
                   for k in fedavg_counts[name]}
            for name in fedavg_counts}  # launches of both paths
    return [
        row("fused_delta_apply", "server_apply.cu", 222, delta[False],
            launches(fedavg_counts, "fused_delta_apply", False)),
        row("fused_delta_apply (momentum)", "server_apply.cu", 209,
            delta[True], launches(both, "fused_delta_apply", True)),
        row("fused_reduce_apply (momentum)", "reduce_apply.cu", 262,
            reduce[True], launches(both, "fused_reduce_apply", True)),
        row("fused_reduce_apply", "reduce_apply.cu", 275, reduce[False],
            launches(krum_counts, "fused_reduce_apply", False)),
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
               reduce_apply.fused_reduce_apply)
    try:
        build_phase([server_apply.LIBRARY, reduce_apply.LIBRARY])
        delta = delta_kernel_phase(server_apply)
        reduce = reduce_kernel_phase(reduce_apply)
        fedavg_counts = fedavg_path_phase(kernels)
        krum_counts = krum_path_phase(kernels, reduce_apply, server_apply)
    except Exception as e:  # every phase failure ends the run non-zero
        import traceback

        traceback.print_exc()
        print(f"error: chip smoke failed: {e}", file=sys.stderr)
        return 1
    emit({"kernels": kernel_rows(delta, reduce, fedavg_counts, krum_counts)})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 3)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
