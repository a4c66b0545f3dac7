"""Where one round of the port's main path spends its time on the card.

    python -m colearn_federated_learning_tpu_torch.obs.profile \\
        [--config cifar10_fedavg_100] [--set KEY=VALUE ...] [--rounds 2] \\
        [--top 20] [--table PATH]

Builds ``--config`` at full width on the CUDA card, runs one warm-up
round, times ``--rounds`` rounds, then traces ``--rounds`` more with
``torch.profiler``. The CIFAR-10 configs (``cifar10_fedavg_100``,
``cifar10_krum_byzantine``) run on synthetic CIFAR-10 at its real
50,000 / 1,000 cardinality with the fused server apply (their bench
shape); ``cifar10_fedavg_1000`` (50,000 / 2,000 in its preset) and
``femnist_fedprox_500`` (the synthetic FEMNIST stand-in) run with the
fused server apply; ``shakespeare_fedavg`` runs as its preset is, on the
synthetic corpus (``--set model.kwargs.attention=pallas`` routes its
attention through the CUDA kernel). ``--set`` overrides any config field. It
prints JSON lines: the host wall time per round with and without the
profiler; the summed device kernel time and the device's busy and idle
shares (kernel time over the wall time of the traced rounds, and over
the untraced rounds'); the kernel launches per round, all and those of
the port's own kernels; the top kernels and the top operators by device
time; and the card's ``nvidia-smi`` name and power limit. ``--table``
also writes the profiler's full table. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from colearn_federated_learning_tpu_torch.cli import parse_overrides
from colearn_federated_learning_tpu_torch.config import resolve_config
from colearn_federated_learning_tpu_torch.ops import (
    flash_attention,
    reduce_apply,
    server_apply,
)
from colearn_federated_learning_tpu_torch.server.round_driver import Experiment

# each config's bench shape: what the run overrides before --set
_BENCH_SHAPE = {
    "cifar10_fedavg_100": {"data.synthetic_train_size": 50000,
                           "data.synthetic_test_size": 1000,
                           "server.fused_apply": True},
    "cifar10_fedavg_1000": {"server.fused_apply": True},
    "femnist_fedprox_500": {"server.fused_apply": True},
    "shakespeare_fedavg": {},
}
_BENCH_SHAPE["cifar10_krum_byzantine"] = _BENCH_SHAPE["cifar10_fedavg_100"]
_KERNELS = (server_apply.fused_delta_apply, reduce_apply.fused_reduce_apply,
            flash_attention.flash_attention)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m colearn_federated_learning_tpu_torch.obs.profile")
    ap.add_argument("--config", default="cifar10_fedavg_100",
                    choices=sorted(_BENCH_SHAPE))
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    dest="overrides", help="dotted config override")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--table", default=None,
                    help="write the profiler's full table to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1

    cfg = resolve_config(args.config, {
        **_BENCH_SHAPE[args.config], **parse_overrides(args.overrides),
        "run.out_dir": ""})
    exp = Experiment(cfg, device="cuda", echo=False)
    state = exp.run_round(exp.init_state(), 0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(1, 1 + args.rounds):
        state = exp.run_round(state, r)
    torch.cuda.synchronize()
    plain_round_s = (time.perf_counter() - t0) / args.rounds

    for fn in _KERNELS:
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(1 + args.rounds, 1 + 2 * args.rounds):
            state = exp.run_round(state, r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events (kernels, memcpy/memset) carry the device time
    # once; operator events repeat it as the time of what they launched
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    device_s = sum(_device_us(e) for e in kernels) / 1e6 / args.rounds
    busy = device_s * args.rounds / wall
    print(json.dumps({
        "config": args.config, "rounds": args.rounds,
        "round_s": wall / args.rounds,
        "device_kernel_s_per_round": device_s,
        "device_busy_share": busy, "device_idle_share": 1.0 - busy,
        "round_s_unprofiled": plain_round_s,
        "device_busy_share_unprofiled": device_s / plain_round_s,
        "kernel_launches_per_round":
            sum(e.count for e in kernels) / args.rounds,
        "port_kernel_launches_per_round": {
            fn.__name__: fn.launches / args.rounds for fn in _KERNELS},
        "cohort": cfg.server.cohort_size,
        "local_steps_per_client": exp.shape.steps,
    }), flush=True)
    for kind, rows in (("kernel", kernels), ("op", ops)):
        for e in sorted(rows, key=_device_us, reverse=True)[: args.top]:
            print(json.dumps({
                kind: e.key[:160], "calls_per_round": e.count / args.rounds,
                "device_ms_per_round": _device_us(e) / 1e3 / args.rounds,
                "host_ms_per_round":
                    e.self_cpu_time_total / 1e3 / args.rounds,
            }), flush=True)
    if args.table:
        sort_key = ("self_device_time_total"
                    if hasattr(events[0], "self_device_time_total")
                    else "self_cuda_time_total")
        with open(args.table, "w") as f:
            f.write(events.table(sort_by=sort_key, row_limit=80))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
