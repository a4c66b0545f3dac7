"""Time the designs of the fused server apply on the card, side by side.

    python tools/delta_apply_sweep.py [--rounds 9] [--iters 50]

Builds ``ops/csrc/delta_apply_sweep.cu`` (grid-stride, batched
streaming loads in a one-wave grid, and 1-D TMA bulk copies through a
shared ring of 8 KB or 16 KB tiles) beside ``ops/csrc/server_apply.cu``
(one float4 a thread), checks every design bit for bit against the
plain version at the ResNet-18 length and an odd length, both
branches, then times each of them, the kernel of ``server_apply.cu``
through ``fused_delta_apply`` and ``torch.add(p, d, alpha=lr)`` in
interleaved rounds (mean over ``iters`` back-to-back launches, CUDA
events), and prints the median and the least of the rounds beside the
bytes bound. Needs one CUDA card; prints the
card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from colearn_federated_learning_tpu_torch.ops import server_apply  # noqa: E402
from colearn_federated_learning_tpu_torch.ops._build import (  # noqa: E402
    CudaLibrary, build_all)

N_RESNET18 = 11_173_962
N_ODD = 1_000_003
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# (name, variant, blocks_per_sm): the designs of delta_apply_sweep.cu
DESIGNS = (("grid_stride_8", 0, 8), ("batched_1", 1, 1), ("batched_2", 1, 2),
           ("batched_4", 1, 4), ("batched_8", 1, 8), ("tma_1", 2, 1),
           ("tma_2", 2, 2), ("tma_3", 2, 3), ("tma16k_1", 3, 1),
           ("tma16k_2", 3, 2))


def _bind(lib: ctypes.CDLL) -> None:
    lib.colearn_delta_apply_variant.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.colearn_delta_apply_variant.restype = ctypes.c_int


SWEEP = CudaLibrary("delta_apply_sweep.cu", _bind)


def launcher(variant: int, blocks_per_sm: int):
    lib = SWEEP.load()

    def run(p, d, lr, m=None, beta=0.0):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.colearn_delta_apply_variant(
            variant, blocks_per_sm, p.data_ptr(), d.data_ptr(),
            None if m is None else m.data_ptr(), p.numel(), float(lr),
            float(beta), stream)
        SWEEP.check(rc, "colearn_delta_apply_variant")
    return run


def time_ms(fn, iters: int, warmup: int = 5) -> float:
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


def check(run, n: int, momentum: bool, seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    d = torch.randn(n, device="cuda", generator=gen) * 0.01
    m = torch.randn(n, device="cuda", generator=gen) * 0.01 if momentum else None
    want_p, want_m = server_apply.delta_apply_reference(p, d, 0.7, m, 0.9)
    run(p, d, 0.7, m, 0.9)
    torch.cuda.synchronize()
    if not torch.equal(p, want_p) or (momentum and not torch.equal(m, want_m)):
        raise AssertionError(f"n={n} momentum={momentum}: not bit for bit "
                             f"the plain version")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    build_all([SWEEP, server_apply.LIBRARY])
    runs = {name: launcher(v, b) for name, v, b in DESIGNS}
    runs["server_apply.cu"] = server_apply.fused_delta_apply
    for name, run in runs.items():
        for n in (N_RESNET18, N_ODD):
            for momentum in (False, True):
                check(run, n, momentum, seed=n + momentum)
    print(json.dumps({"checked": list(runs), "tolerance": "bit for bit"}),
          flush=True)

    n, lr, beta = N_RESNET18, 1.0, 0.9
    gen = torch.Generator(device="cuda").manual_seed(1)
    p = torch.randn(n, device="cuda", generator=gen) * 0.05
    d = torch.randn(n, device="cuda", generator=gen) * 1e-4
    m = torch.zeros(n, device="cuda")
    result = {}
    for momentum in (False, True):
        mo = m if momentum else None
        fns = {name: (lambda run=run: run(p, d, lr, mo, beta))
               for name, run in runs.items()}
        if not momentum:
            fns["torch.add"] = lambda: torch.add(p, d, alpha=lr)
        times = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name, fn in fns.items():
                times[name].append(time_ms(fn, args.iters))
        nbytes = (5 if momentum else 3) * 4 * n
        result["momentum" if momentum else "mean"] = {
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "min_ms": {k: min(v) for k, v in times.items()},
        }
    print(json.dumps({"n": n, "rounds": args.rounds, "iters": args.iters,
                      "device": smi, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
