"""Time flash_attention's f32 kernel beside other builds of it on the card.

    python tools/flash_f32_compare.py [--other DIR ...] [--rounds 3]
    python tools/flash_f32_compare.py --accuracy [--other DIR ...]

Builds ``ops/csrc/flash_attention.cu`` of this tree and, for each
``--other``, the same file of the checkout unpacked in DIR (for example
the parent commit, from ``git archive``), and prints each build's
``-Xptxas -v`` lines. Then, at [32, 80, 64] causal (BERT-tiny's heads)
and [768, 197, 64] non-causal (ViT-B/16's eval: batch 64 x 12 heads), it
says whether each build's f32 kernel agrees with the plain version
(``attention_reference``) within 2e-5 abs + 2e-5 rel, and times each
build, ``scaled_dot_product_attention`` on the same f32 tensors and the
plain version in interleaved rounds (the builds in turn, then in
reverse), as device time with the host held off
(``chip_smoke.device_ms``), beside the bound. With ``--accuracy`` it
times nothing: on the inputs of tests/test_torch_flash_attention_cuda.py
(plain, positive v of magnitudes 1e-3 to 1e3) and on q and k scaled ×2,
×3 and ×4, at its shapes, both masks, it gives each build's and the
plain version's largest error against the exact answer (the same
softmax in f64 on the card, from the f32-scaled q) and each build's
against the plain version, in units of the tests' tolerance (2e-5 +
2e-5 |reference|). Needs one CUDA card; prints the card's name and power
limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from colearn_federated_learning_tpu_torch.ops import (  # noqa: E402
    flash_attention as fa,
)
from colearn_federated_learning_tpu_torch.ops._build import (  # noqa: E402
    CudaLibrary,
    build_all,
)

# (name, (B·H, T, hd), causal, heads)
SHAPES = (("bert_tiny", (32, 80, 64), True, 2),
          ("vit_b16_eval", (768, 197, 64), False, 12))
# tests/test_torch_flash_attention_cuda.py's shapes
TEST_SHAPES = ((32, 80, 64), (4, 197, 64), (6, 50, 16), (6, 48, 16),
               (3, 50, 128), (3, 48, 128))
SOURCE = os.path.join("colearn_federated_learning_tpu_torch", "ops", "csrc",
                      "flash_attention.cu")


def launcher(library: CudaLibrary):
    """The f32 kernel of ``library`` on [B·H, T, hd] q, k, v."""
    lib = library.load()

    def run(q, k, v, causal):
        out = torch.empty_like(q)
        bh, t, hd = q.shape
        rc = lib.colearn_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t,
            hd, 0, int(causal), float(hd**-0.5),
            torch.cuda.current_stream().cuda_stream)
        library.check(rc, "colearn_flash_attention")
        return out
    return run


def exact_attention(q, k, v, causal):
    """The softmax attention in f64 from the f32-scaled q, as both
    versions see it."""
    t, hd = q.shape[-2:]
    s = (q * hd**-0.5).double() @ k.double().transpose(-1, -2)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v.double()


def over_tolerance(got, ref) -> float:
    """max |got - ref| / (2e-5 + 2e-5 |ref|)."""
    ref = ref.double()
    return float(((got.double() - ref).abs() / (2e-5 + 2e-5 * ref.abs()))
                 .max())


def accuracy(runs) -> dict:
    """Errors over the tolerance on the CUDA test's inputs."""
    out = {}
    for shape in TEST_SHAPES:
        for causal in (True, False):
            gen = torch.Generator(device="cuda").manual_seed(sum(shape)
                                                             + causal)
            q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                       for _ in range(3))
            mag = 10.0 ** (torch.rand(shape, device="cuda", generator=gen)
                           * 6 - 3)
            cases = {"plain": (q, k, v), "v_mixed": (q, k, v.abs() * mag),
                     **{f"qk_x{a}": (a * q, a * k, v) for a in (2, 3, 4)}}
            for case, (qc, kc, vc) in cases.items():
                want = fa.attention_reference(qc, kc, vc, causal)
                exact = exact_attention(qc, kc, vc, causal)
                row = {"plain_vs_exact": over_tolerance(want, exact)}
                for name, run in runs.items():
                    got = run(qc, kc, vc, causal)
                    row[f"{name}_vs_exact"] = over_tolerance(got, exact)
                    row[f"{name}_vs_plain"] = over_tolerance(got, want)
                key = f"{'x'.join(map(str, shape))} causal={causal} {case}"
                out[key] = row
                smoke.emit({key: row})
    return out


def ptxas_lines(library: CudaLibrary) -> list:
    log = library.path().with_suffix(".log")
    return [ln.strip() for ln in log.read_text().splitlines()
            if "f32_kernel" in ln or "registers" in ln or "spill" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="an unpacked checkout to compare with (repeatable)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--accuracy", action="store_true",
                    help="errors against the exact answer, no timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    print(smoke.nvidia_smi(), flush=True)
    builds = {"tree": fa.LIBRARY}
    for other in args.other:
        builds[os.path.basename(os.path.normpath(other))] = CudaLibrary(
            os.path.abspath(os.path.join(other, SOURCE)), fa._bind)
    build_all(list(builds.values()))
    for name, lib in builds.items():
        smoke.emit({"build": name, "ptxas": ptxas_lines(lib)})
    runs = {name: launcher(lib) for name, lib in builds.items()}
    if args.accuracy:
        result = accuracy(runs)
        worst = {col: max(r[col] for r in result.values())
                 for col in next(iter(result.values()))}
        smoke.emit({"device": torch.cuda.get_device_name(0),
                    "worst_over_tolerance": worst})
        return 0
    order = [*runs, *reversed(runs)]

    result = {}
    for label, shape, causal, heads in SHAPES:
        bh, t, hd = shape
        gen = torch.Generator(device="cuda").manual_seed(4)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                   for _ in range(3))
        q4, k4, v4 = (x.view(bh // heads, heads, t, hd) for x in (q, k, v))
        want = fa.attention_reference(q, k, v, causal)
        errs, agrees = {}, {}
        for name, run in runs.items():
            got = run(q, k, v, causal)
            torch.cuda.synchronize()
            errs[name] = float((got - want).abs().max())
            agrees[name] = torch.allclose(got, want, atol=2e-5, rtol=2e-5)
        times = {name: [] for name in [*runs, "library", "plain"]}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(smoke.device_ms(
                    lambda: runs[name](q, k, v, causal))["ms"])
            times["library"].append(smoke.device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal))["ms"])
            times["plain"].append(smoke.device_ms(
                lambda: fa.attention_reference(q, k, v, causal),
                iters=20)["ms"])
        bound = smoke.attention_bound(bh, t, hd, 4, causal)
        result[label] = {
            "shape": list(shape), "causal": causal, "max_abs_err": errs,
            "agrees_with_plain": agrees,
            "ms": {n: {"median": statistics.median(ts), "min": min(ts),
                       "all": ts} for n, ts in times.items()},
            "bound_share": {n: bound["bound_ms"] / statistics.median(ts)
                            for n, ts in times.items()},
            **bound}
        smoke.emit({label: result[label]})
    smoke.emit({"device": torch.cuda.get_device_name(0), **result})
    return 0


if __name__ == "__main__":
    sys.exit(main())
