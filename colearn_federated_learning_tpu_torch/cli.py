"""Command line of the PyTorch port::

    python -m colearn_federated_learning_tpu_torch fit --config cifar10_fedavg_100 \\
        --out-dir runs --set server.num_rounds=3 [--device cuda|cpu]
    python -m colearn_federated_learning_tpu_torch evaluate --config cifar10_fedavg_100 \\
        --out-dir runs [--device cuda|cpu]
    python -m colearn_federated_learning_tpu_torch configs

``fit`` prints per-round JSONL and a final ``{"event": "done", ...}``
line; ``evaluate`` prints the latest checkpoint's ``eval_loss`` and
``eval_acc``; ``configs`` lists the named configs (``mnist_fedavg_2``,
``cifar10_fedavg_100``, ``cifar10_krum_byzantine``,
``shakespeare_fedavg``).
``--set a.b=v`` overrides any config field (unknown keys are an error).
The device defaults to CUDA; without a GPU the command fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from colearn_federated_learning_tpu_torch.config import (
    list_named_configs,
    resolve_config,
)


def parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        lowered = v.lower()
        if lowered in ("true", "false"):
            out[k] = lowered == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def build_parser():
    ap = argparse.ArgumentParser(prog="colearn_federated_learning_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("configs", help="list the named configs")
    for name, help_ in (("fit", "run federated training"),
                        ("evaluate", "evaluate the latest checkpoint")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", required=True, help="named config")
        p.add_argument("--set", action="append", metavar="KEY=VALUE",
                       dest="overrides",
                       help="dotted config override, e.g. server.num_rounds=5")
        p.add_argument("--out-dir", default=None, help="override run.out_dir")
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "configs":
        for name in list_named_configs():
            print(name)
        return 0
    overrides = parse_overrides(args.overrides)
    if args.out_dir is not None:
        overrides["run.out_dir"] = args.out_dir
    # deferred: `--help` needs no torch model code
    from colearn_federated_learning_tpu_torch.server.round_driver import (
        Experiment,
    )
    from colearn_federated_learning_tpu_torch.utils.device import (
        DeviceUnavailableError,
    )

    try:
        cfg = resolve_config(args.config, overrides)
        exp = Experiment(cfg, device=args.device)
    except (KeyError, ValueError, FileNotFoundError,
            DeviceUnavailableError) as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    if args.cmd == "fit":
        state = exp.fit()
        final = {"event": "done", "rounds": int(state["round"]),
                 "wall_time_sec": round(state["wall_time"], 2)}
        final.update(exp.evaluate(state["params"]))
        print(json.dumps(final))
        return 0
    try:
        out = exp.evaluate_checkpoint()
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
