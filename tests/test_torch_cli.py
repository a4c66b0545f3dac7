"""The PyTorch port's entry points on the CPU: in-process ``fit`` and
``evaluate`` of ``mnist_fedavg_2`` and ``shakespeare_fedavg`` at tiny
sizes (``evaluate`` of the checkpoint reproduces ``fit``'s final
``eval_loss`` bit for bit), the CUDA default that raises instead of
falling back, config errors, and
the presets against the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from colearn_federated_learning_tpu import config as jcfg
from colearn_federated_learning_tpu_torch import cli
from colearn_federated_learning_tpu_torch import config as tcfg
from colearn_federated_learning_tpu_torch.server.round_driver import Experiment
from colearn_federated_learning_tpu_torch.utils.device import (
    DeviceUnavailableError,
)

torch.set_num_threads(1)

_TINY = ["--set", "data.synthetic_train_size=256",
         "--set", "data.synthetic_test_size=96",
         "--set", "server.num_rounds=3", "--set", "server.eval_every=2",
         "--set", "run.metrics_flush_every=2"]


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("fused", [False, True])
def test_fit_then_evaluate_reproduces_eval_loss(tmp_path, capsys, fused):
    args = ["--config", "mnist_fedavg_2", "--out-dir", str(tmp_path),
            "--device", "cpu", "--set", f"server.fused_apply={fused}"] + _TINY
    assert cli.main(["fit"] + args) == 0
    lines = _json_lines(capsys.readouterr().out)
    rounds = [r for r in lines if "train_loss" in r]
    assert [r["round"] for r in rounds] == [1, 2, 3]
    assert all(r["examples"] == 256.0 for r in rounds)
    assert "eval_loss" in rounds[1] and "rounds_per_sec" in rounds[1]
    assert rounds[-1]["train_loss"] < rounds[0]["train_loss"]
    done = lines[-1]
    assert done["event"] == "done" and done["rounds"] == 3
    log = tmp_path / "mnist_fedavg_2.metrics.jsonl"
    assert [json.loads(x)["schema"] for x in log.read_text().splitlines()]
    assert (tmp_path / "mnist_fedavg_2" / "ckpt").is_dir()

    assert cli.main(["evaluate"] + args) == 0
    out = _json_lines(capsys.readouterr().out)[-1]
    assert out["round"] == 3
    assert out["eval_loss"] == done["eval_loss"]  # bitwise
    assert out["eval_acc"] == done["eval_acc"]


def test_cuda_default_raises_without_a_gpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.resolve_config("mnist_fedavg_2",
                              {"run.out_dir": str(tmp_path)})
    with pytest.raises(DeviceUnavailableError, match="--device cpu"):
        Experiment(cfg)  # device defaults to cuda
    rc = cli.main(["fit", "--config", "mnist_fedavg_2", "--out-dir",
                   str(tmp_path)] + _TINY)
    assert rc == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not (tmp_path / "mnist_fedavg_2").exists()  # nothing ran


@pytest.mark.parametrize("argv,msg", [
    (["--set", "server.bogus=1"], "unknown config path"),
    (["--set", "bogus.section=1"], "unknown config path"),
    (["--set", "server.optimizer=fedadam"], "not supported by the port"),
    (["--set", "model.kwargs.depth=3"], "unknown model.kwargs"),
    (["--set", "algorithm=fedprox"],
     "algorithm='fedprox' requires client.prox_mu > 0"),
    (["--set", "algorithm=scaffold"],
     "algorithm='scaffold' is not supported by the port"),
    (["--set", "client.lr_decay=0.99"], "unknown config path"),
])
def test_config_errors_exit_2(tmp_path, capsys, argv, msg):
    rc = cli.main(["fit", "--config", "mnist_fedavg_2", "--out-dir",
                   str(tmp_path), "--device", "cpu"] + argv)
    assert rc == 2
    assert msg in capsys.readouterr().err


def test_profile_needs_a_gpu(monkeypatch, capsys):
    from colearn_federated_learning_tpu_torch.obs import profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile.main(["--rounds", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_configs_lists_the_named_configs(capsys):
    assert cli.main(["configs"]) == 0
    assert capsys.readouterr().out.split() == [
        "cifar10_fedavg_100", "cifar10_fedavg_1000", "cifar10_krum_byzantine",
        "femnist_fedprox_500", "mnist_fedavg_2", "shakespeare_fedavg"]


def test_shakespeare_fit_then_evaluate_reproduces_eval_loss(tmp_path,
                                                            capsys):
    """The third path at a tiny size: BERT-tiny at T = 16 through the
    ``pallas`` backend (its plain version on the CPU), 8 clients."""
    args = ["--config", "shakespeare_fedavg", "--out-dir", str(tmp_path),
            "--device", "cpu", "--set", "model.kwargs.attention=pallas",
            "--set", "model.kwargs.seq_len=16", "--set", "data.num_clients=8",
            "--set", "server.cohort_size=3", "--set", "server.num_rounds=2",
            "--set", "server.eval_every=2", "--set",
            "data.max_examples_per_client=32", "--set",
            "data.synthetic_test_size=40"]
    assert cli.main(["fit"] + args) == 0
    lines = _json_lines(capsys.readouterr().out)
    rounds = [r for r in lines if "train_loss" in r]
    assert [r["round"] for r in rounds] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in rounds)
    assert "eval_loss" in rounds[-1]
    done = lines[-1]
    assert done["event"] == "done"
    assert cli.main(["evaluate"] + args) == 0
    out = _json_lines(capsys.readouterr().out)[-1]
    assert out["eval_loss"] == done["eval_loss"]  # bitwise
    assert out["eval_acc"] == done["eval_acc"]


def test_evaluate_without_checkpoint_exits_2(tmp_path, capsys):
    rc = cli.main(["evaluate", "--config", "mnist_fedavg_2", "--out-dir",
                   str(tmp_path), "--device", "cpu"] + _TINY)
    assert rc == 2
    assert "no checkpoint" in capsys.readouterr().err


def _leaf_fields(dc, prefix=""):
    for f in dataclasses.fields(dc):
        value = getattr(dc, f.name)
        if dataclasses.is_dataclass(value):
            yield from _leaf_fields(value, prefix + f.name + ".")
        else:
            yield prefix + f.name, value


@pytest.mark.parametrize("name", ["mnist_fedavg_2", "cifar10_fedavg_100",
                                  "cifar10_krum_byzantine",
                                  "shakespeare_fedavg", "cifar10_fedavg_1000",
                                  "femnist_fedprox_500"])
def test_presets_match_the_jax_package(name):
    """Every field the port keeps has the JAX preset's value."""
    port = tcfg.resolve_config(name)
    ref = jcfg.get_named_config(name)
    fields = dict(_leaf_fields(port))
    assert len(fields) > 30
    for path, value in fields.items():
        assert value == tcfg.eval_path(ref, path), path
