"""The PyTorch port stands alone: no file of the port package, and not
chip_smoke.py, imports JAX, its libraries, or the JAX package."""

import ast
import os

import pytest
import torch

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_ROOT, "colearn_federated_learning_tpu_torch")
_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
              "colearn_federated_learning_tpu"}


def _port_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(_PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_has_the_expected_layout():
    files = {os.path.relpath(f, _PORT) for f in _port_files()}
    for rel in ("config.py", "cli.py", "__main__.py", "data/core.py",
                "data/loader.py", "data/partition.py", "models/resnet.py",
                "models/lenet.py", "models/convert.py", "client/trainer.py",
                "server/aggregation.py", "server/sampler.py",
                "server/round_driver.py", "parallel/round_engine.py",
                "ops/server_apply.py", "ops/reduce_apply.py",
                "server/attacks.py", "utils/metrics.py",
                "utils/checkpoint.py", "obs/profile.py", "data/leaf.py",
                "models/bert.py", "ops/attention.py", "ops/ring_attention.py",
                "ops/flash_attention.py", "ops/backends.py"):
        assert rel in files, rel
    for cu in ("server_apply.cu", "reduce_apply.cu", "flash_attention.cu"):
        assert os.path.isfile(os.path.join(_PORT, "ops", "csrc", cu))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in _FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, _ROOT)} imports {bad}"
