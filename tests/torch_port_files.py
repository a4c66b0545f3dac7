"""The walker behind the port's import check (tests/test_torch_imports*.py):
every ``.py`` file of the port package and ``chip_smoke.py``, the roots
of the modules each imports, and the groups that spread one check per
file over several test files.

A group is a set of the port's top-level entries (directories or
files); :func:`group_files` gives the files of one group, and
``tests/test_torch_imports.py`` holds that the groups together take
every file :func:`port_files` finds exactly once, so a new file or
directory of the port cannot go unchecked."""

from __future__ import annotations

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "colearn_federated_learning_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "colearn_federated_learning_tpu"}

# the first entry of a file's path below the repository root
# (``chip_smoke.py``) or below the port package
GROUPS = {
    "entry_client_data": ("chip_smoke.py", "__init__.py", "__main__.py",
                          "cli.py", "config.py", "client", "data"),
    "models_utils": ("models", "utils"),
    "ops_parallel_server_obs": ("ops", "parallel", "server", "obs"),
}


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _head(path):
    base = PORT if path.startswith(PORT + os.sep) else ROOT
    return os.path.relpath(path, base).split(os.sep)[0]


def group_files(group):
    return [f for f in port_files() if _head(f) in GROUPS[group]]


def file_id(path):
    return os.path.relpath(path, ROOT)


def imported_roots(path):
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


def check_no_jax_imports(path):
    bad = [(line, mod) for line, mod in imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{file_id(path)} imports {bad}"
