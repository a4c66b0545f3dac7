"""The PyTorch port stands alone: no file of the port package, and not
chip_smoke.py, imports JAX, its libraries, or the JAX package.

The check runs once per file, spread over three test files by the groups
of tests/torch_port_files.py: here chip_smoke.py, the package's top-level
modules, ``client/`` and ``data/``; ``models/`` and ``utils/`` in
tests/test_torch_imports_models.py; ``ops/``, ``parallel/``, ``server/``
and ``obs/`` in tests/test_torch_imports_ops.py. The coverage case below
holds that the groups take every file exactly once."""

import collections
import os

import pytest
import torch

from tests.torch_port_files import (
    GROUPS,
    PORT,
    check_no_jax_imports,
    file_id,
    group_files,
    port_files,
)

torch.set_num_threads(1)


def test_port_has_the_expected_layout():
    files = {os.path.relpath(f, PORT) for f in port_files()}
    for rel in ("config.py", "cli.py", "__main__.py", "data/core.py",
                "data/loader.py", "data/partition.py", "models/resnet.py",
                "models/lenet.py", "models/convert.py", "client/trainer.py",
                "server/aggregation.py", "server/sampler.py",
                "server/round_driver.py", "parallel/round_engine.py",
                "ops/server_apply.py", "ops/reduce_apply.py",
                "server/attacks.py", "utils/metrics.py",
                "utils/checkpoint.py", "obs/profile.py", "data/leaf.py",
                "models/bert.py", "ops/attention.py", "ops/ring_attention.py",
                "ops/flash_attention.py", "ops/backends.py",
                "models/mobilenet.py"):
        assert rel in files, rel
    for cu in ("server_apply.cu", "reduce_apply.cu", "flash_attention.cu"):
        assert os.path.isfile(os.path.join(PORT, "ops", "csrc", cu))


def test_import_check_groups_cover_every_file_once():
    taken = collections.Counter(f for g in GROUPS for f in group_files(g))
    assert sorted(taken) == port_files(), (
        "port files in no group of tests/torch_port_files.py: "
        f"{sorted(set(port_files()) - set(taken))}")
    assert all(n == 1 for n in taken.values()), taken


@pytest.mark.parametrize("path", group_files("entry_client_data"),
                         ids=file_id)
def test_no_jax_imports(path):
    check_no_jax_imports(path)
