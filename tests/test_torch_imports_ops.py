"""The import check of tests/test_torch_imports.py for the port's
``ops/``, ``parallel/``,
``server/`` and ``obs/``: no file imports JAX, its libraries, or the JAX
package."""

import pytest
import torch

from tests.torch_port_files import check_no_jax_imports, file_id, group_files

torch.set_num_threads(1)


@pytest.mark.parametrize("path", group_files("ops_parallel_server_obs"),
                         ids=file_id)
def test_no_jax_imports(path):
    check_no_jax_imports(path)
