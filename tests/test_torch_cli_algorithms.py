"""The slice end to end for the other algorithms: the PyTorch port's CLI
against pandaseq_tpu's CLI with ``-A pear`` and ``-A rdp_mle`` (sparse
path), and with ``-k 0`` for each count-based algorithm (the dense
shortlist path; see tests/test_torch_cli.py)."""

import pytest

from tests.test_torch_cli import check_port_cli_equals_jax_cli


@pytest.mark.parametrize("extra", [
    ["-A", "pear"], ["-A", "rdp_mle"], ["-k", "0"],
    ["-k", "0", "-A", "uparse"], ["-k", "0", "-A", "ea_util"],
    ["-k", "0", "-A", "flash"], ["-k", "0", "-A", "stitch"]])
def test_port_cli_equals_jax_cli(extra):
    check_port_cli_equals_jax_cli(extra)
