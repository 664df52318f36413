"""The port's configuration tuples against the JAX package's, and the
port's independence from JAX."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as tw

torch.set_num_threads(2)

PAIRS = [
    (wt.IntegratorConfig, tw.IntegratorConfig),
    (wt.WalnutsConfig, tw.WalnutsConfig),
    (wt.WarmupConfig, tw.WarmupConfig),
]


@pytest.mark.parametrize("jax_cls, torch_cls", PAIRS,
                         ids=[p[0].__name__ for p in PAIRS])
def test_config_fields_and_defaults_match_jax(jax_cls, torch_cls):
    assert torch_cls._fields == jax_cls._fields
    assert tuple(torch_cls()) == tuple(jax_cls())
    assert torch_cls._field_defaults == jax_cls._field_defaults


def test_import_loads_no_jax():
    """``import walnuts_tpu_torch`` (every subpackage, the kernel
    wrapper included) pulls in no ``jax`` module."""
    code = (
        "import sys\n"
        "import walnuts_tpu_torch\n"
        "import walnuts_tpu_torch.sampler.round_kernel\n"
        "import walnuts_tpu_torch._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('walnuts_tpu.')"
        " or m == 'walnuts_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
