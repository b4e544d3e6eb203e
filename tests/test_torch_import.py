"""The torch package imports no JAX, directly or through the shared modules
of the JAX package it uses. Checked in a fresh interpreter, because this
test process has JAX loaded already (tests/conftest.py)."""

import os
import pkgutil
import subprocess
import sys

import fuzzypatternmatching_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = fuzzypatternmatching_tpu_torch
    return [pkg.__name__] + [
        m.name
        for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
    ]


def test_every_port_module_is_listed():
    mods = set(_port_modules())
    for name in (
        "fuzzypatternmatching_tpu_torch.ops.lcc_superstep",
        "fuzzypatternmatching_tpu_torch.ops._build",
        "fuzzypatternmatching_tpu_torch.engine.lcc_bucketed",
        "fuzzypatternmatching_tpu_torch.engine.driver",
        "fuzzypatternmatching_tpu_torch.cli.run_pattern_matching",
    ):
        assert name in mods


def test_importing_the_port_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
