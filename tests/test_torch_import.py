"""The torch package, chip_smoke.py, ab_mesh_gather.py, bench_torch.py and
the scripts of tools_torch/ import no JAX and nothing of the JAX package
(``fuzzypatternmatching_tpu``), of ``tools/`` or of the JAX ``bench.py``,
directly or through another module. Checked twice: in a
fresh interpreter, because this test process has JAX loaded already
(tests/conftest.py), and by scanning every import statement of the
sources."""

import ast
import glob
import os
import pkgutil
import subprocess
import sys

import pytest

import fuzzypatternmatching_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "fuzzypatternmatching_tpu_torch")
TOOLS = sorted(glob.glob(os.path.join(REPO, "tools_torch", "*.py")))
SCRIPTS = ["chip_smoke", "ab_mesh_gather", "bench_torch"] + [
    "tools_torch." + os.path.basename(p)[:-3] for p in TOOLS
]
SOURCES = sorted(
    glob.glob(os.path.join(PORT_DIR, "**", "*.py"), recursive=True)
) + [os.path.join(REPO, f"{s}.py") for s in SCRIPTS[:3]] + TOOLS
FORBIDDEN = ("jax", "fuzzypatternmatching_tpu", "tools", "make_golden", "bench")


def _port_modules():
    pkg = fuzzypatternmatching_tpu_torch
    return [pkg.__name__] + [
        m.name
        for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
    ]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_every_port_module_is_listed():
    mods = set(_port_modules())
    for name in (
        "fuzzypatternmatching_tpu_torch.ops.lcc_superstep",
        "fuzzypatternmatching_tpu_torch.ops._build",
        "fuzzypatternmatching_tpu_torch.ops.nlcc_frontier",
        "fuzzypatternmatching_tpu_torch.engine.nlcc_device",
        "fuzzypatternmatching_tpu_torch.engine.lcc_bucketed",
        "fuzzypatternmatching_tpu_torch.engine.lcc",
        "fuzzypatternmatching_tpu_torch.engine.driver",
        "fuzzypatternmatching_tpu_torch.engine.nlcc",
        "fuzzypatternmatching_tpu_torch.engine.result",
        "fuzzypatternmatching_tpu_torch.cli.run_pattern_matching",
        "fuzzypatternmatching_tpu_torch.generators.rmat",
        "fuzzypatternmatching_tpu_torch.generators.edge_list",
        "fuzzypatternmatching_tpu_torch.graph.csr",
        "fuzzypatternmatching_tpu_torch.graph.storage",
        "fuzzypatternmatching_tpu_torch.io.labels",
        "fuzzypatternmatching_tpu_torch.io.results",
        "fuzzypatternmatching_tpu_torch.pattern.builtin",
        "fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint",
        "fuzzypatternmatching_tpu_torch.pattern.pattern_graph",
        "fuzzypatternmatching_tpu_torch.utils.hashing",
        "fuzzypatternmatching_tpu_torch.utils.page_cache",
        "fuzzypatternmatching_tpu_torch.native",
        "fuzzypatternmatching_tpu_torch.golden",
        "fuzzypatternmatching_tpu_torch.algorithms.frontier",
        "fuzzypatternmatching_tpu_torch.algorithms.fuzzy_walk",
        "fuzzypatternmatching_tpu_torch.cli.run_algorithms",
        "fuzzypatternmatching_tpu_torch.cli.generate_rmat",
        "fuzzypatternmatching_tpu_torch.cli.ingest_edge_list",
        "fuzzypatternmatching_tpu_torch.cli.transfer_graph",
        "fuzzypatternmatching_tpu_torch.cli.build_edge_metadata",
        "fuzzypatternmatching_tpu_torch.graph.build",
        "fuzzypatternmatching_tpu_torch.utils.dist",
        "fuzzypatternmatching_tpu_torch.utils.log_step",
        "fuzzypatternmatching_tpu_torch.parallel.mesh",
        "fuzzypatternmatching_tpu_torch.parallel.sharded",
        "fuzzypatternmatching_tpu_torch.parallel.nlcc_sharded",
        "fuzzypatternmatching_tpu_torch.algorithms.frontier_sharded",
        "fuzzypatternmatching_tpu_torch.cli.comm_rate_test",
        "fuzzypatternmatching_tpu_torch.engine.oracle",
        "fuzzypatternmatching_tpu_torch.generators.synthetic",
        "fuzzypatternmatching_tpu_torch.cli.launch_multiprocess",
        "fuzzypatternmatching_tpu_torch.cli.sharded_lcc_demo",
    ):
        assert name in mods


def test_importing_the_port_leaves_jax_out():
    """Every port module and every script, in a fresh interpreter:
    neither jax nor the JAX package ends up in sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', "
        "'fuzzypatternmatching_tpu') or k.startswith(('jax.', "
        "'fuzzypatternmatching_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'chip_smoke' in sys.modules and 'bench' not in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", SOURCES, ids=[os.path.relpath(p, REPO) for p in SOURCES]
)
def test_source_imports_nothing_of_jax_or_tools(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_scan_sees_every_port_module():
    scanned = {os.path.relpath(p, REPO) for p in SOURCES}
    assert {"chip_smoke.py", "ab_mesh_gather.py", "bench_torch.py",
            "tools_torch/sweep.py", "tools_torch/profile_search.py",
            "tools_torch/init_decompose.py", "tools_torch/scaling_bench.py",
            "tools_torch/comm_volume.py", "tools_torch/common.py"} <= scanned
    assert len(scanned) > len(_port_modules())  # modules plus the chip scripts
