"""No module the benchmark runs is JAX's or the JAX package's, and the
reference imports nothing of the port.  Top-level names are compared
whole (the part before the first dot), so ``vfr_tpu_torch`` is not
``vfr_tpu``."""

import ast
import os
import subprocess
import sys
import textwrap

from vfrbench import catalog, run

FORBIDDEN = {"jax", "jaxlib", "flax", "vfr_tpu"}


def _sources(sub=""):
    top = os.path.join(catalog.ROOT, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def test_top_level_names_compare_whole():
    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=run.FORBIDDEN.index))
    assert "vfr_tpu_torch".split(".")[0] not in FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imported(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "vfr_tpu_torch" not in set(_imported(path)), path


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole tiny run in a fresh interpreter, then its modules: none is
    JAX's or the JAX package's."""
    code = textwrap.dedent(f"""
        import sys, time, torch
        sys.path.insert(0, {os.path.dirname(catalog.ROOT)!r})
        sys.path.insert(0, {os.path.dirname(os.path.dirname(__file__))!r})
        from vfrbench import catalog, run
        from vfrbench.tests import _tiny
        root = _tiny.make_root({str(tmp_path / 'root')!r})
        for name in sorted(_tiny.CELLS):
            line = run.run_cell(catalog.cell(name, root), 1, 0.2, False,
                                torch.device("cpu"), time.perf_counter(),
                                root=root)
            assert line["correct"], line
        print(sorted({{m.split('.')[0] for m in sys.modules}}))
        print(run.forbidden_modules())
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "vfr_tpu_torch" in loaded


def test_reference_runs_without_the_port():
    """Importing the reference loads no module of the port."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import vfrbench.reference.mcn, vfrbench.reference.judge; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'vfr_tpu_torch'))"
            % os.path.dirname(catalog.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
