"""The port runs where there is no JAX.

The machine with the GPU has PyTorch but no jax, flax, PIL, cv2 or
``regex``.  These tests import the whole port and ``chip_smoke`` in a
subprocess whose import system refuses those packages (and the JAX
package itself), check the same statically, and check that
``chip_smoke.py`` refuses to run without CUDA or without the repository.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ladi_vton_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "PIL", "cv2", "regex", "ladi_vton_tpu")


def _run(code: str, cwd: pathlib.Path, *args: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(cwd)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    return subprocess.run([sys.executable, *args, code] if code else
                          [sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_port_and_chip_smoke_import_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        BLOCKED = {BLOCKED!r}

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ModuleNotFoundError(f"{{name}} is not installed")
                return None

        sys.meta_path.insert(0, Refuse())
        import ladi_vton_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ladi_vton_tpu_torch.__path__, "ladi_vton_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        print(len(names))
    """)
    proc = _run(code, ROOT, "-c")
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_chip_smoke_refuses_to_run_without_cuda():
    proc = _run("", ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
