"""The port runs where there is no JAX.

The machine with the GPU has PyTorch but no jax, flax, optax, orbax, PIL,
cv2, ``regex``, ``safetensors`` or ``tqdm``.  These tests import the whole
port (its data layer and CLIs by name) and ``chip_smoke`` in a
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
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "cv2", "regex",
           "safetensors", "tqdm", "ladi_vton_tpu")
# the data layer and the CLIs, which stand in for PIL, cv2 and tqdm; the
# serving front end, the client and the metrics; the trainers, which stand
# in for optax and orbax; distribution, configuration and profiling
DATA_AND_CLI = ("data", "data.agnostic", "data.dresscode", "data.features",
                "data.imageio", "data.labels", "data.loader", "data.native",
                "data.raster", "data.resample", "data.synthetic",
                "data.vitonhd", "cli", "cli.eval", "cli.inference",
                "pipelines.drivers", "core.dtypes", "core.rng", "client",
                "cli.serve", "cli.val_metrics", "cli.generate_fid_stats",
                "cli.compute_cloth_clip_features", "pipelines.serving",
                "metrics", "metrics.compute", "metrics.fid",
                "metrics.inception", "metrics.lpips", "metrics.ssim",
                "train", "train.steps", "train.tps_steps", "train.runner",
                "models.vgg", "pipelines.inpaint", "cli.train_vto",
                "cli.train_emasc", "cli.train_inversion_adapter",
                "cli.train_tps", "ops._autograd", "core.distributed",
                "core.mesh", "core.config", "parallel", "parallel.launch",
                "parallel.sharding", "parallel.tp", "parallel.dryrun",
                "utils.profiling")


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
        print(" ".join(names))
    """)
    proc = _run(code, ROOT, "-c")
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 45
    missing = [m for m in DATA_AND_CLI
               if f"ladi_vton_tpu_torch.{m}" not in names]
    assert not missing, missing


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
