"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def test_port_imports_neither_jax_nor_repro_at_run_time():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_have_no_jax_or_repro_imports():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert len(_port_files()) > 15
    assert not offenders, offenders


def test_the_serving_modules_of_every_family_are_covered():
    """The scans above reach the encoder-decoder, the frontends, the
    configs and the training modules (no list to keep: every file under
    the port is walked)."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"models/encdec.py", "models/frontends.py", "models/lm.py",
            "configs/jamba_1_5_large.py", "configs/whisper_base.py",
            "configs/internvl2_26b.py", "launch/steps.py",
            "launch/train.py", "optim/adamw.py", "optim/adafactor.py",
            "optim/schedule.py", "optim/compression.py",
            "data/pipeline.py", "checkpoint/ckpt.py",
            "runtime/fault_tolerance.py"} <= names
