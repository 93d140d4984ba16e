"""The port (druglamp_tpu_torch/) and chip_smoke.py import neither JAX nor
anything of the JAX package, nor ml_dtypes (the card's machine has none: the
port's bf16 host arrays are uint16 bit patterns, data/cache.py).  Importing
the port loads neither ``transformers`` nor ``safetensors`` either: the
card's machine has neither, and the HF tokenizer and the .safetensors reader
import them only when they are used."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "druglamp_tpu")
PORT_FILES = sorted((ROOT / "druglamp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


# The modules of the device-resident epoch and the packed GCN kernel, of the
# SSL/CM gates and the Trainer, of the host pipeline and the training CLI, and
# of the frozen encoders (the glob above must reach them).
SLICE_MODULES = ("kernels/gcn.py", "data/device_data.py", "data/device_store.py",
                 "data/dataset.py", "data/cache.py", "eval/metrics.py", "train/steps.py",
                 "nn/layers.py", "losses/masking.py", "losses/schedules.py", "models/ssl.py",
                 "models/cm.py", "models/base.py", "models/druglamp.py", "convert.py",
                 "train/state.py", "train/schedule.py", "train/trainer.py",
                 "utils/logging.py", "config.py", "data/loader.py", "cli/main.py",
                 "cli/sweep.py", "chem/tokenizer.py", "chem/hf_tokenizer.py",
                 "encoders/__init__.py", "encoders/layers.py", "encoders/esm2.py",
                 "encoders/chemberta.py", "encoders/convert.py", "encoders/embed_pipeline.py")
LAZY = ("transformers", "safetensors")     # imported only where used, never at import


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_checked(module):
    assert ROOT / "druglamp_tpu_torch" / module in PORT_FILES


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import druglamp_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(druglamp_tpu_torch.__path__, 'druglamp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "print('ok')\n" % (FORBIDDEN + LAZY,)
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
