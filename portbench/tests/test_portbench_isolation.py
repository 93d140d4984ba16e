"""Nothing the benchmark runs imports JAX, its companions or the JAX package,
and the plain reference imports nothing of the program.  Modules are
compared by their whole top-level name: ``druglamp_tpu_torch`` begins with
``druglamp_tpu``, so a test of the prefix would be wrong."""

import subprocess
import sys

from harness import main as M

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "druglamp_tpu"}


def _imported(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    prog = ("import sys; sys.path[:0] = [{!r}, {!r}]\n{}\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(
                str(M.HERE), str(M.HERE.parent), code)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program():
    names = _imported("import reference.model, reference.step")
    assert not names & (FORBIDDEN | {"druglamp_tpu_torch"})


def test_a_run_holds_no_jax_module():
    names = _imported(
        "import sys; sys.path.insert(0, {!r})\nimport tiny\n"
        "tiny.run(tiny.cell('lamp.eval.b512'))".format(str(M.HERE / "tests")))
    assert "druglamp_tpu_torch" in names and "harness" in names
    assert not names & FORBIDDEN


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "druglamp_tpu_torch_fake", sys)
    assert "druglamp_tpu" not in M.forbidden_modules()
    monkeypatch.setitem(sys.modules, "druglamp_tpu.kernels", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert M.forbidden_modules() == ["druglamp_tpu", "jax"]


def test_the_sources_name_no_jax_module():
    for path in M.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in FORBIDDEN, (path, line)
                assert words[1] != "bench", (path, line)
