"""No module of the benchmark imports JAX or the JAX reference package,
and the yardstick (the plain reference, the models, the clip, the work
counts, the check and the control) imports nothing of the program: each
imported module's top-level name is compared whole, since the program's
name begins with the reference's."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
PROGRAM = {"repro_torch"}


def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_reference_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


YARDSTICK = ("reference", "models", "clip.py", "work.py", "check.py", "control.py")


@pytest.mark.parametrize("path", [p for p in MODULES if p.relative_to(HERE).parts[0] in YARDSTICK],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert not _top_level_imports(path) & PROGRAM


def test_the_guard_compares_whole_names(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import repro_torch.core\nfrom jaxtyping import Array\n")
    assert not _top_level_imports(mod) & FORBIDDEN
    mod.write_text("import repro.core\n")
    assert _top_level_imports(mod) & FORBIDDEN == {"repro"}


def test_the_run_refuses_a_process_that_holds_the_reference():
    from chipbench import harness

    held = {"torch": None, "repro_torch.core": None, "repro_torchvision": None}
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules({**held, "repro.core.tracker": None,
                                      "jax.numpy": None}) == ["jax", "repro"]
