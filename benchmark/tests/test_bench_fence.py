"""The import fence: nothing under benchmark/ imports JAX, its libraries or
the JAX package (top-level module names compared whole), and the plain
references import nothing of the program either."""

from pathlib import Path

import pytest

from harness import fence
from harness.spec import BENCH_DIR

SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def test_the_sources_are_found():
    names = {p.relative_to(BENCH_DIR).as_posix() for p in SOURCES}
    assert {"run.py", "harness/runner.py", "reference/common.py",
            "metrics/covariance_roofline.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(BENCH_DIR).as_posix())
def test_no_jax_import(path: Path):
    assert not fence.imports_of(path) & fence.BANNED


@pytest.mark.parametrize(
    "path", sorted((BENCH_DIR / "reference").rglob("*.py")),
    ids=lambda p: p.relative_to(BENCH_DIR).as_posix())
def test_the_reference_imports_nothing_of_the_program(path: Path):
    assert fence.PROGRAM not in fence.imports_of(path)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import doa_tpu_torch.ops\nfrom jaxtyping import x\n"
                   "import importlib\nimportlib.import_module('doa_tpu.io')\n")
    assert fence.imports_of(src) == {"doa_tpu_torch", "jaxtyping",
                                     "importlib", "doa_tpu"}
    assert fence.loaded_banned(["doa_tpu_torch.ops", "jaxtyping",
                                "numpy"]) == []
    assert fence.loaded_banned(["doa_tpu.configs", "jax._src",
                                "flax"]) == ["doa_tpu", "flax", "jax"]
