"""The import fence: the benchmark measures the PyTorch port alone. The
JAX package, JAX and its libraries are named by their top-level module
names, compared whole (the port's own name begins with the JAX package's
and is allowed)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

BANNED = frozenset({"jax", "jaxlib", "flax", "doa_tpu"})
PROGRAM = "doa_tpu_torch"


def loaded_banned(modules=None) -> list:
    """The banned top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & BANNED)


def imports_of(path: Path) -> set:
    """The top-level names a Python file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.add(node.args[0].value.split(".")[0])
    return out
