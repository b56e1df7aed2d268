"""Nothing of JAX or the JAX package in the benchmark: the run's check of
loaded modules by whole top-level name, and the sources' imports."""

import ast

from mvsbench import run


def test_forbidden_modules_by_top_level_name():
    found = run.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                   "mvskit_tpu", "mvskit_tpu.ops.ncc", "mvskit_tpu_torch",
                                   "mvskit_tpu_torch.ops", "jaxtyping", "numpy"])
    assert found == ["flax", "jax", "jaxlib", "mvskit_tpu"]
    assert run.forbidden_modules(["mvskit_tpu_torch.pipeline.driver", "torch"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in run.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN + ("bench",), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (run.HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "os", "typing", "numpy",
                                          "torch"), (path, name)
