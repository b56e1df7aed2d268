"""The port's public surface against the JAX package's, name by name.

Every ``.py`` file under ``mvskit_tpu/`` is parsed with ``ast`` (neither
package is imported). Its public names are the top-level ``def`` and
``class`` names that do not start with ``_``, and the public methods of
each top-level class as ``Class.method``. The file at the same relative
path under ``mvskit_tpu_torch/`` must define each of them: top level, or
as a method of the class of the same name. Nested functions are not
top level and so are out of the sweep.

``NOT_PORTED`` holds the deliberate omissions: a relative path (the
whole module) or ``relpath:name``, each with a one-line reason naming
where the port does that job or why it has none. An entry that the
port does define, or that names nothing in the JAX package, fails, so
the list cannot go stale.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "mvskit_tpu")
PORT_PKG = os.path.join(REPO, "mvskit_tpu_torch")

NOT_PORTED = {
    "ops/pallas_ncc.py":
        "the TPU sampler's pallas_call with its tile plans, padded level planes and "
        "enable switches: its five forms are csrc/sample_windows.cu behind "
        "ops/cuda_ncc.py (plans: grouped_plan / ungrouped_plan / fused_plan; planes: "
        "Scene.planes_packed / planes_luma_quad; switch: Scene.use_kernel)",
    "ops/ncc.py:get_tex":
        "no caller in the JAX package; every window fetch goes through "
        "ops/ncc.py texs_for_views_illums",
    "image/scene.py:Scene.tree_flatten":
        "JAX pytree hook; the port's Scene is a plain dataclass of tensors",
    "image/scene.py:Scene.tree_unflatten":
        "JAX pytree hook; the port's Scene is a plain dataclass of tensors",
    "parallel/shard.py:table_sharding":
        "a JAX NamedSharding tree for the table; the port's table stays on its home "
        "device and each stage deals its rows to the dp devices (parallel/shard.py "
        "deal_rows, row_blocks)",
    "parallel/shard.py:shard_table":
        "the device_put by table_sharding; the port deals rows per stage instead "
        "(parallel/shard.py deal_rows, row_blocks), bit-equal to the unsharded run "
        "(tests/test_torch_dp.py)",
}

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def public_names(path):
    """Top-level public defs and classes, and ``Class.method`` for each
    public method of a top-level class."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in tree.body:
        if not isinstance(node, _DEFS) or node.name.startswith("_"):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(
                f"{node.name}.{m.name}" for m in node.body
                if isinstance(m, _DEFS) and not m.name.startswith("_"))
    return names


def jax_files():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for fn in files:
            if fn.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, fn), JAX_PKG))
    return sorted(p.replace(os.sep, "/") for p in out)


def port_names(rel):
    path = os.path.join(PORT_PKG, rel)
    return public_names(path) if os.path.exists(path) else None


def missing_names(rel):
    """Public names of the JAX file `rel` that the port's file lacks and
    NOT_PORTED does not excuse."""
    if rel in NOT_PORTED:
        return []
    want = public_names(os.path.join(JAX_PKG, rel))
    have = port_names(rel) or set()
    return sorted(n for n in want - have if f"{rel}:{n}" not in NOT_PORTED)


def stale_reason(key):
    """Why a NOT_PORTED entry is stale, or None when it still holds."""
    rel, _, name = key.partition(":")
    jax_path = os.path.join(JAX_PKG, rel)
    if not os.path.exists(jax_path):
        return f"no file {rel} in mvskit_tpu"
    have = port_names(rel)
    if not name:
        return None if have is None else f"the port has {rel}: list its names instead"
    if name not in public_names(jax_path):
        return f"mvskit_tpu/{rel} defines no public {name}"
    if have is not None and name in have:
        return f"the port defines {name} in {rel}"
    return None


FILES = jax_files()


def test_sweep_finds_the_packages():
    assert len(FILES) >= 30, FILES
    assert "pipeline/filters.py" in FILES
    names = public_names(os.path.join(JAX_PKG, "core/patches.py"))
    assert {"PatchTable", "PatchTable.n_images_per_patch", "empty_table"} <= names


def test_nested_functions_are_out_of_the_sweep():
    names = public_names(os.path.join(JAX_PKG, "pipeline/filters.py"))
    assert "filter_neighbor" in names
    assert not {"one", "body", "edge_of"} & names


@pytest.mark.parametrize("rel", FILES)
def test_port_defines_every_public_name(rel):
    missing = missing_names(rel)
    assert not missing, (
        f"mvskit_tpu_torch/{rel} lacks {missing}: port them, or add each to "
        f"NOT_PORTED with a one-line reason")


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entry_holds(key):
    reason = NOT_PORTED[key]
    assert reason.strip() and "\n" not in reason, f"{key}: one line of reason"
    stale = stale_reason(key)
    assert stale is None, f"NOT_PORTED[{key!r}] is stale: {stale}"
