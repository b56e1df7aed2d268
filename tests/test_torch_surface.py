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

The same walk holds call signatures. For every public function and
``Class.method`` (``__init__`` included) that both files define, the
port's positional parameters begin with JAX's, in JAX's order, so a
call written for the JAX signature binds the same parameters in the
port; port-only parameters come after them. Every JAX keyword-only
parameter is a parameter of the port's. A name may differ only through
``SUBSTITUTIONS``, a JAX parameter may be missing only through
``DROPPED`` and a whole function may differ only through
``EXEMPT_SIGNATURES``, each entry with a one-line reason; an entry that
no longer matches anything fails.
"""

import ast
import functools
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


# "JAX -> port" renames allowed anywhere, or only in one function when the
# key starts with "relpath:name ".
SUBSTITUTIONS = {
    "key -> noise":
        "a JAX PRNG key becomes a round's noise source (pipeline/propagate.py "
        "TorchNoise, or the tests' replay of JAX's draws)",
    "key -> deltas":
        "a JAX PRNG key becomes the refinement's drawn candidate offsets, which the "
        "caller draws from its noise source",
    "key -> jitter":
        "a JAX PRNG key becomes the donors' drawn pixel jitter, which the caller draws "
        "from its noise source",
    "dtype -> device":
        "the JAX camera arrays take a dtype; the port's are float32 tensors and take "
        "the device they live on",
    "pallas_levels -> device":
        "the JAX scene builds the Pallas level planes host-side on request; the port "
        "always builds its planes and takes the device instead",
    "parallel/shard.py:replicate mesh -> device":
        "a JAX replicated NamedSharding over a mesh becomes a copy on one device; the "
        "port replicates per dp device (parallel/shard.py replicas)",
}

# "relpath:name parameter" -> why the port has no such parameter.
DROPPED = {
    "pipeline/refine.py:refine_batch grad_steps":
        "the differentiable polish is retired (GRADPOLISH.json); "
        "cfg.refine_grad_steps > 0 raises in pipeline/driver.py check_supported",
    "pipeline/refine.py:refine_batch grad_lr":
        "the step size of the retired differentiable polish (GRADPOLISH.json)",
}

# "relpath:name" -> why its signature is the port's own.
EXEMPT_SIGNATURES = {
    "parallel/multihost.py:init_distributed":
        "torch.distributed by design: backend, init_method, world_size and rank are "
        "explicit, where JAX reads a pod's coordinator",
    "parallel/multihost.py:global_view_mesh":
        "torch.distributed by design: the mesh is built from each rank's own devices "
        "and a process group, where JAX reads jax.devices()",
}


def _scoped(key):
    """("relpath:name" or None, rest) of a SUBSTITUTIONS / DROPPED key."""
    head, sep, rest = key.partition(" ")
    return (head, rest) if sep and ":" in head else (None, key)


def signatures(src):
    """{name: ast.arguments} of the top-level public functions and of the
    public methods (and ``__init__``) of the top-level public classes."""
    out = {}
    for node in ast.parse(src).body:
        if not isinstance(node, _DEFS) or node.name.startswith("_"):
            continue
        if isinstance(node, ast.ClassDef):
            out.update(
                (f"{node.name}.{m.name}", m.args) for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (m.name == "__init__" or not m.name.startswith("_")))
        else:
            out[node.name] = node.args
    return out


def _positional(args):
    return [a.arg for a in args.posonlyargs + args.args]


def signature_faults(rel, jax_src, port_src, used=None):
    """The shared functions of `rel` whose port signature breaks the rule,
    one message each. Adds every SUBSTITUTIONS / DROPPED /
    EXEMPT_SIGNATURES key that excused a difference to `used`."""
    used = set() if used is None else used
    jax_sigs, port_sigs = signatures(jax_src), signatures(port_src)
    faults = []
    for name in sorted(set(jax_sigs) & set(port_sigs)):
        fn = f"{rel}:{name}"
        if fn in EXEMPT_SIGNATURES:
            used.add(fn)
            continue
        ja, pa = jax_sigs[name], port_sigs[name]
        port_pos = _positional(pa)
        port_all = set(port_pos) | {a.arg for a in pa.kwonlyargs}

        def renamed(j, p):
            for key in SUBSTITUTIONS:
                scope, rest = _scoped(key)
                if rest == f"{j} -> {p}" and scope in (None, fn):
                    used.add(key)
                    return True
            return False

        def dropped(j):
            key = f"{fn} {j}"
            if key in DROPPED and j not in port_all:
                used.add(key)
                return True
            return False

        bad = []
        i = 0
        for j in _positional(ja):
            if dropped(j):
                continue
            p = port_pos[i] if i < len(port_pos) else None
            if p is None:
                bad.append(f"JAX positional {j!r} is not positional in the port")
            elif p != j and not renamed(j, p):
                bad.append(f"position {i}: JAX {j!r}, port {p!r}")
            i += 1
        for j in (a.arg for a in ja.kwonlyargs):
            if j not in port_all and not dropped(j) and not any(
                    renamed(j, p) for p in port_all):
                bad.append(f"JAX keyword {j!r} is missing")
        if ja.vararg and not pa.vararg:
            bad.append(f"JAX takes *{ja.vararg.arg}, the port does not")
        if bad:
            faults.append(f"{name}: " + "; ".join(bad))
    return faults


@functools.lru_cache(maxsize=None)
def _source(path):
    with open(path) as f:
        return f.read()


def file_signature_faults(rel, used=None):
    port = os.path.join(PORT_PKG, rel)
    if rel in NOT_PORTED or not os.path.exists(port):
        return []
    return signature_faults(rel, _source(os.path.join(JAX_PKG, rel)), _source(port),
                            used)


@pytest.mark.parametrize("rel", FILES)
def test_port_signatures_follow_jax(rel):
    faults = file_signature_faults(rel)
    assert not faults, (
        f"mvskit_tpu_torch/{rel}: {faults}. Put JAX's positional parameters first, "
        f"in JAX's order, and the port's own after them, keyword-only; or add an "
        f"entry to SUBSTITUTIONS / DROPPED / EXEMPT_SIGNATURES with a one-line reason")


def _used_entries():
    used = set()
    for rel in FILES:
        file_signature_faults(rel, used)
    return used


@pytest.mark.parametrize("key", sorted(SUBSTITUTIONS) + sorted(DROPPED)
                         + sorted(EXEMPT_SIGNATURES))
def test_signature_entry_holds(key):
    reason = {**SUBSTITUTIONS, **DROPPED, **EXEMPT_SIGNATURES}[key]
    assert reason.strip() and "\n" not in reason, f"{key}: one line of reason"
    assert key in _used_entries(), f"{key!r} excuses no difference: remove it"


JAX_SRC = """
def f(scene, table, row_start=0, row_count=None, row_limit=None):
    pass

def g(a, key, b=1):
    pass

class C:
    def __init__(self, cfg, scene=None, log=print, view_mesh=None):
        pass
"""


def test_signature_check_finds_a_swapped_pair():
    assert signature_faults("core/x.py", JAX_SRC, JAX_SRC) == []
    port = JAX_SRC.replace("row_start=0, row_count=None, row_limit=None",
                           "row_limit=None, row_start=0, row_count=None")
    port = port.replace("log=print, view_mesh=None",
                        "log=print, device='cuda', view_mesh=None")
    faults = signature_faults("core/x.py", JAX_SRC, port)
    assert [f.split(":")[0] for f in faults] == ["C.__init__", "f"], faults
    assert "position 2: JAX 'row_start', port 'row_limit'" in faults[1]
    assert "position 4: JAX 'view_mesh', port 'device'" in faults[0]


def test_signature_check_takes_keyword_only_port_parameters_and_renames():
    port = JAX_SRC.replace("row_limit=None):", "row_limit=None, *, dp_devices=None):")
    port = port.replace("view_mesh=None):", "view_mesh=None, *, device='cuda'):")
    assert signature_faults("core/x.py", JAX_SRC, port) == []
    used = set()
    renamed = port.replace("def g(a, key, b=1)", "def g(a, noise, b=1)")
    assert signature_faults("core/x.py", JAX_SRC, renamed, used) == []
    assert used == {"key -> noise"}
    unlisted = port.replace("def g(a, key, b=1)", "def g(a, seed, b=1)")
    assert signature_faults("core/x.py", JAX_SRC, unlisted) == [
        "g: position 1: JAX 'key', port 'seed'"]
