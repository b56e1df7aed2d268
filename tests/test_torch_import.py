"""The port stands alone: every submodule of mvskit_tpu_torch and the
CLI's --help run in a subprocess where `import jax` fails (the walk
reaches parallel/*, the e2e and scaling tools and the refinement bench
and studies), and neither the port
nor chip_smoke.py imports any module of mvskit_tpu. Also the explicit
device helper, the options this port covers (the device mesh and the
gradient polish among them) and the reference fault it refuses (the
luma polish after RGB tail rounds)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = "import sys; sys.modules['jax'] = None; "


def _run(code=None, args=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-c", code] if code else [sys.executable, *args]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=REPO)


def test_import_all_submodules_without_jax():
    code = BLOCK_JAX + (
        "import importlib, pkgutil, mvskit_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, m.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert not [k for k in sys.modules\n"
        "            if k == 'mvskit_tpu' or k.startswith('mvskit_tpu.')]\n"
        "assert sys.modules['jax'] is None\n"
        "need = {'mvskit_tpu_torch.parallel.' + m for m in ('shard', 'tiles', 'multihost')}\n"
        "need |= {'mvskit_tpu_torch.tools.' + m for m in ('e2e_run', 'bench_scaling', 'bench',\n"
        "         'bench_refine_parts', 'ab_refine_chip', 'ab_luma', 'ab_gradpolish',\n"
        "         'coverage_sweep')}\n"
        "assert need <= set(names), need - set(names)\n"
        "print(len(names))\n"
    )
    res = _run(code=code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 15


def test_cli_help_without_jax():
    code = BLOCK_JAX + (
        "import runpy; sys.argv = ['mvskit_tpu_torch', '--help']\n"
        "runpy.run_module('mvskit_tpu_torch', run_name='__main__')\n"
    )
    res = _run(code=code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "--device" in res.stdout and "--filter-only" in res.stdout
    for flag in ("--iterations", "--prop-rounds", "--no-snapshots", "--max-patches",
                 "--donor-budget", "--chunk", "--refine-rounds", "--refine-cands",
                 "--strategy", "--mesh"):
        assert flag in res.stdout, flag


def _imported_modules(path):
    """Every module named by an import statement of the file at `path`
    (absolute names; relative imports resolved against `package`)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    rel = os.path.relpath(path, REPO)[:-3].split(os.sep)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = rel[:len(rel) - node.level]
                names.append(".".join(base + ([node.module] if node.module else [])))
            else:
                names.append(node.module)
    return names


def _is_jax_package(name):
    return name == "mvskit_tpu" or name.startswith("mvskit_tpu.")


def test_no_import_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(REPO, "mvskit_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) >= 30
    bad = {os.path.relpath(f, REPO): [n for n in _imported_modules(f) if _is_jax_package(n)]
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
    # chip_smoke.py drives the port's modules
    assert any(n.startswith("mvskit_tpu_torch")
               for n in _imported_modules(os.path.join(REPO, "chip_smoke.py")))


def test_get_device_is_explicit():
    from mvskit_tpu_torch import get_device

    assert get_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            get_device("cuda")
    with pytest.raises(ValueError):
        get_device("meta")


def test_luma_polish_after_rgb_tail_raises():
    """A reference fault not copied: JAX's polish scores luma while a
    luma search with RGB tail rounds ends on an RGB incumbent, and
    compares the two (JAX refine.py:299). The port refuses it with
    ValueError in check_supported and in refine_batch; with
    refine_rgb_tail 0 both run."""
    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.pipeline import refine as rf
    from mvskit_tpu_torch.pipeline import views as vw
    from mvskit_tpu_torch.pipeline.driver import check_supported
    from mvskit_tpu_torch.utils import synthetic

    cfg = MVSConfig(images=list(range(4)))
    cfg.luma_refine, cfg.refine_rgb_tail, cfg.refine_grad_steps = True, 2, 2
    with pytest.raises(ValueError, match="refine.py:299"):
        check_supported(cfg)
    cfg.refine_rgb_tail = 0
    check_supported(cfg)

    Ps, _, scene = synthetic.plane_scene(n_views=4, width=80, height=60, device="cpu")
    coord, normal = (torch.as_tensor(a, dtype=torch.float32)
                     for a in synthetic.plane_points(Ps, 8, extent=0.3))
    images = torch.full((8, 4), -1, dtype=torch.int32)
    images = vw.add_images(scene, coord, normal, images, 1, 1.0471976)
    images = vw.sort_images(scene, coord, normal, images, 1, is_fixed=False)
    dscale, _ = vw.set_scales(scene, coord, images, 1, 4, 7)
    kw = dict(level=1, wsize=7, tau=4, min_image_num=2, angle_threshold1=1.0471976,
              ascale=cfg.ascale, rounds=2, n_cands=4, shrink=0.8, init_depth_radius=4.0,
              init_angle_radius=8.0, luma=True, grad_steps=2)
    args = (scene, coord, normal, images, dscale, torch.zeros(2, 8, 4, 3))
    with pytest.raises(ValueError, match="refine.py:299"):
        rf.refine_batch(*args, rgb_tail=2, **kw)
    res = rf.refine_batch(*args, rgb_tail=0, **kw)
    assert res.coord.shape == (8, 4) and torch.isfinite(res.cost).all()


@pytest.mark.parametrize("field,value", [
    ("luma_refine", True),
    ("nillums", 3),
    ("strategy", "pmvs"),
    ("mesh_view", 2),
    ("refine_grad_steps", 4),
])
def test_ported_options_accepted(field, value):
    from mvskit_tpu_torch.config import MVSConfig
    from mvskit_tpu_torch.pipeline.driver import check_supported

    cfg = MVSConfig(images=list(range(4)))
    setattr(cfg, field, value)
    check_supported(cfg)
