"""The port's native .patch encoder (``csrc/plyio.cpp:patch_write`` through
``io/native.py:write_patches`` and ``io/patch_io.py:write_patch_arrays``)
against the Python writers, the port's and the JAX package's
``write_patch_file``: the same bytes for special and boundary float
values, empty tables and lists, full and wide rows, -1 holes anywhere in
a row, non-identity dataset ids and 50,000 random rows. And the driver's
``_encode_and_write``: the same ``.patch`` and ``.ply`` with the library
and without it (``MVSKIT_NO_NATIVE``, in a subprocess since the loader
caches), each naming its encoder in ``patch_io.WRITERS`` and in the
``writer`` attribute of its span."""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from mvskit_tpu.io import patch_io as jpatch
from mvskit_tpu_torch.io import native
from mvskit_tpu_torch.io import patch_io as tpatch
from mvskit_tpu_torch.io import ply as tply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 values, each with the text repr(float(v)) gives it: the special
# values, float32 renderings of decimal literals, and exact values on each
# side of the fixed / exponent boundaries (decimal exponent -4 and 16)
FLOAT_TEXT = [
    (0.0, "0.0"), (-0.0, "-0.0"), (1.0, "1.0"), (-2.0, "-2.0"), (0.5, "0.5"),
    (1234.5, "1234.5"), (1e10, "10000000000.0"),
    (1e-4, "9.999999747378752e-05"), (1e-5, "9.999999747378752e-06"),
    (1.5e-5, "1.4999999621068127e-05"), (1e15, "999999986991104.0"),
    (1e16, "1.0000000272564224e+16"),
    (2.0 ** -13, "0.0001220703125"), (2.0 ** -14, "6.103515625e-05"),
    (2.0 ** 53, "9007199254740992.0"), (2.0 ** 54, "1.8014398509481984e+16"),
    (float(np.finfo(np.float32).max), "3.4028234663852886e+38"),
    (float(np.finfo(np.float32).smallest_subnormal), "1.401298464324817e-45"),
    (0.1, "0.10000000149011612"),
    (float("nan"), "nan"), (-float("nan"), "nan"),
    (float("inf"), "inf"), (float("-inf"), "-inf"),
]


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native library did not load (no g++, or MVSKIT_NO_NATIVE set): "
                    "there is no native encoder to compare")


def _table(rng, n, width, vwidth, holes=0.3, ids=None, bits=False):
    """n rows: float32 fields (random bit patterns with `bits`: NaNs,
    infinities and subnormals among them) and padded id arrays with a
    `holes` share of -1 anywhere in a row, ids drawn from `ids`."""
    if bits:
        f = rng.integers(0, 2 ** 32, (n, 11), dtype=np.uint64).astype(np.uint32).view(np.float32)
    else:
        f = rng.normal(size=(n, 11)).astype(np.float32)
    ids = np.arange(64) if ids is None else np.asarray(ids)

    def padded(w):
        a = ids[rng.integers(0, len(ids), (n, w))].astype(np.int32)
        a[rng.uniform(size=(n, w)) < holes] = -1
        return a

    return (f[:, :4].copy(), f[:, 4:8].copy(), f[:, 8].copy(), f[:, 9].copy(),
            f[:, 10].copy(), padded(width), padded(vwidth))


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "float_values":
        v = np.array([x for x, _ in FLOAT_TEXT], np.float32)
        n = len(v)
        f = np.stack([np.roll(v, k) for k in range(11)], 1)
        t = _table(rng, n, 4, 2)
        return (f[:, :4].copy(), f[:, 4:8].copy(), f[:, 8].copy(), f[:, 9].copy(),
                f[:, 10].copy(), t[5], t[6])
    if name == "no_patches":
        return _table(rng, 0, 16, 16)
    if name == "empty_lists":
        return _table(rng, 30, 16, 16, holes=1.0)
    if name == "full_width":
        return _table(rng, 30, 16, 16, holes=0.0)
    if name == "width47":
        return _table(rng, 200, 47, 47)
    if name == "holes_mid_row":
        t = _table(rng, 4, 6, 3, holes=0.0)
        t[5][:] = [[5, -1, 7, -1, -1, 9], [-1, -1, 2, 3, -1, -1], [1, 2, 3, 4, 5, -1],
                   [-1, -1, -1, -1, -1, 8]]
        t[6][:] = [[-1, 4, -1], [6, -1, 6], [-1, -1, -1], [0, 0, -1]]
        return t
    if name == "dataset_ids":
        return _table(rng, 100, 8, 8, ids=[12345678, 0, 7, 99999999, 1000, 31])
    if name == "random_50k":
        return _table(rng, 50_000, 16, 16, ids=np.arange(3, 200, 7), bits=True)
    raise KeyError(name)


def _lists(padded):
    return [[int(v) for v in row if v >= 0] for row in padded]


@pytest.mark.parametrize("name", ["float_values", "no_patches", "empty_lists", "full_width",
                                  "width47", "holes_mid_row", "dataset_ids", "random_50k"])
def test_native_bytes_equal_python_writers(lib, tmp_path, name):
    t = _case(name)
    assert native.write_patches(str(tmp_path / "n.patch"), *t)
    for mod, tag in ((tpatch, "t"), (jpatch, "j")):
        mod.write_patch_file(str(tmp_path / f"{tag}.patch"), *t[:5], _lists(t[5]), _lists(t[6]))
    got = (tmp_path / "n.patch").read_bytes()
    assert got == (tmp_path / "t.patch").read_bytes()
    assert got == (tmp_path / "j.patch").read_bytes()
    back = tpatch.read_patch_file(str(tmp_path / "n.patch"))
    assert back["images"] == _lists(t[5]) and back["vimages"] == _lists(t[6])


@pytest.mark.parametrize("value,text", FLOAT_TEXT, ids=[t for _, t in FLOAT_TEXT])
def test_native_float_text(lib, tmp_path, value, text):
    assert repr(float(np.float32(value))) == text
    v = np.full((1, 4), value, np.float32)
    one = np.full(1, value, np.float32)
    ids = np.array([[3, -1, 12]], np.int32)
    assert native.write_patches(str(tmp_path / "v.patch"), v, v, one, one, one, ids, ids[:, :0])
    assert (tmp_path / "v.patch").read_text() == (
        f"PATCHES\n1\nPATCHES\n{' '.join([text] * 4)}\n{' '.join([text] * 4)}\n"
        f"{' '.join([text] * 3)}\n2\n3 12\n0\n\n")


def test_native_refuses_other_dtypes(lib, tmp_path):
    t = list(_case("holes_mid_row"))
    for i, bad in ((0, t[0].astype(np.float64)), (2, t[2][:3]), (5, t[5].astype(np.int64)),
                   (6, t[6][:2])):
        args = t[:i] + [bad] + t[i + 1:]
        with pytest.raises(ValueError):
            native.write_patches(str(tmp_path / "x.patch"), *args)


# the driver's encode under the span recorder, to a binary and an ascii
# PLY beside the patch file; prints what it counted
_ENCODE = """
import json, sys
import numpy as np
from mvskit_tpu_torch.io import patch_io
from mvskit_tpu_torch.pipeline.driver import _encode_and_write
from mvskit_tpu_torch.utils import profiling

data = dict(np.load(sys.argv[1]))
rgb, image_ids = data.pop("rgb"), data.pop("image_ids")
with profiling.tracing() as tr:
    for binary in (True, False):
        with profiling.span("encode"):
            _encode_and_write(f"{sys.argv[2]}_{int(binary)}", data, rgb, image_ids, True, True,
                              binary)
print(json.dumps({"writers": dict(patch_io.WRITERS),
                  "attrs": [s.attrs for s in tr.spans if s.name == "encode"]}))
"""


def _encode(tmp_path, data, no_native):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MVSKIT_NO_NATIVE", None)
    if no_native:
        env["MVSKIT_NO_NATIVE"] = "1"
    prefix = str(tmp_path / ("python" if no_native else "native") / "final")
    out = subprocess.run([sys.executable, "-c", _ENCODE, str(tmp_path / "data.npz"), prefix],
                         env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return prefix, json.loads(out.stdout.strip().splitlines()[-1])


def test_driver_writes_same_files_with_and_without_library(lib, tmp_path):
    rng = np.random.default_rng(7)
    n, views = 500, 10
    coord, normal, ncc, ds, asc, _, _ = _table(rng, n, 1, 1)

    def indices(w):
        a = rng.integers(0, views, (n, w)).astype(np.int32)
        a[rng.uniform(size=(n, w)) < 0.4] = -1
        return a

    data = dict(coord=coord, normal=normal, ncc=ncc, dscale=ds, ascale=asc,
                images=indices(views), vimages=indices(views),
                rgb=rng.integers(0, 256, (n, 3)).astype(np.uint8),
                image_ids=np.array([40, 3, 17, 0, 99, 5, 1234, 8, 60, 2], np.int32))
    np.savez(tmp_path / "data.npz", **data)
    lib_prefix, with_lib = _encode(tmp_path, data, no_native=False)
    py_prefix, without = _encode(tmp_path, data, no_native=True)
    assert with_lib == {"writers": {"native": 2}, "attrs": [{"writer": "native"}] * 2}
    assert without == {"writers": {"python": 2}, "attrs": [{"writer": "python"}] * 2}
    ids = data["image_ids"]
    for binary in (1, 0):
        a, b = f"{lib_prefix}_{binary}", f"{py_prefix}_{binary}"
        assert open(a + ".patch", "rb").read() == open(b + ".patch", "rb").read()
        # the lists hold the dataset ids of the indices, holes dropped
        back = tpatch.read_patch_file(a + ".patch")
        for k in ("images", "vimages"):
            assert back[k] == [[int(ids[v]) for v in row if v >= 0] for row in data[k]]
        if binary:
            assert open(a + ".ply", "rb").read() == open(b + ".ply", "rb").read()
        else:
            # the ascii PLYs differ in text (the library prints %.9g,
            # Python repr), each of which reads back as the same float32
            pa, pb = tply.read_ply(a + ".ply"), tply.read_ply(b + ".ply")
            assert sorted(pa) == sorted(pb)
            for k in pa:
                np.testing.assert_array_equal(pa[k].astype(np.float32),
                                              pb[k].astype(np.float32))
