"""The kernel library's build (mvskit_tpu_torch/ops/_build.py) and its
timing tool (tools/bench_build.py), driven on the CPU through a stand-in
nvcc that logs its arguments and writes the file it is asked for. The
real compile runs on the card's machine only (chip_smoke.py)."""

import sys

from mvskit_tpu_torch.ops import _build
from mvskit_tpu_torch.tools import bench_build


def _stand_in_nvcc(tmp_path):
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').write('stand-in')\n")
    fake.chmod(0o755)
    return str(fake), log


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    nvcc, log = _stand_in_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    out = tmp_path / "lib" / "libmvskit_kernels.so"
    out.parent.mkdir()
    assert _build.build(out) == out and out.exists()
    calls = [c.split() for c in log.read_text().splitlines()]
    cu = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert len(cu) >= 2 and len(calls) == len(cu) + 1
    compiled = sorted(c[-1].rsplit("/", 1)[-1] for c in calls[:-1])
    assert compiled == cu and all("-c" in c and "-shared" not in c for c in calls[:-1])
    assert "-shared" in calls[-1] and "-c" not in calls[-1]
    # the objects go once linked; the ptxas report stays beside the library
    assert sorted(p.name for p in out.parent.iterdir()) == ["libmvskit_kernels.so", "ptxas.txt"]
    assert _build.build(out) == out and len(log.read_text().splitlines()) == len(calls)


def test_bench_build_times_each_way(tmp_path, monkeypatch):
    nvcc, log = _stand_in_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    rec = bench_build.run(reps=2)
    ways = rec["ways"]
    cu = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert ways["parallel"]["sources"] == cu == ways["one_nvcc"]["sources"]
    assert ways["forward_only"]["sources"] == ["sample_windows.cu"]
    assert all(len(w["seconds"]) == 2 and min(w["seconds"]) > 0 for w in ways.values())
    # per rep: one compile per source and a link, then two single calls
    assert len(log.read_text().splitlines()) == 2 * (len(cu) + 1 + 2)
