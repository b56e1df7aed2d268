"""The multi-process tier of mvskit_tpu_torch (mirrors tests/test_multihost.py):
two OS processes, joined by torch.distributed over gloo, each owning
two view shards on the CPU (4 views in all), score the same patches
with view-sharded NCC (parallel/multihost.enable_view_sharding_global):
each holds only its own views' planes, and one all_reduce combines the
ranks' windows. The result must equal the single-process value exactly.
So must the gradient-polished refinement of the same patches, whose
gradient each rank takes only through its own windows and sums over the
ranks (parallel/multihost.sum_grads); and the polish must move a patch.
Every process has a timeout and is killed when it expires."""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_view_sharded_ncc(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mvskit_tpu_torch.tools.multihost_ncc", str(r), "2",
         str(port), outs[r], "--backend", "gloo", "--device", "cpu",
         "--local-shards", "2"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, se = p.communicate(timeout=TIMEOUT_S)
            errs.append(se[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs
    for r, out in enumerate(outs):
        with open(out) as f:
            rec = json.load(f)
        assert rec["rank"] == r and rec["processes"] == 2 and rec["backend"] == "gloo"
        assert rec["global_shards"] == 4 and rec["local_shards"] == 2
        # only this rank's views: one per local shard, none at home
        assert rec["local_plane_views"] == [1, 1] and rec["home_plane_views"] == 0
        assert rec["equal"] and rec["max_abs_diff"] == 0.0
        assert rec["polish_equal"] and rec["polish_moved"] > 0
