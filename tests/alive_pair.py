"""The JAX package against the port on one larger CPU dataset, alive
counts per iteration (not a test; too slow for tier-1).

    python tests/alive_pair.py rgb|luma OUT.jsonl [--views 8] [--width 320]
        [--height 240] [--seeds 1024] [--engines jax torch]

Writes a `write_dataset` plane scene under OUT's directory (reused when
it is there), then runs the default config (3 iterations, 8 rounds, 6 x
32 search; `luma_refine` for `luma`) with `refine_group_dma=False` in
both engines: the JAX package's PMMVS, and the port's on the CPU fed
the JAX driver's random numbers (`torch_replay.JaxReplayNoise`), as
tests/test_torch_pipeline.py::run_pair does at its smaller size. After
each iteration it appends one JSON line per engine to OUT: alive counts
so far, alive after each propagation, each propagation's and each
filter phase's counts, and seconds. The two engines start from the
same seeds and noise; float sums in another order can flip near-tie
accepts, so their counts track, not match.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mvskit_tpu.config import MVSConfig as JMVSConfig  # noqa: E402
from mvskit_tpu.pipeline.driver import PMMVS as JPMMVS  # noqa: E402
from mvskit_tpu.utils import synthetic as jsyn  # noqa: E402
from mvskit_tpu_torch.config import MVSConfig as TMVSConfig  # noqa: E402
from mvskit_tpu_torch.pipeline.driver import PMMVS as TPMMVS  # noqa: E402
from torch_replay import JaxReplayNoise  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("rgb", "luma"))
    ap.add_argument("out")
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seeds", type=int, default=1024)
    ap.add_argument("--engines", nargs="+", default=["jax", "torch"],
                    choices=("jax", "torch"))
    args = ap.parse_args(argv)
    torch.set_num_threads(4)  # torch_replay sets 1 for the test workers
    prefix = os.path.join(os.path.dirname(os.path.abspath(args.out)), "scene")
    if not os.path.exists(os.path.join(prefix, "option")):
        jsyn.write_dataset(prefix, n_views=args.views, width=args.width,
                           height=args.height, n_seeds=args.seeds)
    for name in args.engines:
        cfg = (JMVSConfig if name == "jax" else TMVSConfig).from_option_file(prefix)
        cfg.refine_group_dma = False
        cfg.luma_refine = args.mode == "luma"
        t0 = time.time()
        e = (JPMMVS(cfg, log=lambda *a: None) if name == "jax" else
             TPMMVS(cfg, device="cpu", noise=JaxReplayNoise(0), log=lambda *a: None))
        e.seed()
        rec = dict(mode=args.mode, engine=name, alive=[int(np.asarray(e.table.alive).sum())])
        for it in range(cfg.n_iterations):
            rec[f"prop_{it}"] = str(e.propagate(it))
            rec[f"after_propagate_{it}"] = int(np.asarray(e.table.alive).sum())
            rec[f"filter_{it}"] = str(e.filter())
            e.update_threshold()
            e.depth += 1
            rec["alive"].append(int(np.asarray(e.table.alive).sum()))
            rec["seconds"] = time.time() - t0
            with open(args.out, "a") as f:
                f.write(json.dumps(dict(rec, iteration=it)) + "\n")
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
