"""Where one propagation round and one filter pass spend their time (port
of ``tools/bench_prop_parts.py``).

Loads a dataset, resumes its table from a ``.patch`` file (as the JAX
tool's ``--resume final_patches``), and runs each stage of one round at
the driver's shapes under the JAX tool's names: ``build_grid``,
``select_donors``, ``generate_hypotheses(16k)`` (one axis's donors),
the gauntlet's phases on its first chunk (``pre_process(4k)``,
``refine(4k)``, ``post_process(4k)``, ``vimages(4k)``, the depth >= 2
check's ``check:gain(4k)``, ``check:neighbors(4k)``, ``check:quad(4k)``,
``check:total(4k)``, and ``gauntlet(4k,total)``) and
``propagate_round(full)``; besides them the whole gauntlet
(``gauntlet(full)``), ``insert_patches`` and the filter pass's phases
(``filter:rebuild``, ``filter:outside``, ``filter:exact``,
``filter:neighbor``, ``filter:groups``; each phase on the table its
predecessor leaves, against the first rebuild's grid), which the
driver's report only gives summed. The stages a dp axis partitions run
at dp 1 and at ``--dp`` k (logical shards of the one device); the chunk
pieces do not depend on dp and run once. ``propagate_round(full)`` must give the same
table at every dp.

Each stage records its K1 (``ungrouped``) and K2 (``grouped``) launches
in one call and, on a card, its milliseconds: CUDA events around one
call, the better of two medians of ``--reps`` calls (the stages sync
with the host, so this is the stage's wall time as the card sees it).
On the CPU nothing is timed. The round's random numbers come from a
``TorchNoise`` seeded with 0 anew for every call. The row bound is the
driver's after a resume: the live rows rounded up to a power of two.

    python -m mvskit_tpu_torch.tools.bench_prop_parts --prefix DATASET \\
        --resume PATCH_FILE [--dp 2] [--device cuda] \\
        [--out PROP_PARTS_torch.json]

It writes its record to ``--out`` (the JAX package's ``PROP_PARTS.json``
is not touched) and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _resume_path(prefix: str, resume: str) -> str:
    """A .patch path, or the name of one under <prefix>/ply/."""
    if os.path.exists(resume):
        return resume
    return os.path.join(prefix, "ply", resume + ".patch")


def run(prefix: str, resume: str, max_patches: int = 1 << 18, reps: int = 3, dp: int = 2,
        device="cuda", **overrides):
    """The stage table at dp 1 and dp `dp`. `overrides` set MVSConfig
    fields (e.g. donor_budget, gauntlet_chunk). Returns (record, the
    table propagate_round(full) gives at dp 1)."""
    import torch

    from ..config import MVSConfig
    from ..core import grid as gridmod
    from ..core.grid import pow2_limit
    from ..ops import cuda_ncc
    from ..pipeline import filters as fl
    from ..pipeline import propagate as pr
    from ..pipeline import refine as rf
    from ..pipeline import seed as sd
    from ..pipeline import views as vw
    from ..pipeline.driver import PMMVS
    from ..utils import profiling
    from .bench_grid import stage_ms
    from .e2e_run import card_line

    cfg = MVSConfig.from_option_file(prefix)
    cfg.max_patches = max_patches
    for k, v in overrides.items():
        setattr(cfg, k, v)
    engine = PMMVS(cfg, device=device, log=lambda *a: print(*a, file=sys.stderr))
    dev, scene = engine.device, engine.scene
    table = sd.seed_from_patch_file(scene, cfg, _resume_path(prefix, resume))
    engine.close()
    p = engine.prop_params
    n_alive = table.n_alive()
    R = pow2_limit(max(n_alive, 1), table.capacity)
    thr, thr_b = engine.ncc_threshold, engine.ncc_threshold_before
    C = p.chunk

    def noise():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return pr.TorchNoise(gen)

    def measure(fn):
        profiling.COUNTERS.reset()
        out = fn()
        launches = {"k1": cuda_ncc.LAUNCHES["ungrouped"], "k2": cuda_ncc.LAUNCHES["grouped"]}
        return out, dict(ms=stage_ms(fn, reps, dev), **launches)

    def dp_stages(devs):
        """The stages a dp axis partitions, on `devs` (None: unsharded)."""
        kw = dict(dp_devices=devs)
        rows, outs = {}, {}
        grid, rows["build_grid"] = measure(lambda: gridmod.build_grid(
            scene, table, p.level, p.csize, p.cell_capacity, row_limit=R, **kw))
        t = table._replace(alive=table.alive & ~grid.evicted)
        donors, rows["select_donors"] = measure(lambda: pr.select_donors(
            scene, grid, t, p.donor_budget, p.donor_policy, **kw))
        jit = [noise().jitter(a, p.donor_budget) for a in (0, 1)]
        hyp, rows["generate_hypotheses(16k)"] = measure(lambda: pr.generate_hypotheses(
            scene, t, grid, *donors, 0, 1, jit[0], p, **kw))
        both = [hyp, pr.generate_hypotheses(scene, t, grid, *donors, 1, 1, jit[1], p, **kw)]
        coord, normal, images, _, ok = (torch.cat([h[i] for h in both]) for i in range(5))
        out, rows["gauntlet(full)"] = measure(lambda: pr._gauntlet_chunked(
            scene, grid, t, coord, normal, images, ok, noise(), p, thr, thr_b, True,
            cfg.quad_threshold, devs))
        _, rows["insert_patches"] = measure(lambda: pr.insert_patches(t, out, **kw))
        outs["round"], rows["propagate_round(full)"] = measure(lambda: pr.propagate_round(
            scene, table, noise(), p, 1, thr, thr_b, use_depth=True,
            quad_threshold=cfg.quad_threshold, row_limit=R, **kw)[0])
        # the filter pass's phases, each on the table its predecessor
        # leaves, against the first rebuild's grid
        fk = dict(row_limit=R, **kw)
        (ft, fg), rows["filter:rebuild"] = measure(lambda: fl.rebuild(
            scene, table, p.level, p.csize, cfg.filter_cell_capacity,
            cfg.neighbor_threshold, additive=False, **fk))
        (ft, _), rows["filter:outside"] = measure(lambda: fl.filter_outside(
            scene, fg, ft, p.level, p.csize, thr, cfg.neighbor_threshold1, **fk))
        (ft, _), rows["filter:exact"] = measure(lambda: fl.filter_exact(
            scene, fg, ft, p.level, p.csize, p.wsize, p.min_image_num,
            cfg.neighbor_threshold1, cfg.angle_threshold1, **fk))
        (ft, _), rows["filter:neighbor"] = measure(lambda: fl.filter_neighbor_rows(
            scene, fg, ft, 0, n_alive, p.level, p.csize, p.tau, cfg.quad_threshold,
            cfg.neighbor_threshold, max_neighbors=cfg.neighbor_capacity,
            cand_cap=cfg.neighbor_cand_cap, **kw))
        _, rows["filter:groups"] = measure(lambda: fl.filter_small_groups(
            scene, fg, ft, p.level, p.csize, cfg.neighbor_threshold2,
            iters=cfg.small_group_iters, **fk))
        return rows, outs, (grid, t, hyp)

    devs_k = [dev] * dp
    table1, outs1, (grid, t, hyp) = dp_stages(None)
    tablek, outsk, _ = dp_stages(devs_k)

    # the gauntlet's phases on its first chunk (dp does not split a chunk)
    cc, cn, ci, cok = (x[:C] for x in (hyp[0], hyp[1], hyp[2], hyp[4]))
    deltas = noise().refine(0, 1, p.refine_rounds, cc.shape[0], p.refine_cands)
    pieces = {}
    vkw = dict(level=p.level, wsize=p.wsize, tau=p.tau, min_image_num=p.min_image_num,
               angle_threshold1=p.angle_threshold1)
    pre, pieces["pre_process(4k)"] = measure(lambda: vw.pre_process(
        scene, cc, cn, ci, ncc_threshold_before=thr_b, angle_threshold0=p.angle_threshold0,
        max_angle_threshold=p.max_angle_threshold, **vkw))
    res, pieces["refine(4k)"] = measure(lambda: rf.refine_batch(
        scene, cc, cn, pre.images, pre.dscale, deltas, ascale=p.ascale,
        rounds=p.refine_rounds, n_cands=p.refine_cands, shrink=p.refine_shrink,
        init_depth_radius=p.refine_depth_radius, init_angle_radius=p.refine_angle_radius,
        group_dma=p.group_dma, luma=p.luma_refine, rgb_tail=p.rgb_tail,
        n_illums=p.n_illums, **vkw))
    _, pieces["post_process(4k)"] = measure(lambda: vw.post_process_core(
        scene, res.coord, res.normal, pre.images, ncc_threshold=thr,
        angle_threshold0=p.angle_threshold0, n_illums=p.n_illums, **vkw))
    _, pieces["vimages(4k)"] = measure(lambda: gridmod.visible_extra_views(
        scene, grid, t, res.coord, res.normal, pre.images, torch.full_like(pre.images, -1),
        torch.ones_like(cok), p.level, p.csize, p.neighbor_threshold, True))
    no_rows = torch.full((cc.shape[0],), -1, dtype=torch.int32, device=dev)
    vimg = torch.full_like(ci, -1)
    _, pieces["check:gain(4k)"] = measure(lambda: fl.gain_batch(
        scene, grid, t, res.coord, res.normal, pre.dscale, res.ncc, pre.images, vimg,
        no_rows, p.level, p.csize, thr, p.neighbor_threshold1))
    (nbrs, _), pieces["check:neighbors(4k)"] = measure(lambda: fl.gather_neighbors_batch(
        scene, grid, t, res.coord, res.normal, pre.dscale, pre.images, no_rows,
        p.level, p.csize, margin=2, scale=4.0, neighbor_threshold=p.neighbor_threshold,
        max_neighbors=p.neighbor_capacity, cand_cap=p.neighbor_cand_cap))
    _, pieces["check:quad(4k)"] = measure(lambda: fl.quad_residuals_batch(
        scene, t, res.coord, res.normal, pre.images, nbrs, p.level, p.tau))
    _, pieces["check:total(4k)"] = measure(lambda: fl.check_batch(
        scene, grid, t, res.coord, res.normal, pre.dscale, res.ncc, pre.images, vimg,
        level=p.level, csize=p.csize, tau=p.tau, ncc_threshold=thr,
        quad_threshold=cfg.quad_threshold, neighbor_threshold=p.neighbor_threshold,
        neighbor_threshold1=p.neighbor_threshold1, max_neighbors=p.neighbor_capacity,
        cand_cap=p.neighbor_cand_cap))
    _, pieces["gauntlet(4k,total)"] = measure(lambda: pr.run_gauntlet(
        scene, grid, t, cc, cn, ci, cok, deltas, p, thr, thr_b, True, cfg.quad_threshold))

    equal = all(torch.equal(a.view(torch.int32) if a.dtype.is_floating_point else a,
                            b.view(torch.int32) if b.dtype.is_floating_point else b)
                for a, b in zip(outs1["round"], outsk["round"]))
    if not equal:
        raise AssertionError(f"propagate_round(full) at dp {dp} differs from dp 1")
    record = {
        "alive": n_alive, "max_patches": max_patches, "row_limit": R,
        "donor_budget": p.donor_budget, "chunk": C, "dp": dp,
        "depth2_check": p.depth2_check, "reps": reps,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_line() if dev.type == "cuda" else None,
        "timings_ms": {**{k: v["ms"] for k, v in table1.items()},
                       **{k: v["ms"] for k, v in pieces.items()}},
        "stages": {"dp1": {**table1, **pieces}, f"dp{dp}": tablek},
        "round_equal_across_dp": equal,
    }
    return record, outs1["round"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvskit_tpu_torch.tools.bench_prop_parts")
    ap.add_argument("--prefix", required=True, help="dataset directory with an option file")
    ap.add_argument("--resume", default="final_patches",
                    help="a .patch file, or its name under <prefix>/ply/")
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--donor-budget", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None, help="gauntlet chunk")
    ap.add_argument("--refine-cands", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="PROP_PARTS_torch.json")
    args = ap.parse_args(argv)
    over = {k: v for k, v in (("donor_budget", args.donor_budget),
                              ("gauntlet_chunk", args.chunk),
                              ("refine_cands", args.refine_cands)) if v is not None}
    record, _ = run(args.prefix, args.resume, args.max_patches, args.reps, args.dp,
                    args.device, **over)
    print(json.dumps(record, indent=1))
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
