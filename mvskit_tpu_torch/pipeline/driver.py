"""Pipeline driver (port of ``mvskit_tpu/pipeline/driver.py``).

Owns the scene, the patch table, the threshold schedule and the
iteration loop (reference pmmvps/pmmvps.cpp:18-114): seed ->
[propagate -> snapshot -> filter -> anneal -> snapshot] x n_iterations.

Each stage runs eagerly on the driver's device. ``self.report`` records
per-stage seconds (host clock around work that ends in a device
synchronize), hypothesis counts, alive counts and filter kills.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import MVSConfig
from ..core import patches as pt
from ..core.grid import pow2_limit
from ..device import get_device
from ..image.scene import Scene, load_scene
from ..io import patch_io, ply
from ..ops import sampling
from ..parallel import shard as sh
from ..parallel import tiles
from ..utils import profiling
from . import expand as ex
from . import filters as fl
from . import propagate as pr
from . import seed as seedmod


def check_supported(cfg: MVSConfig) -> None:
    """Raise ValueError for a strategy other than pm_image and pmvs, for
    a negative refine_rgb_tail with luma_refine (the JAX package's scan
    breaks on it), and for the gradient polish after a luma search that
    ends in RGB rounds (JAX refine.py:299 would accept a luma cost
    against an RGB incumbent; pipeline/refine.refine_batch)."""
    if cfg.strategy not in ("pm_image", "pmvs"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.luma_refine and cfg.refine_rgb_tail < 0:
        raise ValueError(
            f"refine_rgb_tail must be >= 0 with luma_refine, got "
            f"{cfg.refine_rgb_tail}"
        )
    if (cfg.refine_grad_steps > 0 and cfg.luma_refine
            and min(cfg.refine_rgb_tail, cfg.refine_rounds) > 0):
        raise ValueError(
            "refine_grad_steps > 0 with luma_refine and refine_rgb_tail > 0 would accept "
            "a luma cost against the RGB search's incumbent (JAX refine.py:299); set "
            "refine_rgb_tail 0")
    if min(cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile) < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({cfg.mesh_dp}, "
                         f"{cfg.mesh_view}, {cfg.mesh_tile})")


def _encode_and_write(path_prefix: str, data: Dict[str, np.ndarray],
                      rgb: Optional[np.ndarray], image_ids: np.ndarray,
                      export_ply: bool, export_patch: bool,
                      binary_ply: bool) -> None:
    """Host-only snapshot encode + disk write. The patch file's padded
    view lists are translated from indices to dataset ids in one array
    operation (-1 stays -1) and encoded as they are; the encoder that
    wrote is the ``writer`` attribute of the innermost open span."""
    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)), exist_ok=True)
    if export_ply:
        ply.write_ply(path_prefix + ".ply", data["coord"][:, :3],
                      normal=data["normal"][:, :3], rgb=rgb, binary=binary_ply)
    if export_patch:
        def translate(padded):
            return np.where(padded >= 0, image_ids[np.clip(padded, 0, None)], -1)

        writer = patch_io.write_patch_arrays(
            path_prefix + ".patch", data["coord"], data["normal"],
            data["ncc"], data["dscale"], data["ascale"],
            translate(data["images"]), translate(data["vimages"]),
        )
        profiling.note(writer=writer)


class PMMVS:
    """The PM-MVS pipeline on one device, or on a mesh of devices.

    device: "cuda" or "cpu", explicit (``device.get_device`` raises when
    CUDA is asked for and absent). noise: the run's source of random
    numbers, an object whose ``round()`` (a pm_image round) and
    ``expand_round()`` (a pmvs round) return a ``propagate.RoundNoise``;
    by default a ``TorchNoise`` on a ``torch.Generator`` seeded with 0
    (the JAX driver's PRNGKey(0)).

    The mesh (cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile; JAX driver.py:
    94-158) carries the three parallel axes of ``parallel/``:
      dp    every stage of a round and of the filter pass deals its
            rows to the dp devices in contiguous blocks and merges them
            exactly (``shard.deal_rows``): the grid build, vimages,
            donor selection, hypothesis scoring, the gauntlet's chunks,
            insertion and the four filter phases. On the home device
            stay ``compact_table`` (one whole-table permutation), the
            small-group filter's label iterations and the sort of the
            accepted hypotheses (at most 2 x donor_budget keys), and for
            pmvs the sector search and the effort counters;
      view  the pyramid planes are sharded and every NCC window fetch
            runs per shard (``shard.enable_view_sharding``);
      tile  pm_image rounds run ``tiles.tiled_propagate_round`` (the
            pmvs strategy ignores it, as the JAX driver does).
    Its devices: `mesh_devices` (a list of the mesh's size; repeats put
    several shards on one device), else distinct CUDA devices on cuda
    (ValueError where there are fewer) or copies of the CPU. Every
    sharded result equals the unsharded one bit for bit. `view_mesh`
    view-shards over a mesh of its own (the JAX driver's legacy
    argument); it may not come with cfg.mesh_view > 1, which would shard
    the views twice (JAX driver.py:123-133)."""

    def __init__(self, cfg: MVSConfig, scene: Optional[Scene] = None,
                 log=print, view_mesh=None, *, device="cuda", noise=None,
                 mesh_devices=None):
        check_supported(cfg)
        self.cfg = cfg
        self.log = log
        self.device = get_device(str(device)) if scene is None else scene.device
        self.scene = scene if scene is not None else load_scene(
            cfg.prefix, cfg.images, cfg.nillums, cfg.max_level,
            use_vis_data=bool(cfg.use_vis_data), device=self.device,
        )
        if self.scene.use_kernel != cfg.use_pallas:
            # the sampler's kernel, or its plain version with
            # use_pallas=False (JAX driver.py:81)
            self.scene = dataclasses.replace(self.scene, use_kernel=cfg.use_pallas)
        self.mesh = None
        shape = (cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile)
        if mesh_devices is not None or cfg.mesh_dp * cfg.mesh_view * cfg.mesh_tile > 1:
            self.mesh = sh.make_mesh(shape, sh.MESH_AXES, device=self.device,
                                     devices=mesh_devices)
            if cfg.mesh_view > 1:
                self.scene = sh.enable_view_sharding(self.scene, self.mesh, "view")
        if view_mesh is not None:
            if cfg.mesh_view > 1:
                raise ValueError("view_mesh= with cfg.mesh_view > 1 would shard the "
                                 "views twice")
            self.scene = sh.enable_view_sharding(self.scene, view_mesh)
        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            noise = pr.TorchNoise(gen)
        self.noise = noise
        self.table: Optional[pt.PatchTable] = None
        # mutable threshold state (annealed; reference pmmvps.cpp:70-74)
        self.ncc_threshold = cfg.ncc_threshold
        self.ncc_threshold_before = cfg.ncc_threshold_before
        self.count_threshold1 = cfg.count_threshold1
        self.depth = 0
        self._row_bound: Optional[int] = None
        self.report: Dict[str, List] = {"stages": [], "alive_per_iter": [],
                                        "filters": []}
        self._snap_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._snap_futures: List[concurrent.futures.Future] = []
        # the gauntlet's CUDA graphs, captured and replayed by the rounds
        # (propagate._gauntlet_chunked), freed by close()
        self._graphs = (pr._GauntletGraphs(self.device) if self.device.type == "cuda"
                        else None)

    # ------------------------------------------------------------------
    @property
    def prop_params(self) -> pr.PropagateParams:
        cfg = self.cfg
        return pr.PropagateParams(
            level=cfg.level, csize=cfg.csize, wsize=cfg.wsize, tau=cfg.tau,
            min_image_num=cfg.min_image_num,
            cell_capacity=cfg.max_patches_per_cell,
            angle_threshold0=cfg.angle_threshold0,
            angle_threshold1=cfg.angle_threshold1,
            max_angle_threshold=cfg.max_angle_threshold,
            ascale=cfg.ascale,
            refine_rounds=cfg.refine_rounds,
            refine_cands=cfg.refine_cands,
            refine_shrink=cfg.refine_shrink,
            refine_depth_radius=cfg.refine_init_depth_radius,
            refine_angle_radius=cfg.refine_init_angle_radius,
            neighbor_threshold=cfg.neighbor_threshold,
            donor_budget=cfg.donor_budget,
            chunk=cfg.gauntlet_chunk,
            neighbor_threshold1=cfg.neighbor_threshold1,
            depth2_check=self.depth >= 2,
            grad_steps=cfg.refine_grad_steps,
            grad_lr=cfg.refine_grad_lr,
            neighbor_capacity=cfg.neighbor_capacity,
            neighbor_cand_cap=cfg.neighbor_cand_cap,
            group_dma=cfg.refine_group_dma,
            donor_policy=cfg.donor_policy,
            luma_refine=cfg.luma_refine,
            rgb_tail=cfg.refine_rgb_tail,
            n_illums=self.scene.n_illums if cfg.use_illums else 1,
        )

    @property
    def _dp_devices(self):
        """The dp axis's devices, or None without one."""
        if self.mesh is None or self.cfg.mesh_dp <= 1:
            return None
        return self.mesh.axis_devices("dp")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, name: str, fn, **extra):
        """Run one stage, timed on the host clock up to a device sync,
        inside the recorder's span of the stage (`name` without its
        ``[iteration]``, which becomes the span's ``iteration``)."""
        base, _, it = name.partition("[")
        attrs = {"iteration": int(it[:-1])} if it else {}
        with profiling.span(base, **attrs):
            self._sync()
            t0 = time.time()
            out = fn()
            self._sync()
        rec = {"stage": name, "seconds": time.time() - t0, **extra}
        self.report["stages"].append(rec)
        return out, rec

    # ------------------------------------------------------------------
    def seed(self, resume_iter: int = 0) -> None:
        """DepthNormInit::createPatches + depth counter bump
        (pmmvps.cpp:84-85)."""
        self.table, _ = self._stage(
            "seed",
            lambda: seedmod.seed(self.scene, self.cfg, self.cfg.prefix, resume_iter),
        )
        self.depth = 1
        n = self.table.n_alive()
        # seeds fill a prefix (from_numpy), so the live-row bound is n
        self._row_bound = n
        self.log(f"seeded {n} patches")

    def propagate(self, iteration: int) -> pr.RoundStats:
        """One outer expansion phase: cfg.prop_rounds rounds of the
        configured strategy, "pm_image" checkerboard propagation (sweep
        direction from the iteration parity, propagate.cpp:80-85) or
        "pmvs" scene-space expansion (propagate.cpp:384-691), whose
        effort counters reset every phase (clearCounts, propagate.cpp:36).
        Each round takes its random numbers from ``self.noise.round()``,
        or ``self.noise.expand_round()`` for pmvs."""
        direction = 1 if iteration % 2 == 0 else -1
        N = self.table.capacity
        p = self.prop_params
        pmvs = self.cfg.strategy == "pmvs"
        if pmvs:
            state = ex.init_state(self.scene, self.cfg.level, self.cfg.csize)
            hypotheses = max(self.cfg.donor_budget // ex.N_SECTORS, 1) * ex.N_SECTORS
        else:
            hypotheses = 2 * self.cfg.donor_budget
        total = pr.RoundStats(0, 0, 0, 0)
        for _ in range(self.cfg.prop_rounds):
            # live-row bound: grows at most by the accepted hypotheses of
            # a round (insertions fill the lowest dead rows first)
            rl = pow2_limit(max(self._row_bound or N, 1), N)
            common = dict(ncc_threshold=self.ncc_threshold,
                          ncc_threshold_before=self.ncc_threshold_before,
                          use_depth=self.depth > 0,
                          quad_threshold=self.cfg.quad_threshold, row_limit=rl,
                          dp_devices=self._dp_devices, graphs=self._graphs)
            with profiling.span("round"):
                if pmvs:
                    self.table, state, stats = ex.expand_round(
                        self.scene, self.table, state, self.noise.expand_round(), p,
                        count_threshold=self.count_threshold1, depth=self.depth,
                        **common,
                    )
                elif self.cfg.mesh_tile > 1:
                    self.table, stats = tiles.tiled_propagate_round(
                        self.mesh, self.scene, self.table, self.noise.round(), p,
                        direction, **common,
                    )
                else:
                    self.table, stats = pr.propagate_round(
                        self.scene, self.table, self.noise.round(), p, direction,
                        **common,
                    )
                profiling.note(hypotheses=stats.total, passed=stats.passed)
            if self._row_bound is not None:
                self._row_bound = min(N, self._row_bound + hypotheses)
            total = pr.RoundStats(*(a + b for a, b in zip(total, stats)))
        self.log(
            f"iter {iteration}: total {total.total} pass {total.passed} "
            f"fail0 {total.fail0} fail1 {total.fail1} "
            f"alive {self.table.n_alive()}"
        )
        return total

    def filter(self) -> fl.FilterStats:
        """Filter::run (filter.cpp:25-49) over the compacted table: every
        phase scans only the live prefix. The neighbor filter sees the
        table as it was at the start of its pass (the reference removes
        at the end of filterNeighbor)."""
        cfg = self.cfg
        t = pt.compact_table(self.table)
        N = t.capacity
        with profiling.sync("filter.live_rows"):
            hwm = int(t.alive.sum()) - 1
        self._row_bound = hwm + 1
        R = pow2_limit(max(hwm + 1, 1), N)
        t, stats = fl.run_filters(
            self.scene, t, level=cfg.level, csize=cfg.csize, wsize=cfg.wsize,
            tau=cfg.tau, min_image_num=cfg.min_image_num,
            cell_capacity=cfg.filter_cell_capacity,
            ncc_threshold=self.ncc_threshold,
            quad_threshold=cfg.quad_threshold,
            neighbor_threshold=cfg.neighbor_threshold,
            neighbor_threshold1=cfg.neighbor_threshold1,
            neighbor_threshold2=cfg.neighbor_threshold2,
            angle_threshold1=cfg.angle_threshold1,
            neighbor_cand_cap=cfg.neighbor_cand_cap,
            neighbor_capacity=cfg.neighbor_capacity,
            small_group_iters=cfg.small_group_iters,
            row_limit=R, neighbor_rows=min(hwm + 1, N),
            dp_devices=self._dp_devices,
        )
        self.table = t
        self.log(
            f"filters removed: outside {stats.outside} exact {stats.exact} "
            f"neighbor {stats.neighbor} groups {stats.groups}; "
            f"alive {self.table.n_alive()}"
        )
        return stats

    def update_threshold(self) -> None:
        """Threshold annealing (pmmvps.cpp:70-74)."""
        self.ncc_threshold -= self.cfg.anneal_ncc_step
        self.ncc_threshold_before -= self.cfg.anneal_ncc_step
        self.count_threshold1 = 2

    def run(self, write_snapshots: bool = True) -> None:
        """PmMvps::run (pmmvps.cpp:76-114). Snapshot encoding and disk
        writes overlap the following stage in a writer thread."""
        t0 = time.time()
        if self.table is None:
            self.seed()
        for it in range(self.cfg.n_iterations):
            self.log(f"--- iteration {it} ---")
            st, rec = self._stage(f"propagate[{it}]", lambda: self.propagate(it))
            rec.update(hypotheses=st.total, accepted=st.passed,
                       hypotheses_per_s=st.total / max(rec["seconds"], 1e-9))
            if write_snapshots:
                self.write_patches(os.path.join(
                    self.cfg.prefix, "ply", f"refined_patches_before_refine_{it}",
                ), wait=False)
            fs, rec = self._stage(f"filter[{it}]", self.filter)
            rec.update(removed=fs._asdict())
            self.report["filters"].append(fs._asdict())
            self.update_threshold()
            self.depth += 1
            self.report["alive_per_iter"].append(self.table.n_alive())
            if write_snapshots:
                self.write_patches(os.path.join(
                    self.cfg.prefix, "ply", f"refined_patches_{it}",
                ), wait=False)
        self.join_snapshots()
        self.log(f"---- Total: {time.time() - t0:.1f} secs ----")

    def _mean_colors(self, coord, images, chunk: int = 32768):
        """Mean color over each patch's views (patch_manager.cpp:566-587,
        mode 0), in row chunks. Returns [N, 3] uint8."""
        out = []
        for s in range(0, coord.shape[0], chunk):
            c, im = coord[s:s + chunk], images[s:s + chunk]
            idx = im.clamp(min=0).long()
            cols = sampling.color_at_coord(self.scene, idx, c.unsqueeze(1),
                                           self.cfg.level)
            valid = (im >= 0).unsqueeze(-1)
            denom = torch.clamp(valid.sum(1), min=1)
            mean = torch.where(valid, cols, torch.zeros_like(cols)).sum(1) / denom
            out.append(torch.floor(mean + 0.5).clamp(0, 255).to(torch.uint8))
        if not out:
            return torch.zeros((0, 3), dtype=torch.uint8, device=coord.device)
        return torch.cat(out)

    # ------------------------------------------------------------------
    def collect(self, table: Optional[pt.PatchTable] = None) -> Dict[str, np.ndarray]:
        """Alive patches on the host."""
        t = self.table if table is None else table
        with profiling.sync("collect.rows"):
            idx = torch.nonzero(t.alive).flatten()
        out = {}
        for k in ("coord", "normal", "ncc", "dscale", "ascale", "images", "vimages"):
            with profiling.sync("collect.copy"):
                out[k] = getattr(t, k)[idx].cpu().numpy()
        return out

    def patch_colors(self, coord: np.ndarray, images: np.ndarray) -> np.ndarray:
        """Mean color over a patch's views (patch_manager.cpp:566-587)."""
        with profiling.sync("colors.coord"):
            c = torch.as_tensor(np.asarray(coord, np.float32), device=self.device)
        with profiling.sync("colors.images"):
            im = torch.as_tensor(np.asarray(images, np.int32), device=self.device)
        rgb = self._mean_colors(c, im)
        with profiling.sync("colors.copy"):
            return rgb.cpu().numpy()

    def join_snapshots(self) -> None:
        """Barrier for the snapshot writer thread; re-raises any
        snapshot I/O error."""
        futs, self._snap_futures = self._snap_futures, []
        with profiling.span("join"):
            for f in futs:
                f.result()

    def write_patches(self, path_prefix: str, export_ply: bool = True,
                      export_patch: bool = False, binary_ply: bool = False,
                      wait: bool = True) -> None:
        """PatchManager::writePatches (patch_manager.cpp:499-540): the
        device work happens here; with wait=False the encoding and disk
        write run in the writer thread (span ``snapshot`` there, ``encode``
        here)."""
        with profiling.span("write"):
            with profiling.span("collect"):
                data = self.collect()
            rgb = None
            if export_ply:
                with profiling.span("colors"):
                    rgb = self.patch_colors(data["coord"], data["images"])
            image_ids = np.asarray(self.cfg.images, dtype=np.int32)
            job = functools.partial(_encode_and_write, path_prefix, data, rgb,
                                    image_ids, export_ply, export_patch, binary_ply)
            if wait:
                with profiling.span("encode"):
                    job()
            else:
                self._snap_futures.append(
                    self._snap_pool.submit(profiling.carry(job, "snapshot")))

    def close(self) -> None:
        """Finish pending snapshots, stop the writer thread and free the
        gauntlet's CUDA graphs."""
        self.join_snapshots()
        self._snap_pool.shutdown(wait=True)
        if self._graphs is not None:
            self._graphs.release()
