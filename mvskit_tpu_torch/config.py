# Copy of mvskit_tpu/config.py (whole); the port imports nothing of mvskit_tpu.
"""Configuration system for the TPU-native PM-MVS engine.

Re-expresses the reference's two config tiers as one explicit dataclass:
  * the ``option`` key/value file parsed by ``Option`` (reference:
    pmmvps/option.cpp:35-122), and
  * the hardcoded driver/stage thresholds living in ``PmMvps::init``
    (reference: pmmvps/pmmvps.cpp:54-67), ``Propagate::init``
    (propagate.cpp:24-25) and ``Optim`` constants (optim.cpp:487-506).

Also adds TPU-specific knobs (batch sizes, refinement budget, slot
capacities, mesh axes) that have no counterpart in the single-threaded
reference.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional


@dataclasses.dataclass
class MVSConfig:
    # ---- dataset ----
    prefix: str = ""
    images: List[int] = dataclasses.field(default_factory=list)  # image ids
    nillums: int = 1

    # ---- option-file keys (reference option.cpp:19-33 defaults) ----
    level: int = 1
    csize: int = 2
    wsize: int = 7
    ncc_threshold: float = 0.7
    min_image_num: int = 3
    max_angle_deg: float = 10.0            # "maxAngle" key, stored in degrees
    quad_threshold: float = 2.5
    use_vis_data: int = 0
    # parsed-but-unused reference keys kept for file compatibility
    cpu: int = 4
    set_edge: int = 0
    use_bound: int = 0
    sequence: int = -1

    # ---- driver thresholds (reference pmmvps.cpp:54-67) ----
    angle_threshold0_deg: float = 60.0
    angle_threshold1_deg: float = 60.0
    count_threshold1: int = 4
    neighbor_threshold: float = 0.5
    neighbor_threshold1: float = 1.0
    neighbor_threshold2: float = 1.0
    ncc_threshold_before_delta: float = 0.3  # nccThresholdBefore = ncc - delta
    n_iterations: int = 3                    # outer schedule (pmmvps.cpp:90)
    anneal_ncc_step: float = 0.05            # updateThreshold (pmmvps.cpp:70-74)

    # ---- refinement (reference optim.cpp:480-547) ----
    ascale: float = math.pi / 48.0           # angle encoding scale
    # (the +-23.99999 encoded-angle bound of optim.cpp:496-497 is the
    # fixed ANGLE_BOUND constant in pipeline/refine.py, not a knob)
    # 6 rounds x 32 candidates (192 evals — the start pose scores as
    # round 0's pinned candidate 0, the budget analog of the
    # reference's maxeval). A round's candidates share one DMA'd tile
    # (refine_group_dma), so doubling the group halves the kernel's
    # DMA descriptors per eval: on-chip bench 24x8 -> 12x16 -> 6x32
    # measured 385 -> 1118 -> 1247 Msamples/s. Search quality at the
    # same budget is parity (perturbed-start recovery, plane frac<.05
    # 0.92 vs 0.95, sphere err_med 0.039 vs 0.050 — better; PERF.md).
    # The shrink is squared per halving so the final trust radius is
    # unchanged (0.4096^6 = 0.64^12 = 0.8^24).
    refine_rounds: int = 6                   # TPU random-search: rounds
    refine_cands: int = 32                   # candidates per round
    refine_shrink: float = 0.4096            # radius decay per round
    refine_init_depth_radius: float = 4.0    # in encoded (dscale) units
    refine_init_angle_radius: float = 8.0    # in encoded (ascale) units
    refine_group_dma: bool = True            # share one Pallas DMA tile
                                             # across a round's n_cands
    refine_grad_steps: int = 0               # differentiable polish steps
    refine_grad_lr: float = 0.5
    refine_rgb_tail: int = 2                 # with luma_refine: the LAST
                                             # n rounds search in RGB. The
                                             # coarse rounds locate the NCC
                                             # basin (luma suffices); the
                                             # final rounds set sub-pixel
                                             # accuracy, where chroma
                                             # contrast measurably matters
                                             # (REFINE_AB_CHIP.json: full-
                                             # luma err_med 0.024 vs full-
                                             # RGB 0.011; hybrid recovers
                                             # RGB-level accuracy at near-
                                             # luma speed)
    luma_refine: bool = False                # luminance-NCC inside the
                                             # candidate search: a 1.7x-faster
                                             # opt-in, DEMOTED from default in
                                             # round 5. On-chip A/B at
                                             # production scale
                                             # (REFINE_AB_CHIP.json) measured
                                             # err_med 0.024 (luma) vs 0.011
                                             # (RGB) on the random-RGB-texture
                                             # scene — luminance discards the
                                             # decorrelated chroma contrast, so
                                             # the argmin picks worse poses and
                                             # e2e accuracy degrades (acc_mean
                                             # 0.0158 vs 0.0116). The reference
                                             # optimizes RGB NCC
                                             # (optim.cpp:401-468), so RGB
                                             # search is the parity default;
                                             # luma remains sound for real
                                             # photographs whose channels
                                             # correlate (the usual GPU-MVS
                                             # practice) — enable per dataset
                                             # after an A/B, ideally with
                                             # refine_rgb_tail polish.

    # ---- propagation (reference propagate.cpp:24-25) ----
    max_num_of_propag: int = 2

    # ---- multi-illumination ----
    # When the dataset declares illum > 1, score NCC (gauntlet + refine
    # objective) as the average over illuminations — the live wiring of
    # the reference's dormant multi-illum getTex (optim.cpp:846-893).
    # Off = reference live-path behavior (everything samples illum 0).
    use_illums: bool = True

    # ---- TPU-native knobs ----
    use_pallas: bool = True                  # the window sampler's CUDA
                                             # kernel on a card; False runs
                                             # its plain version there
                                             # (Scene.use_kernel)
    # device mesh shape (dp, view, tile) — the three greenfield
    # parallel axes of SURVEY.md §2 (the reference is single-threaded,
    # propagate.cpp:78-121 sweeps one cell at a time). dp shards the
    # patch-table rows (GSPMD), view shards the pyramid planes with a
    # psum cross-view NCC combine (parallel/shard.py), tile shards the
    # cell-grid rows with a ppermute propagation halo
    # (parallel/tiles.py). The product must divide the visible device
    # count; all 1 = single-device execution (identical results:
    # tests/test_driver_mesh.py).
    mesh_dp: int = 1
    mesh_view: int = 1
    mesh_tile: int = 1
    strategy: str = "pm_image"               # "pm_image" | "pmvs"
    prop_rounds: int = 8                     # checkerboard rounds per outer iter
    donor_budget: int = 16384                # max donors per propagation phase
    donor_policy: str = "cell_first"         # 'cell_first' (per-cell
                                             # coverage) or 'ncc' (global)
    gauntlet_chunk: int = 4096               # hypothesis batch per gauntlet step
    cell_capacity: Optional[int] = None      # slots per cell; default 2*csize^2
    filter_cell_capacity: int = 16           # larger cap used by filter passes
    max_patches: int = 1 << 18               # flat patch-table capacity
    neighbor_capacity: int = 48              # max neighbors gathered per patch
                                             # (findNeighbors cap; DIVERGENCES A7)
    neighbor_cand_cap: int = 384             # distinct candidates tested per
                                             # patch in findNeighbors (the
                                             # 25-cell x 2-grid neighborhood
                                             # holds ~100 distinct patches at
                                             # production occupancy; the test
                                             # cost is linear in this cap)
    small_group_iters: int = 32              # label-propagation iterations
                                             # (filterSmallGroups pointer-jumping)

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    @property
    def nimages(self) -> int:
        return len(self.images)

    @property
    def tau(self) -> int:
        # reference pmmvps.cpp:32
        return min(self.min_image_num * 2, self.nimages)

    @property
    def max_level(self) -> int:
        # reference pmmvps.cpp:36 — +3 levels for multi-resolution getTex
        return self.level + 3

    @property
    def ncc_threshold_before(self) -> float:
        return self.ncc_threshold - self.ncc_threshold_before_delta

    @property
    def max_angle_threshold(self) -> float:
        return self.max_angle_deg * math.pi / 180.0

    @property
    def angle_threshold0(self) -> float:
        return self.angle_threshold0_deg * math.pi / 180.0

    @property
    def angle_threshold1(self) -> float:
        return self.angle_threshold1_deg * math.pi / 180.0

    @property
    def max_patches_per_cell(self) -> int:
        # reference propagate.cpp:25
        if self.cell_capacity is not None:
            return self.cell_capacity
        return self.max_num_of_propag * self.csize * self.csize

    @property
    def min_image_num_threshold(self) -> int:
        return self.min_image_num

    def visdata2(self) -> List[List[int]]:
        """All-pairs visibility fallback (reference option.cpp:151-166)."""
        n = self.nimages
        return [[x for x in range(n) if x != y] for y in range(n)]

    # ------------------------------------------------------------------
    # option-file parsing (reference option.cpp:35-122)
    # ------------------------------------------------------------------
    @classmethod
    def from_option_file(cls, prefix: str, option: str = "option") -> "MVSConfig":
        cfg = cls(prefix=prefix)
        path = os.path.join(prefix, option)
        with open(path, "r") as f:
            tokens: List[str] = []
            for line in f:
                stripped = line.strip()
                if not stripped:
                    continue
                # '#' begins a comment that runs to end of line
                if "#" in stripped:
                    stripped = stripped.split("#", 1)[0]
                tokens.extend(stripped.split())

        nimages_declared = None
        flag = -10
        i = 0

        def take() -> str:
            nonlocal i
            tok = tokens[i]
            i += 1
            return tok

        while i < len(tokens):
            name = take()
            if name == "image":
                nimages_declared = int(take())
            elif name == "illum":
                cfg.nillums = int(take())
            elif name == "level":
                cfg.level = int(take())
            elif name == "csize":
                cfg.csize = int(take())
            elif name == "threshold":
                cfg.ncc_threshold = float(take())
            elif name == "wsize":
                cfg.wsize = int(take())
            elif name == "minImageNum":
                cfg.min_image_num = int(take())
            elif name == "CPU":
                cfg.cpu = int(take())
            elif name == "setEdge":
                cfg.set_edge = int(take())
            elif name == "useBound":
                cfg.use_bound = int(take())
            elif name == "useVisData":
                cfg.use_vis_data = int(take())
            elif name == "sequence":
                cfg.sequence = int(take())
            elif name == "maxAngle":
                cfg.max_angle_deg = float(take())
            elif name == "quad":
                cfg.quad_threshold = float(take())
            elif name == "images":
                flag = int(take())
                if flag == -1:
                    first, last = int(take()), int(take())
                    cfg.images = list(range(first, last))
                elif flag > 0:
                    cfg.images = [int(take()) for _ in range(flag)]
                else:
                    raise ValueError(f"flag is not valid: {flag}")
            else:
                raise ValueError(f"Unrecognizable option: {name}")

        if flag == -10:
            raise ValueError("images not specified in option file")
        if nimages_declared is not None and nimages_declared != len(cfg.images):
            # the reference trusts the images list; mirror that but warn
            pass
        return cfg

    def summary(self) -> str:
        return (
            f"# of images: {self.nimages}\n"
            f"level: {self.level}  csize: {self.csize}\n"
            f"nccThreshold: {self.ncc_threshold}  wsize: {self.wsize}\n"
            f"minImageNum: {self.min_image_num}  tau: {self.tau}\n"
            f"maxAngle(deg): {self.max_angle_deg}  quad: {self.quad_threshold}"
        )
