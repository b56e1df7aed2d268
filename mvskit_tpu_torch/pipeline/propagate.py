"""Checkerboard PatchMatch propagation (port of
``mvskit_tpu/pipeline/propagate.py``).

Each round builds the cell grid, takes the top donors of every cell,
generates depth-transferred hypotheses into the +-x and +-y neighbor
cells with an in-cell jitter, runs them through the preProcess ->
refine -> postProcess gauntlet in fixed-size chunks, and inserts the
survivors into dead table rows (reference pmmvps/propagate.cpp:72-237).

Randomness is injected through a ``RoundNoise``: the in-cell jitter per
propagation axis and the refinement deltas per gauntlet chunk. The
chunking (``p.chunk`` rows, zero-padded) is the JAX package's, so a
noise provider that replays its key tree feeds both packages the same
numbers. Only chunks and rows with live hypotheses are computed: every
hypothesis is independent of the others in its batch, so skipping dead
rows does not change any live result.

On a CUDA device every chunk of live hypotheses runs at the fixed
shape of ``p.chunk`` rows, its ragged last chunk padded with copies of
its first row that enter the gauntlet as dead, and an engine's
chunks replay CUDA graphs captured on their first chunk
(``_GauntletGraphs``; ``graph_rule`` says where they run op by op
instead). The CPU computes the live rows alone, unpadded.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Protocol, Tuple

import torch

from ..core import grid as gridmod
from ..core.patches import PatchTable, count_valid
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops import ncc as nccops
from ..parallel import shard as sh
from ..utils import profiling
from . import refine as rf
from . import views as vw

NEG = float(-1e30)


class PropagateParams(NamedTuple):
    """Static configuration of one propagation round."""
    level: int
    csize: int
    wsize: int
    tau: int
    min_image_num: int
    cell_capacity: int
    angle_threshold0: float
    angle_threshold1: float
    max_angle_threshold: float
    ascale: float
    refine_rounds: int
    refine_cands: int
    refine_shrink: float
    refine_depth_radius: float
    refine_angle_radius: float
    neighbor_threshold: float
    donor_budget: int
    chunk: int
    neighbor_threshold1: float = 1.0
    depth2_check: bool = False
    # the refinement's gradient polish (refine.refine_batch grad_steps /
    # grad_lr); 0 steps is off
    grad_steps: int = 0
    grad_lr: float = 0.5
    luma_refine: bool = False
    neighbor_capacity: int = 48
    neighbor_cand_cap: int = 1024
    group_dma: bool = True
    donor_policy: str = "cell_first"
    rgb_tail: int = 0
    # multi-illumination scoring: when > 1, the gauntlet's NCC scores and
    # the refinement objective average over the illuminations; view
    # selection stays on illumination 0 (JAX propagate.py:68-73)
    n_illums: int = 1


class RoundStats(NamedTuple):
    total: int    # hypotheses attempted (m_ecount analog)
    fail0: int    # failed preProcess (m_fcount0)
    fail1: int    # failed postProcess (m_fcount1)
    passed: int   # accepted (m_pcount)


class RoundNoise(Protocol):
    """The random numbers of one propagation round."""

    def jitter(self, axis: int, n: int) -> torch.Tensor:
        """[n, 2] uniform in [-0.5, 0.5): in-cell jitter for `axis`."""

    def refine(self, chunk: int, n_chunks: int, rounds: int, rows: int,
               n_cands: int) -> torch.Tensor:
        """[rounds, rows, n_cands, 3] uniform in [-1, 1): refinement
        deltas for gauntlet chunk `chunk` of `n_chunks`."""


class TorchNoise:
    """RoundNoise drawn from one torch.Generator on the run's device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def round(self) -> "TorchNoise":
        return self

    def expand_round(self) -> "TorchNoise":
        return self

    def _uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=torch.float32)
        return u * (hi - lo) + lo

    def jitter(self, axis: int, n: int) -> torch.Tensor:
        return self._uniform((n, 2), -0.5, 0.5)

    def refine(self, chunk, n_chunks, rounds, rows, n_cands) -> torch.Tensor:
        return self._uniform((rounds, rows, n_cands, 3), -1.0, 1.0)


def donor_priority(ncc_vals, slot_rank, ok, policy: str):
    """Donation priority of a grid slot: with 'cell_first' every cell's
    slot-0 patch outranks any cell's slot-1 patch (ncc in [-1, 1], so a
    2.5 rank step keeps ranks apart); 'ncc' is the global NCC order."""
    if policy == "cell_first":
        prio = ncc_vals - 2.5 * slot_rank.to(torch.float32)
    else:
        prio = ncc_vals
    return torch.where(ok, prio, torch.full_like(prio, NEG))


def _donor_candidates(slots, first: int, images0, ncc, alive, S: int, per_img: int,
                      budget: int, policy: str):
    """The first `budget` of the flat slots [first, first + len(slots)) by
    a stable descending sort of their donation priority (ties to the
    lower slot index, lax.top_k's order). A slot donates only when the
    grid's image is the patch's reference view (propagate.cpp:104).
    Returns (priority, flat slot index, pidx, ok) of those slots."""
    pidx = slots.clamp(min=0).long()
    ar = torch.arange(first, first + slots.shape[0], device=slots.device)
    ok = (slots >= 0) & (images0[pidx].long() == ar // per_img) & alive[pidx]
    prio = donor_priority(ncc[pidx], ar % S, ok, policy)
    top = torch.sort(prio, descending=True, stable=True).indices[:budget]
    return prio[top], ar[top], pidx[top], ok[top]


def select_donors(scene: Scene, grid: gridmod.GridState, table: PatchTable,
                  budget: int, policy: str = "cell_first", dp_devices=None):
    """Pick `budget` donor (patch, cell) slots in priority order, ties
    to the lower slot index (lax.top_k's order): a stable descending
    sort and a slice. A slot donates only when the grid's image is the
    patch's reference view (propagate.cpp:104). `dp_devices` deals the
    flat slots in contiguous blocks (``shard.deal_rows``): each block
    keeps its own first `budget` by the same sort and the candidates
    merge by it in block order (``shard.merge_top``), which is exact: a
    slot a block drops has `budget` better ones before it.
    Returns (pidx, img, cy, cx, ok), each [budget]."""
    n, gh, gw, S = grid.slots.shape
    flat = grid.slots.reshape(-1)
    home = flat.device
    args = (table.images[:, 0], table.ncc, table.alive)
    if not dp_devices:
        _, top, pidx, ok = _donor_candidates(flat, 0, *args, S, gh * gw * S, budget, policy)
    else:
        on = sh.replicas(dp_devices, home, args)
        parts = [_donor_candidates(flat[s:e].to(d), s, *on[d][0], S, gh * gw * S, budget,
                                   policy)
                 for _, d, s, e in sh.deal_rows("donors", flat.shape[0], dp_devices)]
        _, top, pidx, ok = sh.merge_top(parts, home, budget)
    cell = top // S
    img = cell // (gh * gw)
    rem = cell % (gh * gw)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return i32(pidx), i32(img), i32(rem // gw), i32(rem % gw), ok


def generate_hypotheses(scene: Scene, table: PatchTable, grid: gridmod.GridState,
                        donor_pidx, donor_img, donor_cy, donor_cx, donor_ok,
                        axis: int, direction: int, jitter, p: PropagateParams,
                        gate_full=None, gate_worst_ncc=None, *,
                        generator: Optional[torch.Generator] = None,
                        dp_devices=None):
    """generatePatch for a donor batch (propagate.cpp:126-237): jittered
    target-cell pixel, depth transfer along the new ray, copied normal,
    view list re-projected (OOB views dropped), initial NCC; a full
    target cell additionally requires beating its worst incumbent.
    `jitter` [budget, 2] is uniform in [-0.5, 0.5); when None it is
    drawn from `generator`. `gate_full` / `gate_worst_ncc` [budget]
    supply that full-cell gate per donor (the tile-sharded round, whose
    target cell's worst incumbent comes by halo exchange,
    parallel/tiles.py; JAX propagate.py:144-192); else it is read from
    `grid`. `dp_devices` deals the donors in contiguous blocks
    (``shard.deal_rows``): each dp device re-projects its donors, scores
    them (K1 there; ``shard.DP_K1`` counts its launches) and gates them
    against a replica of the table and grid, and the blocks join in
    donor order. Returns (coord, normal, images, ncc0, ok)."""
    if jitter is None:
        jitter = TorchNoise(generator).jitter(axis, donor_pidx.shape[0])
    donors = (donor_pidx, donor_img, donor_cy, donor_cx, donor_ok, jitter)
    gates = None if gate_full is None else (gate_full, gate_worst_ncc)
    if not dp_devices:
        return _hypotheses(scene, table, grid, donors, gates, axis, direction, p)
    home = table.coord.device
    on = sh.replicas(dp_devices, home, scene, table, grid)
    parts = []
    for i, d, s, e in sh.deal_rows("hypotheses", donor_pidx.shape[0], dp_devices):
        if s == e:
            continue
        block = lambda xs: tuple(x[s:e].to(d) for x in xs)  # noqa: E731
        before = profiling.COUNTERS.snapshot()
        parts.append(_hypotheses(*on[d], block(donors), gates and block(gates), axis,
                                 direction, p))
        sh.DP_K1[i] += profiling.COUNTERS.since(before)["cuda_ncc.LAUNCHES"]["ungrouped"]
    return tuple(sh.all_gather_rows([pt[j] for pt in parts], home) for j in range(5))


def _hypotheses(scene, table, grid, donors, gates, axis, direction, p: PropagateParams):
    """generate_hypotheses on one device."""
    donor_pidx, donor_img, donor_cy, donor_cx, donor_ok, jitter = donors
    gw, gh = gridmod.grid_dims(scene, p.level, p.csize)
    tx = donor_cx + (direction if axis == 0 else 0)
    ty = donor_cy + (direction if axis == 1 else 0)
    inb = (tx >= 0) & (tx < gw) & (ty >= 0) & (ty < gh)

    jit = jitter * p.csize
    fx = (p.csize * (2 * tx + 1) - 1) / 2.0 + jit[:, 0]
    fy = (p.csize * (2 * ty + 1) - 1) / 2.0 + jit[:, 1]

    dpl = donor_pidx.long()
    dimg = donor_img.long()
    dcoord = table.coord[dpl]
    depth = (scene.cams.oaxis[dimg] * dcoord).sum(-1)
    coord = cam.unproject(scene.cams, dimg, torch.stack([fx, fy], dim=-1),
                          depth, p.level)
    normal = table.normal[dpl]

    images = table.images[dpl]
    _, _, cell_ok = gridmod.patch_cells(scene, coord, images, p.level, p.csize)
    images = vw.compact_list(images, cell_ok)
    has_views = count_valid(images) > 0

    ncc0 = nccops.compute_patch_ncc_n(
        scene, images, coord, normal, p.level, p.wsize, p.tau,
        p.angle_threshold1, n_illums=p.n_illums,
    )
    if gates is None:
        worst = grid.slots[dimg, ty.clamp(0, gh - 1).long(),
                           tx.clamp(0, gw - 1).long(), p.cell_capacity - 1]
        gate_full = worst >= 0
        gate_worst_ncc = table.ncc[worst.clamp(min=0).long()]
    else:
        gate_full, gate_worst_ncc = gates
    beats = ncc0 > gate_worst_ncc
    ok = donor_ok & inb & has_views & (~gate_full | beats)
    return coord, normal, images, ncc0, ok


class GauntletOut(NamedTuple):
    coord: torch.Tensor
    normal: torch.Tensor
    images: torch.Tensor
    vimages: torch.Tensor
    ncc: torch.Tensor
    dscale: torch.Tensor
    ascale: torch.Tensor
    ok: torch.Tensor
    fail0: torch.Tensor
    fail1: torch.Tensor


def run_gauntlet(scene, grid, table, coord, normal, images, ok_in, deltas,
                 p: PropagateParams, ncc_threshold, ncc_threshold_before,
                 use_depth: bool, quad_threshold=2.5) -> GauntletOut:
    """preProcess -> refinePatch -> postProcess for a hypothesis batch
    (propagate.cpp:182-196), plus Optim::check once depth >= 2."""
    with profiling.span("pre"):
        pre = vw.pre_process(
            scene, coord, normal, images,
            level=p.level, wsize=p.wsize, tau=p.tau,
            min_image_num=p.min_image_num,
            ncc_threshold_before=ncc_threshold_before,
            angle_threshold0=p.angle_threshold0,
            angle_threshold1=p.angle_threshold1,
            max_angle_threshold=p.max_angle_threshold,
        )
    fail0 = ok_in & ~pre.ok

    with profiling.span("refine"):
        res = rf.refine_batch(
            scene, coord, normal, pre.images, pre.dscale, deltas,
            level=p.level, wsize=p.wsize, tau=p.tau,
            min_image_num=p.min_image_num,
            angle_threshold1=p.angle_threshold1, ascale=p.ascale,
            rounds=p.refine_rounds, n_cands=p.refine_cands,
            shrink=p.refine_shrink,
            init_depth_radius=p.refine_depth_radius,
            init_angle_radius=p.refine_angle_radius,
            grad_steps=p.grad_steps, grad_lr=p.grad_lr,
            group_dma=p.group_dma, luma=p.luma_refine, rgb_tail=p.rgb_tail,
            n_illums=p.n_illums,
        )

    with profiling.span("post"):
        post_images, post_ok, _ = vw.post_process_core(
            scene, res.coord, res.normal, pre.images,
            level=p.level, wsize=p.wsize, tau=p.tau,
            min_image_num=p.min_image_num, ncc_threshold=ncc_threshold,
            angle_threshold0=p.angle_threshold0,
            angle_threshold1=p.angle_threshold1,
            n_illums=p.n_illums,
        )
    ok = ok_in & pre.ok & post_ok
    fail1 = ok_in & pre.ok & ~post_ok

    with profiling.span("views"):
        vimages = gridmod.visible_extra_views(
            scene, grid, table, res.coord, res.normal, post_images,
            torch.full_like(post_images, -1), ok,
            p.level, p.csize, p.neighbor_threshold, use_depth,
        )

    if p.depth2_check:
        from . import filters as fl

        with profiling.span("check"):
            reject = fl.check_batch(
                scene, grid, table, res.coord, res.normal, pre.dscale,
                res.ncc, post_images, vimages,
                level=p.level, csize=p.csize, tau=p.tau,
                ncc_threshold=ncc_threshold, quad_threshold=quad_threshold,
                neighbor_threshold=p.neighbor_threshold,
                neighbor_threshold1=p.neighbor_threshold1,
                max_neighbors=p.neighbor_capacity, cand_cap=p.neighbor_cand_cap,
            )
        fail1 = fail1 | (ok & reject)
        ok = ok & ~reject

    return GauntletOut(
        coord=res.coord, normal=res.normal, images=post_images,
        vimages=vimages, ncc=res.ncc, dscale=pre.dscale, ascale=pre.ascale,
        ok=ok, fail0=fail0, fail1=fail1,
    )


def _insert_block(rows: PatchTable, dead_before, out: GauntletOut, acc_order, n_acc):
    """insert_patches on a block of table rows: a dead row's rank among
    the dead rows is its rank in the block plus `dead_before`, the dead
    rows of the earlier blocks."""
    B = out.ok.shape[0]
    dead = ~rows.alive
    dead_rank = torch.cumsum(dead.to(torch.int64), 0) - 1 + dead_before
    take = acc_order[dead_rank.clamp(0, B - 1)]
    write = dead & (dead_rank < n_acc)

    def mix(old, new):
        m = write.reshape((-1,) + (1,) * (old.ndim - 1))
        return torch.where(m, new[take], old)

    return PatchTable(
        coord=mix(rows.coord, out.coord),
        normal=mix(rows.normal, out.normal),
        ncc=mix(rows.ncc, out.ncc),
        dscale=mix(rows.dscale, out.dscale),
        ascale=mix(rows.ascale, out.ascale),
        images=mix(rows.images, out.images),
        vimages=mix(rows.vimages, out.vimages),
        alive=rows.alive | write,
    )


def insert_patches(table: PatchTable, out: GauntletOut, dp_devices=None) -> PatchTable:
    """Fill accepted hypotheses into dead rows of the table, best NCC
    first (stable, ties in hypothesis order); overflow beyond the free
    rows drops. The order of the accepted hypotheses (one stable sort of
    their keys) is made once on the table's device; `dp_devices` deals
    the table's rows in contiguous blocks (``shard.deal_rows``), each
    writing only its own rows, its dead ranks offset by the dead rows of
    the earlier blocks, and the blocks join in row order."""
    acc_key = torch.where(out.ok, -out.ncc, torch.full_like(out.ncc, 1e30))
    acc_order = torch.sort(acc_key, stable=True).indices
    n_acc = out.ok.sum()
    if not dp_devices:
        return _insert_block(table, 0, out, acc_order, n_acc)
    home = table.coord.device
    blocks = [b for b in sh.deal_rows("insert", table.capacity, dp_devices) if b[2] < b[3]]
    on = sh.replicas(dp_devices, home, out, acc_order, n_acc)
    dead = [(~table.alive[s:e].to(d)).sum().to(home) for _, d, s, e in blocks]
    before = torch.cumsum(torch.stack(dead), 0) - torch.stack(dead)
    parts = [_insert_block(PatchTable(*(x[s:e].to(d) for x in table)), before[j].to(d),
                           *on[d])
             for j, (_, d, s, e) in enumerate(blocks)]
    return PatchTable(*(sh.all_gather_rows([pt[f] for pt in parts], home)
                        for f in range(len(table))))


# How the gauntlet's chunks ran since the last profiling.COUNTERS.reset():
# "captures" and "replays" of CUDA graphs (every graphed chunk is one
# replay, its key's first right after its capture), "eager_<reason>"
# per chunk run op by op (graph_rule's reasons, and "no_runner" for a
# call without an engine's runner) and "pad_rows", the dead rows that
# filled ragged chunks to p.chunk rows.
GRAPHS = profiling.COUNTERS.counter("propagate.GRAPHS")


def graph_rule(device, dp_devices, scene: Scene, p: PropagateParams) -> Optional[str]:
    """Why a gauntlet chunk on `device` runs op by op, or None where it
    may replay a captured CUDA graph: "cpu" off a CUDA device; "dp" with
    the mesh's dp devices, which take the chunks; "view_mesh" on a
    view-sharded scene, whose sampler reads its shard counts on the host
    at every call; "polish" with the gradient polish (autograd through
    the sampler) or while the polish is recorded (CUDA events per
    refinement)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if dp_devices:
        return "dp"
    if scene.view_mesh is not None or scene.view_group is not None or scene.view_shards:
        return "view_mesh"
    if p.grad_steps > 0 or profiling.POLISH is not None:
        return "polish"
    return None


def _chunk_inputs(coord, normal, images, ok, rows, C: int):
    """The gauntlet's (coord, normal, images, ok_in) for the hypotheses
    `rows`, C rows of them: the rows past len(rows) copy the first and
    enter as dead (ok_in False). Each row is computed alone, so the
    first len(rows) outputs are the live rows'."""
    n = rows.numel()
    idx = rows if n == C else torch.cat([rows, rows[:1].expand(C - n)])
    ok_in = ok[idx]
    ok_in[n:] = False
    return coord[idx], normal[idx], images[idx], ok_in


class _Graph(NamedTuple):
    graph: object        # torch.cuda.CUDAGraph
    out: GauntletOut     # its static outputs
    scene: Scene         # held, so that the key's id(scene) stays its own
    counts: dict         # the capture's increments of profiling.COUNTERS


class _GauntletGraphs:
    """An engine's gauntlet chunks as CUDA graph replays.

    A key holds the scene, the shapes of the inputs and every Python
    value ``run_gauntlet`` bakes into its kernels (`p`, the thresholds,
    `use_depth`); its first chunk is captured and then replayed, and
    every later chunk replays. The graphs read static buffers: the scene
    by reference, the round's grid and table copied in once a round
    (``load``), the chunk's padded inputs copied in before each replay.
    Every registered counter (``profiling.COUNTERS``; the sampler's
    wrappers bump its launch counters while a graph is captured) takes
    the capture's increments again at every later replay. The graphs share
    one memory pool: a replay writes all it reads but the static buffers,
    and its outputs are read before the next replay. ``release`` frees
    them; the engine's ``close`` calls it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[tuple, _Graph] = {}
        self.buffers: Dict[tuple, list] = {}
        self.state = None    # (signature, grid, table) of the round loaded
        self.stream = None
        self.pool = None

    def _static(self, role: str, tensors):
        """Buffers of `role` shaped as `tensors`, holding their values;
        returns (signature, buffers)."""
        sig = (role,) + tuple((tuple(t.shape), t.stride(), t.dtype) for t in tensors)
        bufs = self.buffers.get(sig)
        if bufs is None:
            bufs = self.buffers[sig] = [torch.empty_like(t) for t in tensors]
        for b, t in zip(bufs, tensors):
            b.copy_(t)
        return sig, bufs

    def load(self, grid: gridmod.GridState, table: PatchTable) -> None:
        """Copy a round's grid and table into the static buffers."""
        gsig, g = self._static("grid", grid)
        tsig, t = self._static("table", table)
        self.state = ((gsig, tsig), gridmod.GridState(*g), PatchTable(*t))

    def run(self, scene: Scene, inputs, p: PropagateParams, ncc_threshold,
            ncc_threshold_before, use_depth, quad_threshold) -> GauntletOut:
        """``run_gauntlet`` on the loaded grid and table and the chunk's
        `inputs` (coord, normal, images, ok_in, deltas): a capture on
        the key's first chunk, then a replay. The outputs are the
        graph's own tensors, valid until its next replay."""
        state_sig, grid, table = self.state
        sig, static = self._static("chunk", inputs)
        args = (p, ncc_threshold, ncc_threshold_before, use_depth, quad_threshold)
        key = (id(scene), state_sig, sig) + args
        entry = self.graphs.get(key)
        if entry is None:
            with profiling.span("capture"):
                entry = self.graphs[key] = self._capture(scene, grid, table, static, args)
            GRAPHS["captures"] += 1
        else:
            profiling.COUNTERS.credit(entry.counts)
        with profiling.span("replay"):
            entry.graph.replay()
        GRAPHS["replays"] += 1
        profiling.note(graphed=1)
        return entry.out

    def _capture(self, scene, grid, table, static, args) -> _Graph:
        dev = self.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        before = profiling.COUNTERS.snapshot()
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                out = run_gauntlet(scene, grid, table, *static, *args)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        self.pool = graph.pool()
        return _Graph(graph, out, scene, profiling.COUNTERS.since(before))

    def release(self) -> None:
        """Free the graphs, their pool's tensors and the static buffers."""
        for entry in self.graphs.values():
            entry.graph.reset()
        self.graphs.clear()
        self.buffers.clear()
        self.state = self.stream = self.pool = None


def _gauntlet_chunked(scene, grid, table, coord, normal, images, ok,
                      noise: RoundNoise, p: PropagateParams, ncc_threshold,
                      ncc_threshold_before, use_depth,
                      quad_threshold=2.5, dp_devices=None, *,
                      graphs: Optional[_GauntletGraphs] = None) -> GauntletOut:
    """Run the gauntlet over the live hypotheses, `p.chunk` at a time.

    Hypothesis h belongs to JAX chunk h // C and row h % C, and draws
    that chunk's noise row; dead hypotheses are not computed (their
    outputs are zeros with ok False, as the JAX gauntlet reports them).
    On a CUDA device every chunk runs at C rows (``_chunk_inputs``: a
    ragged chunk's padding rows copy its first row, enter as dead and
    draw zero deltas, and their outputs are dropped), and with an
    engine's runner `graphs` each chunk is a replay of its key's CUDA
    graph where ``graph_rule`` allows; ``GRAPHS`` counts how the chunks
    ran.

    `dp_devices` (the mesh's dp axis) deals the live chunks, whole and
    in order, round robin to those devices: chunk i (rows live[i C:(i +
    1) C] with their noise rows) runs on device i % dp against a copy of
    the scene, table and grid made once per distinct device, and its
    outputs come back to the home device in chunk order. Each chunk's
    hypotheses are computed alone, as the unsharded run computes them,
    so the result is the unsharded one bit for bit. ``shard.DP_ROWS``
    counts the hypotheses each dp device took. The recorder sees a span
    ``chunk`` (``rows``; ``graphed`` on a replayed one, with ``capture``
    and ``replay`` inside) per chunk, and a sync at each host read: none
    in a chunk, whose noise rows are one gather on the device."""
    H = coord.shape[0]
    C = min(p.chunk, H)
    n_chunks = (H + C - 1) // C
    dev = coord.device
    pad = dev.type == "cuda"
    reason = graph_rule(dev, dp_devices, scene, p)
    if reason is None and graphs is None:
        reason = "no_runner"
    with profiling.sync("gauntlet.live"):
        live = torch.nonzero(ok).flatten()
    out = GauntletOut(
        coord=torch.zeros_like(coord), normal=torch.zeros_like(normal),
        images=torch.full_like(images, -1), vimages=torch.full_like(images, -1),
        ncc=torch.zeros(H, dtype=torch.float32, device=dev),
        dscale=torch.zeros(H, dtype=torch.float32, device=dev),
        ascale=torch.zeros(H, dtype=torch.float32, device=dev),
        ok=torch.zeros(H, dtype=torch.bool, device=dev),
        fail0=torch.zeros(H, dtype=torch.bool, device=dev),
        fail1=torch.zeros(H, dtype=torch.bool, device=dev),
    )
    if live.numel() == 0:
        return out
    has_live = torch.zeros(n_chunks, dtype=torch.bool, device=dev).index_fill_(0, live // C, 1)
    with profiling.sync("gauntlet.chunks"):
        live_chunks = [ch for ch, h in enumerate(has_live.tolist()) if h]
    profiling.note(chunks=(live.numel() + C - 1) // C)
    # row 0 zeros, which the padding rows draw, then the live JAX chunks'
    # noise in ascending order: the j-th one's row r at 1 + j C + r
    R, K = p.refine_rounds, p.refine_cands
    noise_rows = torch.cat([torch.zeros((R, 1, K, 3), dtype=torch.float32, device=dev)] + [
        noise.refine(ch, n_chunks, R, C, K).to(dev, torch.float32) for ch in live_chunks], 1)
    first_row = torch.cumsum(has_live, 0) * C - (C - 1)
    devices = [dev] if not dp_devices else [torch.device(d) for d in dp_devices]
    if reason is None:
        graphs.load(grid, table)
    else:
        state = sh.replicas(devices, dev, scene, grid, table)
    args = (p, ncc_threshold, ncc_threshold_before, use_depth, quad_threshold)
    for i, s in enumerate(range(0, live.numel(), C)):
        rows = live[s:s + C]
        n = rows.numel()
        width = C if pad else n
        with profiling.span("chunk", rows=n):
            idx = torch.nn.functional.pad(first_row[rows // C] + rows % C, (0, width - n))
            deltas = noise_rows.index_select(1, idx)
            inputs = _chunk_inputs(coord, normal, images, ok, rows, width) + (deltas,)
            GRAPHS["pad_rows"] += width - n
            if reason is None:
                res = graphs.run(scene, inputs, *args)
            else:
                GRAPHS[f"eager_{reason}"] += 1
                d = devices[i % len(devices)]
                if dp_devices:
                    sh.DP_ROWS["gauntlet", i % len(devices)] += n
                scn, grd, tbl = state[d]
                res = run_gauntlet(scn, grd, tbl, *(x.to(d) for x in inputs), *args)
            for dst, src in zip(out, res):
                dst[rows] = src[:n].to(dev)
    return out


def _noise(noise: Optional[RoundNoise], generator) -> RoundNoise:
    if noise is None:
        if generator is None:
            raise ValueError("propagate_round needs noise or a generator")
        noise = TorchNoise(generator)
    return noise


def propagate_round(
    scene: Scene, table: PatchTable, noise: Optional[RoundNoise],
    p: PropagateParams, direction: int, ncc_threshold, ncc_threshold_before,
    use_depth: bool = True, quad_threshold=2.5, row_limit=None,
    generator: Optional[torch.Generator] = None, dp_devices=None, *,
    graphs: Optional[_GauntletGraphs] = None,
) -> Tuple[PatchTable, RoundStats]:
    """One propagation round: each donor propagates into both its x- and
    y-neighbor target cell from one shared grid build and donor
    selection (propagate.cpp:106-108). Without `noise`, the round draws
    from `generator`. `dp_devices` partitions every stage of the round
    over the mesh's dp devices: the grid build's rows below `row_limit`,
    the flat slots of donor selection, the donors of hypothesis
    generation, the gauntlet's chunks and the table rows of insertion
    (each stage's docstring says how it merges). `graphs`, an engine's
    runner, replays the gauntlet's chunks as CUDA graphs
    (``_gauntlet_chunked``)."""
    noise = _noise(noise, generator)
    grid = gridmod.build_grid(scene, table, p.level, p.csize,
                              p.cell_capacity, row_limit=row_limit,
                              dp_devices=dp_devices)
    # cap enforcement kills over-capacity patches globally
    # (propagate.cpp:94-98 removePatch)
    table = table._replace(alive=table.alive & ~grid.evicted)

    with profiling.span("donors"):
        donors = select_donors(scene, grid, table, p.donor_budget, p.donor_policy,
                               dp_devices=dp_devices)
    return round_from_donors(
        scene, table, grid, donors, (None, None), noise, p, direction,
        ncc_threshold, ncc_threshold_before, use_depth, quad_threshold,
        dp_devices, graphs=graphs)


def round_from_donors(scene, table, grid, donors, gates, noise: RoundNoise,
                      p: PropagateParams, direction: int, ncc_threshold,
                      ncc_threshold_before, use_depth, quad_threshold,
                      dp_devices=None, *,
                      graphs: Optional[_GauntletGraphs] = None
                      ) -> Tuple[PatchTable, RoundStats]:
    """A round after its grid build and donor selection: hypotheses into
    the x- and y-neighbor cells (``gates`` gives each axis's full-cell
    gate as (gate_full, gate_worst_ncc), or None to read `grid`), the
    gauntlet (replayed by `graphs` where it may), insertion and the
    round's counts."""
    with profiling.span("hypotheses"):
        parts = []
        for axis, gate in zip((0, 1), gates):
            gate_full, gate_worst = (None, None) if gate is None else gate
            parts.append(generate_hypotheses(
                scene, table, grid, *donors, axis, direction,
                noise.jitter(axis, p.donor_budget).to(table.coord.device), p,
                gate_full=gate_full, gate_worst_ncc=gate_worst, dp_devices=dp_devices))
        coord, normal, images, _, ok = (
            torch.cat([pt[i] for pt in parts]) for i in range(5)
        )
    with profiling.span("gauntlet"):
        out = _gauntlet_chunked(
            scene, grid, table, coord, normal, images, ok, noise, p,
            ncc_threshold, ncc_threshold_before, use_depth, quad_threshold,
            dp_devices, graphs=graphs,
        )
    with profiling.span("insert"):
        table = insert_patches(table, out, dp_devices)
    return table, _round_stats(ok, out)


def _round_stats(ok, out: GauntletOut) -> RoundStats:
    """A round's counts, four host reads."""
    with profiling.sync("round.total"):
        total = int(ok.sum())
    with profiling.sync("round.fail0"):
        fail0 = int(out.fail0.sum())
    with profiling.sync("round.fail1"):
        fail1 = int(out.fail1.sum())
    with profiling.sync("round.passed"):
        passed = int(out.ok.sum())
    return RoundStats(total=total, fail0=fail0, fail1=fail1, passed=passed)
