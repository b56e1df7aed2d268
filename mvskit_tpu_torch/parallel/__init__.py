"""Device meshes for the PM-MVS engine (port of ``mvskit_tpu/parallel``).

The reference is single-threaded (SURVEY.md §2); the three parallel axes
are the JAX package's own design, kept here with its split:

  * ``shard.py`` and ``tiles.py`` — one controller per process drives a
    ``Mesh`` of devices (JAX's ``Mesh`` + ``shard_map``). Collectives
    are explicit functions on tensors (``psum``, ``ppermute_rows``,
    ``all_gather_rows``). Devices may repeat, so k logical shards can
    share one card or the CPU (the JAX tests' virtual CPU devices);
  * ``multihost.py`` — the cross-process tier, over
    ``torch.distributed`` with an explicit backend.

Axes: ``view`` shards the pyramid planes (every NCC window fetch runs
per shard on its own planes, ``ops/ncc._sample_windows_view_sharded``);
``tile`` shards the cell-grid rows of a propagation round
(``tiles.tiled_propagate_round``); ``dp`` deals the rows each stage of a
round and of the filter pass scans to its devices in contiguous blocks
and merges them exactly (``shard.deal_rows``).
"""
