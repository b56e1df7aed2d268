"""The benchmark of the PyTorch/CUDA port (``mvskit_tpu_torch``): whole
multi-view stereo reconstructions timed end to end on one NVIDIA H100,
their clouds judged against the scene's analytic surface, and the
engine's scene load and NCC scores held to a plain reference.

Run one cell of ``BENCHMARK.json``:

    python3 -m mvsbench.run --workload dino16.plane --seed 7 --seconds 51 --trace 0

Its tests: ``python -m pytest mvsbench/tests -q`` (CPU; cases marked
``cuda`` run on a card). The control of the output check at a cell's own
size: ``python3 -m mvsbench.control --workload <cell> --seeds 1,2,3``.
"""
