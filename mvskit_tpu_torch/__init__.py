"""mvskit_tpu_torch: the PM-MVS engine in PyTorch, for one NVIDIA H100.

The PyTorch/CUDA port of ``mvskit_tpu``. It runs both propagation
strategies of the JAX package on one device, ``pm_image`` (the main
path) and the PMVS-style expansion ``pmvs``, with the RGB or the luma
refinement search and one or several illuminations, as plain tensor
code around one hand-written CUDA kernel, the NCC window sampler
(``ops/cuda_ncc.py``, ``csrc/sample_windows.cu``: ungrouped, grouped and
fused launch forms with the JAX kernel's ablation switches, timed by
``tools/bench_kernel.py``). It reads the same option files and dataset
directories and writes the same ``.patch`` and ``.ply`` files.

The package imports ``torch`` and never ``jax``, and nothing of
``mvskit_tpu``: it keeps its own copies of the jax-free modules it needs
(``config``, ``io``, ``image.decode``, ``utils.metrics`` and the numpy
renderers of ``utils.synthetic``), each naming its source.
"""

from .device import get_device

__all__ = ["get_device"]
