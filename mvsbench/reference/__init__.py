"""The benchmark's plain reference: cameras, image pyramids and the
photo-consistency (NCC) score of a patch, written again from the MVS
engine's definitions in plain PyTorch and NumPy.

It reads the dataset files the benchmark wrote (``txt/*.txt`` cameras,
``image/*.ppm`` images) and imports nothing of the program under test
and nothing of JAX. ``dtype`` selects the precision of every step:
float64 is the reference, bfloat16 the control of the output check.
"""
