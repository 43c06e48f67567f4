"""Kernels of the port: each TPU kernel of the ported path as a CUDA
kernel (``csrc/``), with a wrapper (``ops.py``) and a plain PyTorch
version of the same function (``ref.py``).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises.
"""
