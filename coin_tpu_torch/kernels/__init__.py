"""Hand-written Hopper kernels of the port: the nvcc build (``build``) and
one ctypes launcher per kernel, each with a ``launches`` counter."""
