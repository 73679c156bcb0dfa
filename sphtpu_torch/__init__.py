"""sphtpu_torch: the PyTorch/CUDA port of the sphtpu SPH framework.

Same sub-layout and function names as the JAX package `sphtpu`, which
stays in the repository as the reference. This package imports `torch`,
never `jax` and nothing of `sphtpu`. Every entry point takes
``device=None`` meaning ``"cuda"`` and raises when there is no CUDA
device; only an explicit ``device="cpu"`` runs on the CPU (where the
hand-written CUDA kernels are replaced by their plain PyTorch versions,
because the tensors lie on the CPU).
"""

__version__ = "0.1.0"
