"""vstrains_tpu_torch — the VStrains strain-reconstruction pipeline in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors the layout of the JAX package `vstrains_tpu`: `core/`, `algos/`,
`evals/`, `native/` and `utils/checkpoint.py` are framework-free host code
copied from it (with the import prefix rewritten), so the port runs where
JAX is not installed. `ops/pe_infer.py` is the paired-end link engine:
numpy host code plus torch device code, whose per-batch hot steps
(window hashes, the classic probe's duplicate-run scan, per-(read, node)
stats, pair counts, the sparse engine's row sort) are CUDA kernels under
`csrc/`, built at first use (`ops/_build.py`) and bound with ctypes
(`ops/cuda_kernels.py`). The device is explicit (`device.resolve_device`):
`cuda` is the CLI default, and the port never falls back to the CPU on
its own.
"""

__version__ = "0.1.0"

from vstrains_tpu_torch.core.graph import AssemblyGraph  # noqa: F401
