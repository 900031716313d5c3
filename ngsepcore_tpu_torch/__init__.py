"""ngsepcore_tpu_torch — the align+call flagship of ngsepcore_tpu in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ngsepcore_tpu's layout and function names so each
counterpart is found by path.  It imports torch and numpy only.  Every
entry point takes an explicit `device`; CPU tensors run the plain PyTorch
versions of the two kernels (kernels/pairwise_cuda.py,
kernels/shear_pileup.py), CUDA tensors launch the kernels built from
csrc/ at first use (kernels/cuda_build.py).
"""

__version__ = "0.1.0"
