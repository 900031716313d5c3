"""Device code of the align+call path, in PyTorch.

  kmers.py, minimizers.py  canonical k-mer codes and window minimizers
  tier1.py, seeding.py     seed lookup, diagonal clustering, tier-1 screen
  pairwise.py              tier-3 Gotoh DP: forward plane, run-jump walk, stats
  pairwise_cuda.py         CUDA Gotoh forward kernel + its plain version
  shear_pileup.py          pileup histogram (CUDA shear kernel + plain version)
  genotyping.py            window genotyper over the histogram
  cuda_build.py            nvcc build and ctypes binding of csrc/*.cu
"""
