"""eov_tpu_torch — Embodied One-Shot Video Recognition in PyTorch + CUDA.

The PyTorch port of ``eov_tpu`` (the JAX/Pallas reference, which stays as
it is). Modules mirror the reference's names. The main path:

    uint8 clips -> ops.crop_normalize (CUDA kernel 1)
                -> models.folded_infer: BN-folded ResNet, stage 1 through
                   ops.bottleneck (CUDA kernel 2), the rest on cuDNN
                -> TSN mean consensus -> data.store.FeatureStore
    store -> eval: seeded episodes (episodes, prng — bit-exact to
             jax.random) -> ops.similarity matcher (CUDA kernel 3)
          -> accuracy ± 95% CI

Each kernel has a plain PyTorch version in the same module; an op takes
the plain version for a CPU tensor and the kernel for a CUDA tensor.
Entry points default to ``cuda`` and raise without a GPU unless the caller
passes ``device="cpu"``. The kernels build with nvcc into
``build/torch_kernels/`` on first use (ops/_cuda.py). This package imports
neither ``jax`` nor anything of ``eov_tpu``.
"""
