"""eov_tpu_torch — Embodied One-Shot Video Recognition in PyTorch + CUDA.

The PyTorch port of ``eov_tpu`` (the JAX/Pallas reference, which stays as
it is). Modules mirror the reference's names. The paths:

    uint8 clips -> ops.crop_normalize (CUDA kernel 1)
                -> models.folded_infer: BN-folded ResNet, stage 1 through
                   ops.bottleneck (CUDA kernel 2), the rest on cuDNN
                -> TSN mean consensus -> data.store.FeatureStore
    store -> eval: seeded episodes (episodes, prng — bit-exact to
             jax.random) -> ops.similarity matcher (CUDA kernel 3)
          -> accuracy ± 95% CI
    train: TSN clips -> ops.preprocess multiscale crops -> models.resnet
           ResNet with stage 1 and the stage-2 tail through
           ops.bottleneck_train (CUDA kernels 8 forward, 9 backward), the
           rest on cuDNN with autograd -> CE -> SGD; utils.checkpoint per
           epoch; train.evaluate_classifier / one_shot_validate

Each kernel has a plain PyTorch version in the same module; an op takes
the plain version for a CPU tensor and the kernel for a CUDA tensor.
Entry points default to ``cuda`` and raise without a GPU unless the caller
passes ``device="cpu"``. The kernels build with nvcc into
``build/torch_kernels/`` on first use (ops/_cuda.py). This package imports
neither ``jax`` nor anything of ``eov_tpu``.
"""
