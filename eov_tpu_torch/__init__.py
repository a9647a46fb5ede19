"""eov_tpu_torch — Embodied One-Shot Video Recognition in PyTorch + CUDA.

The PyTorch port of ``eov_tpu`` (the JAX/Pallas reference, which stays as
it is). Modules mirror the reference's names. The paths:

    data.datasets (synthetic fixtures; EOVC shards through
    runtime.native or runtime.eovc, packed by tools.pack_eovc; frame
    folders; video files; data.class_splits) -> uint8 clips, a batch at a
    time into extract.py's host buffer ring
                -> ops.crop_normalize (CUDA kernel 1)
                -> models.folded_infer: BN-folded ResNet, stage 1 through
                   ops.bottleneck (CUDA kernel 2), the rest on cuDNN
                   or, with quant="int8", models.quant_infer: the int8
                   forward, stage 1 through ops.bottleneck_int8 (CUDA
                   kernel 7), the other convs int8 im2col matmuls
                -> TSN mean consensus -> data.store.FeatureStore
    store -> eval: seeded episodes (episodes, prng — bit-exact to
             jax.random), with embodied eval the aligned virtual bank
             (embodied) appended to each support -> ops.similarity
             matcher (CUDA kernel 3) -> accuracy ± 95% CI
    classify: new clips featurized as the support store was (its recorded
              precision and int8 scales) -> the matcher over every class
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
