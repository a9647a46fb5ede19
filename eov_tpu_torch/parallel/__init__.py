"""Multi-GPU execution: the ('data', 'frame') mesh, launch, sharded steps.

Counterpart of ``eov_tpu/parallel/``. The port runs one process per GPU,
launched by ``torchrun`` (``python -m torch.distributed.run``), each rank
on ``cuda:LOCAL_RANK``; the collectives are ``torch.distributed``'s (NCCL
between GPUs, gloo on the CPU). Every rank runs the port's single-GPU
programs unchanged on its block of the global batch:

* ``mesh`` — the ('data', 'frame') mesh over the initialized world, frame
  innermost (rank = data index * n_frame + frame index), with one process
  group per data row (its frame ranks) and one per frame column;
* ``distributed`` — ``initialize`` (explicit arguments, or torchrun's
  environment), the record shard of a rank, ``global_max``, ``barrier``
  and the broadcasts;
* ``sharded`` — the sharded feature program (clips over 'data', a clip's
  segments over 'frame', one all-reduce) and the sharded episodic eval.

Sharded training lives in ``train.py`` (``make_train_step(mesh=)``,
``train_epoch(mesh=)``) and the sharded extraction loop in ``extract.py``
(``extract_features(mesh=)``), as in the reference.
"""

from eov_tpu_torch.parallel.mesh import DATA_AXIS, FRAME_AXIS, Mesh, make_mesh

__all__ = ["make_mesh", "Mesh", "DATA_AXIS", "FRAME_AXIS"]
