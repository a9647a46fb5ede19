"""The port's benches, one JSON line each (counterparts of the reference's
root ``bench*.py``):

* ``bench.features`` — clip-feature throughput of the feature program
  (``bench.py``; the root ``bench_torch.py`` runs it);
* ``bench.train`` — TSN finetune step throughput (``bench_train.py``);
* ``bench.eval`` — episodic eval throughput (``bench_eval.py``);
* ``bench.e2e`` — sustained extraction from RAW EOVC shards, host work
  included (``bench_e2e.py``).

Each runs ``python -m eov_tpu_torch.bench.<name>`` on ``cuda`` unless
``EOV_BENCH_DEVICE=cpu``; ``bench.common`` holds what they share.
"""
