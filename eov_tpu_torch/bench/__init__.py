"""The port's benches, one JSON line each (counterparts of the reference's
root ``bench*.py``):

* ``bench.features`` — clip-feature throughput of the feature program
  (``bench.py``; the root ``bench_torch.py`` runs it);
* ``bench.train`` — TSN finetune step throughput (``bench_train.py``);
* ``bench.eval`` — episodic eval throughput (``bench_eval.py``);
* ``bench.e2e`` — sustained extraction from RAW EOVC shards, host work
  included (``bench_e2e.py``);
* ``bench.fused_eval`` — the literal fused eval program (episodes gathered
  as uint8 clips and featurized per step) against the extract-once cache
  (``bench_fused_eval.py``);
* ``bench.classify`` — classify per-query latency and batched queries/s
  (``bench_classify.py``);
* ``bench.episode`` — one cold 5-way 1-shot episode (``bench_episode.py``);
* ``bench.decode`` — host clip-decode throughput, one line per path
  (``bench_decode.py``).

Each runs ``python -m eov_tpu_torch.bench.<name>`` on ``cuda`` unless
its device variable says ``cpu`` (``EOV_BENCH_DEVICE``; classify and
episode: ``EOV_CLASSIFY_DEVICE`` / ``EOV_EPISODE_DEVICE``; decode has no
device work); ``bench.common`` holds what they share.
"""
