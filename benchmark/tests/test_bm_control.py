"""The control, computed in the precision below the configuration's, comes
out not correct against each cell's limits.

On the CPU at a tiny size: the training reference in float8 (e4m3, one
scale a tensor) in the program's place. On the card (marked ``cuda``, run
with ``python3 -m pytest benchmark/tests -m cuda`` from the repository's
root): the same at the cell's own size, and the program's own int8 path
for extraction.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import data, manifest
from benchmark.jobs import finetune as FT
from benchmark.reference import resnet
from benchmark.reference import train as ref_train
from benchmark.reference.shards import ShardSet
from benchmark.tests.conftest import REPO, tiny_cell


def _control_gaps(cell, root, seed, device):
    shards = ShardSet(data.shard_set(str(root), cell.traffic["data"]))
    p0 = resnet.make_weights(cell.config, seed, device)
    train = {"batch_clips": cell.traffic["batch_clips_per_chip"]
             * cell.chips}
    if len(shards.records) < 3 * train["batch_clips"]:
        cell.traffic["data"]["clips_per_class"] = 4 * cell.chips
        shards = ShardSet(data.shard_set(str(root), cell.traffic["data"]))
    ref = ref_train.first_steps(p0, cell.config, train, shards, seed, device)
    ctl = ref_train.first_steps(p0, cell.config, train, shards, seed, device,
                                quant=resnet.fp8_round)
    return FT.gaps(ctl, ref)


@pytest.mark.parametrize("name", ["r50_finetune", "r34_finetune",
                                  "r50_finetune_dp4"])
def test_train_control_fails_tiny(tmp_path, name):
    cell = tiny_cell(name)
    got = _control_gaps(cell, tmp_path, 2 ** 31 + 3, "cpu")
    assert any(v > cell.limits[k] for k, v in got.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r50_finetune", "r34_finetune",
                                  "r50_finetune_dp4"])
def test_train_control_fails(tmp_path, cuda, name):
    cell = manifest.load_cell(REPO, name)
    got = _control_gaps(cell, tmp_path, 2 ** 31 + 4, cuda)
    assert any(v > cell.limits[k] for k, v in got.items()), got


@pytest.mark.cuda
def test_extract_control_fails(tmp_path, cuda):
    from benchmark import calibrate

    cell = manifest.load_cell(REPO, "r50_extract")
    got = dict(calibrate._extract(cell, 2 ** 31 + 5, str(tmp_path), True,
                                  True, False))
    assert all(v <= cell.limits[k] for k, v in got["program"].items())
    assert any(v > cell.limits[k]
               for k, v in got["control_int8"].items()), got
    torch.cuda.empty_cache()
