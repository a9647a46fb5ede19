"""The readings that the TSM + non-local cell's limits are set from, on the
chip: ``calibrate.py``'s training readings with this cell's control and
faults.

    python3 -m benchmark.calibrate_tsm --seeds 1,2,3 [--control N] [--faults N]

For each seed, in one process: the cell's set-up and its window's first
epoch, then its check against the reference (the program's readings). For
the first ``--control`` seeds, the reference in float8 (e4m3, one scale a
tensor; the convs', the fc's and the attention products' inputs) in the
program's place. For the first ``--faults`` seeds, each fault planted in the
float32 reference put in the program's place: the shift left out, its two
directions swapped, the non-local blocks left out, their softmax scaled by
1/√Ci, every BN on its running statistics; and ``calibrate.py``'s training
faults: half of each batch left out (its batch statistics too), the
momentum reset at the window's epoch, epoch 0's order again there. A state
left unchanged reads 1 by the training measure and needs no run. One JSON
line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

WORKLOAD = "tsm_nl_r50_finetune"
FAULTS = {"shift_off": {"shift": "off"}, "shift_swapped": {"shift": "swapped"},
          "nonlocal_off": {"nonlocal_": "off"},
          "nonlocal_scaled": {"nonlocal_": "scaled"},
          "running_stats": {"batch_stats": False}}
# the window's carry, planted in the window's phase alone
CARRY = {"momentum_reset": {"buf0": {}}, "epoch_repeated": {"epoch": 0}}


def readings(cell, seed: int, root: str, control: bool, faults: bool):
    from benchmark import calibrate
    from benchmark.jobs import finetune as FT
    from benchmark.reference import resnet

    job = calibrate._job(cell, seed, root)
    job.window(0, None)  # the window's own call: one epoch
    job.release()
    refs = {ph: job.reference(ph) for ph, _ in FT.PHASES}

    def read(mode, side):
        got = {}
        for ph, prefix in FT.PHASES:
            start, ref = refs[ph]
            got.update({prefix + k: v
                        for k, v in FT.gaps(side(ph, start), ref).items()})
        return mode, got

    yield read("program", lambda ph, start: job.program_side(start, ph))
    if control:
        yield read("control_fp8", lambda ph, start: job.reference(
            ph, quant=resnet.fp8_round)[1])
    if not faults:
        return
    for name, kw in FAULTS.items():
        yield read(f"fault_{name}", lambda ph, start, kw=kw: job.reference(
            ph, **kw)[1])
    half = cell.traffic["batch_clips_per_chip"] // 2
    yield read("fault_half_batch", lambda ph, start: job.reference(
        ph, rows_used=half)[1])
    for name, kw in CARRY.items():
        yield read(f"fault_{name}", lambda ph, start, kw=kw: job.reference(
            ph, **(kw if ph == "window" else {}))[1])


def main(argv=None) -> int:
    from benchmark import manifest

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = manifest.load_cell(root, WORKLOAD)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for mode, got in readings(cell, seed, root, i < args.control,
                                  i < args.faults):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
