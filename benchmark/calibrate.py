"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--control N] [--faults N]

For each seed, in one process: the cell's set-up (which drives the program
through the window's own call and feed) and its check against the
reference, as a run makes them: the program's readings. For the first
``--control`` seeds, the control's readings: for a training cell the
reference computed in float8 (e4m3, one scale a tensor) in the program's
place; for an extraction cell the program's own int8 path. For the first
``--faults`` seeds, each fault's readings, planted in the float32
reference put in the program's place: half of each batch left out (the
mean over the rest); on several chips, the exchange left out (rank 0's
block alone); in extraction, half of the segments left out and one clip's
answer altered. A state left unchanged reads 1 by the training measure and
needs no run. One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

DEVICE = torch.device("cuda", 0)


def _job(cell, seed: int, root: str, traffic: dict | None = None):
    from benchmark import manifest, run as R, tracing

    if traffic is not None:
        cell = dataclasses.replace(cell, traffic=traffic)
    run = R.Run(cell, seed, DEVICE, R.cache_env(root),
                spans=tracing.Spans())
    run.kind = (torch.cuda.get_device_name(DEVICE)
                if DEVICE.type == "cuda" else "cpu")
    job = manifest.job_module(cell.job).Job(run)
    job.setup()
    return job


def _train(cell, seed, root, program: bool, control: bool, faults: bool):
    """Both phases' readings (epoch 0 from the seed's weights; the window's
    first epoch from the state it starts from). Without ``program`` (a cell
    on several chips) the state comes from the program on one chip at the
    cell's global batch, and only the control and the faults are read."""
    from benchmark.jobs import finetune as FT
    from benchmark.reference import resnet

    b = cell.traffic["batch_clips_per_chip"] * cell.chips
    job = _job(cell, seed, root, dict(cell.traffic, batch_clips_per_chip=b))
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

    if program:
        yield read("program", lambda ph, start: job.program_side(start, ph))
    if control:
        yield read("control_fp8", lambda ph, start: job.reference(
            ph, quant=resnet.fp8_round)[1])
    if faults:
        yield read("fault_half_batch", lambda ph, start: job.reference(
            ph, rows_used=b // 2)[1])
        if cell.chips > 1:
            yield read("fault_no_exchange", lambda ph, start: job.reference(
                ph, rows_used=b // cell.chips)[1])
        # the window's carry: momentum reset at the epoch, epoch 0 again
        yield read("fault_momentum_reset", lambda ph, start: job.reference(
            ph, **({"buf0": {}} if ph == "window" else {}))[1])
        yield read("fault_epoch_repeated", lambda ph, start: job.reference(
            ph, **({"epoch": 0} if ph == "window" else {}))[1])
    del job, refs


def _extract(cell, seed, root, program: bool, control: bool,
             faults: bool):
    from benchmark.jobs import extract as EX
    from benchmark.reference import extract as ref_extract
    from benchmark.reference import resnet
    from benchmark.reference.shards import ShardSet

    job = _job(cell, seed, root)  # the program's pass is its set-up's
    shards = ShardSet(job.root)
    n = len(shards.records)
    vids = [shards.video_id(i) for i in range(n)]
    labels = [shards.label(i) for i in range(n)]
    ref = job.reference(shards)
    if program:
        yield "program", EX.feature_gaps(job.stored(), ref, vids, labels)
    job.release()
    if control:
        tr = dict(job.traffic, quant="int8")
        ctl = _job(cell, seed, root, tr)
        yield "control_int8", EX.feature_gaps(ctl.stored(), ref, vids,
                                              labels)
        ctl.release()
    if faults:
        p = resnet.make_weights(job.cfg, seed, job.run.device)
        k = job.cfg["extract_segments"]
        half = ref_extract.features(p, job.cfg, shards, list(range(n)),
                                    job.run.device, k=k,
                                    segments_used=k // 2)
        store = {v: (half[i].cpu().numpy(), labels[i])
                 for i, v in enumerate(vids)}
        yield "fault_half_segments", EX.feature_gaps(store, ref, vids,
                                                     labels)
        store = {v: (ref[i].cpu().numpy(), labels[i])
                 for i, v in enumerate(vids)}
        store[vids[0]] = (ref[1].cpu().numpy(), labels[0])
        yield "fault_altered_answer", EX.feature_gaps(store, ref, vids,
                                                      labels)


def main(argv=None) -> int:
    from benchmark import manifest

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--no-program", action="store_true",
                    help="reference readings only (a cell on several chips)")
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = manifest.load_cell(root, args.workload)
    readings = _train if cell.job == "finetune" else _extract
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for mode, got in readings(cell, seed, root, not args.no_program,
                                  i < args.control, i < args.faults):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
