"""The non-local blocks' share of the train loop: the device seconds
between the ends of the program's timed ``model.nonlocal`` spans (each
block's forward and backward, CUDA events on the step's stream) over the
untraced tail's epochs' wall time, in percent."""

from benchmark.metrics._program import tail


def read(run):
    reps = tail("train")
    if not reps or any(not r.get("device_span_s") for r in reps):
        return None
    s = sum(r["device_span_s"].get("model.nonlocal", 0.0) for r in reps)
    wall = sum(r["wall_s"] for r in reps)
    return 100.0 * s / wall if s > 0 and wall > 0 else None
