"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with at least the cell's chips.
The run builds what the program builds, makes its clips and weights from the
seed, warms up (``setup_s``: process start to window start), measures for
``--seconds``, then checks what the window produced against the plain
reference. The numbers compared are printed, each beside its limit, as the
last lines of standard error and under ``checks``, the last key of the one
JSON line printed last on standard output. ``--trace 1`` profiles the
window's first whole epochs or passes and reports the per-layer metrics
instead of the end-to-end ones.

A cell on several chips is one process per chip, started here; rank 0
prints. A run exits non-zero and prints no result without the chips it
needs, or when JAX or the JAX package is loaded in any rank once the window
has closed.
"""

from __future__ import annotations

import time

T0 = time.time()  # the process's start, as near as the interpreter lets us

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "eov_tpu")
CACHE = ".benchcache"


def forbidden_loaded() -> list[str]:
    """Top-level names of ``sys.modules`` that are JAX or the JAX package,
    compared whole (``eov_tpu_torch`` is not ``eov_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env(root: str) -> str:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, CACHE)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    # One process a chip, one intra-op thread: the program's host work is
    # per-step Python and copies, and idle pool threads only add jitter.
    os.environ["OMP_NUM_THREADS"] = "1"
    os.makedirs(cache, exist_ok=True)
    return cache


@dataclasses.dataclass
class Run:
    """What a job and the metric readers share."""
    cell: object
    seed: int
    device: object
    cache: str
    world: int = 1            # chips, one process each
    spans: object = None
    counts: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    kind: str = "cpu"         # torch.cuda.get_device_name
    prof_trace: object = None  # tracing.Trace of the traced part
    tail: dict = dataclasses.field(default_factory=dict)  # untraced part


def _gather(values: list, world: int) -> list:
    if world == 1:
        return [values]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, values)
    return out


def run_cell(cell, seed: int, seconds: int, trace: bool, device: str, *,
             root: str, rank: int = 0, world: int = 1, port: int = 0,
             t0: float = T0) -> dict | None:
    """Set up, measure, check; returns the result (rank 0) or None. The
    set-up's parts and the window's laps go to standard error."""
    import torch

    from benchmark import manifest, tracing

    err = sys.stderr
    cache = cache_env(root)
    dev = torch.device(device)
    print(f"setup start_s {time.time() - t0}", file=err, flush=True)
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    print(f"setup device_init_s {time.perf_counter() - t}", file=err,
          flush=True)
    if world > 1:
        from eov_tpu_torch.parallel import distributed as pdist

        pdist.initialize("nccl" if dev.type == "cuda" else "gloo",
                         init_method=f"tcp://localhost:{port}",
                         world_size=world, rank=rank, device=dev)
    run = Run(cell, seed, dev, cache, world, tracing.Spans())
    run.kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    job = manifest.job_module(cell.job).Job(run)
    parts = job.setup()
    for k, v in (parts or {}).items():
        print(f"setup {k} {v}", file=err, flush=True)
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t0
    prof = None
    if trace:
        prof = tracing.Profiler(os.path.join(cache, "trace",
                                             f"rank{rank}.json"), dev)
        prof.start()
    run.spans.reset()
    e2e = job.window(seconds, prof)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    laps = run.counts.get("laps", [])
    laps = [round(b - a, 4) for a, b in zip([0.0] + laps, laps)]
    print(f"window laps_s {laps} load {os.getloadavg()} cpus "
          f"{os.cpu_count()}", file=err, flush=True)
    for k, v in run.counts.get("lap_notes", {}).items():
        print(f"window lap_{k} {v}", file=err, flush=True)
    if prof is not None:
        run.prof_trace = prof.export()
    busy = run.prof_trace.busy_s if trace else None
    tw = run.prof_trace.window_s if trace else None
    gathered = _gather([peak, busy, tw], world)
    job.release()
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return None
    checks = job.check()
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct,
              "attempted": int(run.counts.get("attempted", 0)),
              "failed": int(run.counts.get("failed", 0))}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise RuntimeError(f"the {cell.job} job reports no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": run.kind, "count": world,
        "memory_peak_bytes": int(max(g[0] for g in gathered))}
    if trace:
        result["device"]["busy_s"] = (sum(g[1] for g in gathered)
                                      / len(gathered))
        result["device"]["window_s"] = max(g[2] for g in gathered)
        tr = run.prof_trace
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps(job.main_tid(tr))]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args, cell, root: str) -> int:
    """One process per chip; rank 0's result and its last standard error
    lines are printed here once every rank has ended."""
    import signal

    # A terminated launcher still stops its ranks (the ``finally`` below).
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cache = cache_env(root)
    port = _free_port()
    logs = os.path.join(cache, "ranks")
    os.makedirs(logs, exist_ok=True)
    procs, files = [], []
    for r in range(cell.chips):
        o = open(os.path.join(logs, f"rank{r}.out"), "w")
        e = open(os.path.join(logs, f"rank{r}.err"), "w")
        files.append((o, e))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "benchmark.run", "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace), "--rank", str(r),
             "--world", str(cell.chips), "--port", str(port), "--t0",
             repr(T0)], stdout=o, stderr=e, cwd=root))
    failed = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                failed = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for o, e in files:
            o.close()
            e.close()
    codes = [p.returncode for p in procs]
    for r in range(cell.chips):
        with open(os.path.join(logs, f"rank{r}.err")) as f:
            text = f.read()
        if r != 0 and (failed or codes[r]):
            sys.stderr.write(f"--- rank {r} (exit {codes[r]})\n{text[-4000:]}")
    with open(os.path.join(logs, "rank0.err")) as f:
        sys.stderr.write(f.read())
    if failed or any(codes):
        print(f"ranks exited {codes}", file=sys.stderr)
        return 1
    with open(os.path.join(logs, "rank0.out")) as f:
        lines = f.read().strip().splitlines()
    bad = forbidden_loaded()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 1
    print(lines[-1], flush=True)
    return 0


def _print(result: dict) -> None:
    """The numbers compared, each beside its limit, last on stderr."""
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=T0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cache_env(root)
    from benchmark import manifest

    cell = manifest.load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {n}", file=sys.stderr)
        return 2
    if args.rank is None and cell.chips > 1:
        from benchmark import data

        data.shard_set(cache_env(root), cell.traffic["data"])
        return _spawn(args, cell, root)
    rank = args.rank or 0
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      f"cuda:{rank}", root=root, rank=rank,
                      world=args.world, port=args.port, t0=args.t0)
    bad = forbidden_loaded()  # every rank: the launcher reads their codes
    if bad:
        print(f"rank {rank}: loaded after the window: {bad}",
              file=sys.stderr)
        return 1
    if result is None:
        return 0
    _print(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
