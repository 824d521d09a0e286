"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``.  The cell, its
configuration, traffic, limits and metrics are found by the names in
``BENCHMARK.json``: ``portbench/configs/<config>.json`` (its ``entry``,
``portbench/entries/<entry>.py``, the code that drives the program, and its
``reference``, ``portbench/reference/<reference>.py``),
``portbench/traffic/<traffic>.json`` (its ``family``,
``portbench/families/<family>.py``), ``portbench/limits/<workload>.json``
and ``portbench/metrics/<metric>.py`` (or, for a metric ``a.b`` without a
file of its own, ``portbench/metrics/a.py``).

Set-up (process start to the first timed run) imports, loads or builds the
kernels, compiles the cell's plan and runs it once.  The window then sends
the request again and again, one caller in a closed loop, until ``--seconds``
have passed, and ends with the run in flight.  With ``--trace 1`` the window
runs under ``torch.profiler`` and the line carries the per-layer metrics;
with ``--trace 0`` the end-to-end ones.  Once the window has closed and the
memory peak is read, the program's state is freed and the plain reference
judges the outputs: each number compared is printed beside its limit, last
on standard error and last in the line.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# one process, one host thread: the program's host work (numpy, PyTorch's
# CPU operations) runs alike in every run
os.environ.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                  MKL_NUM_THREADS="1")

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qbot_tpu")
SPANS = ("lower", "compile", "run", "readout", "ensemble_run")
WINDOW = "window"


class Refused(Exception):
    """The run cannot give a result: it prints none and exits nonzero."""


@dataclass
class Record:
    """What a run measured; the metric readers read it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    runs: int = 0
    run_s: list = field(default_factory=list)    # host seconds of each run
    work: dict = field(default_factory=dict)     # unit -> done in window
    peak_bytes: int = 0
    parts: dict = field(default_factory=dict)    # set-up seconds by layer
    launches: dict = field(default_factory=dict)  # kernel -> launches
    bound_s: float | None = None                 # least seconds of a run
    trace: object = None                         # trace.Summary


class Span:
    """A harness span: a ``torch.profiler.record_function`` range with its
    host seconds."""

    def __init__(self, name: str):
        import torch

        self.fn = torch.profiler.record_function(name)
        self.seconds = 0.0

    def __enter__(self):
        self.fn.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return self.fn.__exit__(*exc)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, else the reader of the name's first part
    (``device_idle.ens`` is read by ``metrics/device_idle.py``)."""
    path = PKG / "metrics" / f"{name}.py"
    if path.is_file():
        return path
    return PKG / "metrics" / f"{name.split('.')[0]}.py"


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", reader_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(manifest: dict, workload: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries the cell reports: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    metric lists its cells."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m for m in manifest["per_layer"] if workload in m["workloads"]]
    return e2e, layer


def load_cell(root: Path, workload: str) -> dict:
    """Everything the cell's names lead to, as plain data."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    e2e, layer = cell_metrics(manifest, workload)
    return {"cell": cell, "config": config,
            "traffic": load_json(PKG / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(PKG / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": layer}


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} present")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_quartiles(run_s: list) -> str:
    """The least, the quartiles and the most of the runs' seconds."""
    import statistics

    if len(run_s) < 2:
        return " ".join(f"{t:.4f}" for t in run_s)
    q = statistics.quantiles(run_s, n=4)
    return " ".join(f"{t:.4f}" for t in (min(run_s), *q, max(run_s)))


def measure(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """One run of the cell ``spec`` (:func:`load_cell`) on ``device``:
    set-up, the window, the judgement.  Returns the result line's object
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, maybe
    ``breakdown``, then ``checks``)."""
    import torch

    from portbench import generator

    config, limits = spec["config"], spec["limits"]
    request = generator.make_request(config, spec["traffic"], seed)
    entry_mod = importlib.import_module(f"portbench.entries.{config['entry']}")
    from qbot_tpu_torch.tpu import kernels

    rec = Record()
    on_card = torch.device(device).type == "cuda"
    torch.set_num_threads(1)
    t_ready = time.perf_counter()
    entry = entry_mod.Entry(config, request, device, Span)
    entry.setup(rec.parts)
    if on_card:
        torch.cuda.synchronize()
    rec.setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {rec.setup_s:.3f} s: imports and request "
          f"{t_ready - t_start:.3f} s, then the program's "
          f"{ {k: round(v, 3) for k, v in rec.parts.items()} } and its "
          f"warm-up", file=sys.stderr)

    before = kernels.launch_counts()
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    with Span(WINDOW):
        t0 = t_run = time.perf_counter()
        while True:
            entry.run()
            rec.runs += 1
            t = time.perf_counter()
            rec.run_s.append(t - t_run)
            t_run = t
            if t - t0 >= seconds:
                break
        rec.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    after = kernels.launch_counts()
    rec.launches = {k: after[k] - before.get(k, 0) for k in after}
    rec.work = {unit: n * rec.runs for unit, n in request.per_run.items()}
    rec.bound_s = entry.bound_s()
    if on_card:
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules loaded in the measured process: {bad}")

    summary = None
    if prof is not None:
        from portbench import trace as tr

        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "trace.json")
            prof.export_chrome_trace(path)
            del prof
            summary = tr.read(path, WINDOW, SPANS)
        if on_card and not summary.busy_s > 0:
            raise Refused("the trace shows no device activity in the window")
        rec.trace = summary

    outputs = entry.outputs()
    del entry
    if on_card:
        torch.cuda.empty_cache()
    reference = importlib.import_module(
        f"portbench.reference.{config['reference']}")
    t_judge = time.perf_counter()
    readings = reference.judge(request, outputs, device)
    del outputs
    print(f"portbench: set-up {rec.setup_s:.3f} s, {rec.runs} runs in "
          f"{rec.window_s:.3f} s, judged in "
          f"{time.perf_counter() - t_judge:.3f} s; a run's seconds: "
          f"{run_quartiles(rec.run_s)}", file=sys.stderr)
    if set(readings) != set(limits):
        raise Refused(f"readings {sorted(readings)} against limits "
                      f"{sorted(limits)}")
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in sorted(readings)}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = load_reader(m["name"])(rec)
        if value is None:
            if on_card and not trace:
                raise Refused(f"no reading of {m['name']} in this cell")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": spec["cell"]["chips"], "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": correct, "attempted": rec.runs,
              "failed": 0 if correct else rec.runs, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        spec = load_cell(Path.cwd(), args.workload)
        check_card(spec["cell"]["chips"])
        result = measure(spec, args.seed % 2 ** 64, args.seconds,
                         bool(args.trace), "cuda", T_START)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
