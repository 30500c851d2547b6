"""The port's benchmark: one run of one cell on one card.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, the settings, the vocabulary, one drive session's route
rendered on the card from ``--seed``, one warm session), then drive
sessions back to back for ``--seconds``, then the session in progress is
finished and what the window produced is checked against the plain
reference (``reference/``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` / ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
also the last lines of standard error.

Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``pyorbslam_tpu`` has been loaded by the end of the window.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".slambench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "pyorbslam_tpu")


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; one
    host thread for the math libraries (the program's host side is one
    Python thread issuing launches: spinning worker threads only take
    cores from it); the checkout and this folder on the import path."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(bench: dict, cell, record) -> dict:
    import harness
    out = {}
    units = {m["name"]: m["unit"] for m in bench["per_layer"]}
    for name in cell.metrics:
        value = harness.load_module("metrics", name).read(record)
        if value is not None:
            out[name] = {"value": float(value), "unit": units[name]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    import torch
    import harness

    cell = harness.resolve_cell(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line, err = measure(bench, cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), chips)
    found = forbidden_modules()
    if found:
        print(f"slambench: loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("\n".join(err), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def measure(bench: dict, cell, seed: int, seconds: float, traced: bool, device,
            chips: int = 1, **run_kwargs):
    """One run past the look for a card: (the result line, the standard
    error lines).  ``run_kwargs`` go to ``harness.run`` (tests)."""
    import torch
    import harness
    from reference import check

    res = harness.run(cell, seed, seconds, traced, device, **run_kwargs)
    win = res["window"]
    if traced:
        metrics = per_layer(bench, cell, res["record"])
    else:
        metrics = {"fps": {"value": win["fps"], "unit": "frames/s"},
                   "frame_latency_p90_ms": {"value": win["frame_latency_p90_ms"], "unit": "ms"},
                   "setup_s": {"value": res["setup_s"], "unit": "s"}}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": res["peak"]}
    trace = res["record"]["trace"]
    if traced and trace:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])

    settings = check.read_settings(cell.settings_path)
    settings.update({k: v for k, v in (run_kwargs.get("overrides") or {})
                     .get("camera", {}).items() if k == "bf"})
    values = check.numbers(res["sessions"], res["route"], settings, seed, device)
    limits = harness.load_json("limits", cell.name + ".json")
    correct, rows = check.judge(values, limits)

    side = {"setup_parts_s": res["setup_parts"],
            "frames_handed": win["frames_handed"], "frames_done": win["frames_done"],
            "latency_median_ms": win["latency_median_ms"], "sessions": len(res["sessions"]),
            "keyframes": [s["n_keyframes_made"] for s in res["sessions"]],
            "events": sorted({e for s in res["sessions"] for e in s["events"]}),
            "ba_counters": res["sessions"][-1]["counters"],
            "loops": [[s["loops_closed"], s["loops_rejected"], s["loops_fused"]]
                      for s in res["sessions"]],
            "false_loops": [check.false_loops(s, res["route"].poses_wc) for s in res["sessions"]],
            "loop_chi2": [s["loop_chi2"] for s in res["sessions"]],
            "loop_stage_s": {k: sum(s["loop_times"].get(k, 0.0) for s in res["sessions"])
                             for k in sorted({k for s in res["sessions"] for k in s["loop_times"]})},
            "values": values}
    if traced and trace:
        side["trace_pace_ms"] = trace["pace_ms"]
        # the frames whose calls the program-span metrics read
        side["clock_frames"] = res["record"]["times_frames"]
    err = ["slambench: " + json.dumps(side, default=float)]
    line = {"correct": bool(correct), "attempted": win["frames_handed"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if traced and trace:
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    # a number that is not finite (a lost session) reads null: the line
    # stays JSON, and `correct` is already false
    line["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim}
                      for name, v, lim in rows}
    err += [f"check {name} {v!r} limit {lim!r}" for name, v, lim in rows]
    return line, err


if __name__ == "__main__":
    sys.exit(main())
