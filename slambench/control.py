"""Readings for the limits of the correctness check, on the card.

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

In one process, for each seed, one drive session of the cell at its own
size through the program as the configuration states it (a sound
reading), and for each control seed one through the control (``broken``):
the program handed the settings with the stereo rig's ``Camera.bf``
``CONTROL_BF_SCALE`` of what they state, while the route is rendered with
the rig as stated and the check holds the answers to it.  One JSON line a
session.  Used to set ``limits/<cell>.json``; the benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import run

# the control: a metric depth scale 5% short, the guarantee the settings
# state (a calibrated rig) broken
CONTROL_BF_SCALE = 0.95


def broken(cfg):
    """The configuration the control hands the program."""
    return dataclasses.replace(
        cfg, camera=dataclasses.replace(cfg.camera, bf=cfg.camera.bf * CONTROL_BF_SCALE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    run.set_environment()
    import torch
    import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.resolve_cell(bench, args.workload)
    device = torch.device("cuda", 0)

    jobs = [("sound", int(s), None) for s in args.seeds.split(",") if s] \
        + [("control", int(s), broken) for s in args.control_seeds.split(",") if s]
    for kind, seed, program_cfg in jobs:
        t0 = time.perf_counter()
        line, err = run.measure(bench, cell, seed, 1e-3, False, device,
                                program_cfg=program_cfg)
        side = json.loads(err[0][len("slambench: "):])
        print(json.dumps(dict(cell=cell.name, kind=kind, seed=seed, values=side["values"],
                              keyframes=side["keyframes"], events=side["events"],
                              correct=line["correct"], wall_s=time.perf_counter() - t0)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
