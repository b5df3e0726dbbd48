"""Readings that set a cell's correctness limits, many seeds in one
process (set-up is long, and training's readings need no window):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1-12 \
        [--control-seeds 1-3] [--fault-seeds 1-3] [--out <file.jsonl>]

For each seed it sets the cell up as a run does (the program's first
steps through the window's call and feed), then runs the reference and
prints the numbers compared, one JSON line a reading:

- ``program``: the program against the reference (sets the lower end);
- ``control``: the reference in the program's place, computed in the
  type below the configuration's (``control_dtype`` of the configuration
  file), against the reference (sets the upper end);
- ``fault.<name>``: the reference in the program's place with a planted
  fault (``--faults``, e.g. ``half_batch``: each step on the first half
  of its batch, the mean over the rest);
- ``witness.*`` (``--witness-seeds``, cells whose driver has
  ``witness()``): the frozen model in the configuration's own type
  against the reference, the program against it, and two such runs
  against each other.

Each seed's program runs one unit of its window before it is judged (an
eval cell's answers come from its window).

The benchmark's own runs do not run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT, "perfbench", ".cache", "pycache")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seeds(text):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv):
    import argparse
    import json
    import time

    import torch

    from perfbench.harness.bench import Run
    from perfbench.harness.names import driver_module, load_cell

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="half_batch")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    control = cell.config["control_dtype"]
    ctl, flt = set(seeds(a.control_seeds)), set(seeds(a.fault_seeds))
    wit = set(seeds(a.witness_seeds))
    every = sorted(set(seeds(a.seeds)) | ctl | flt | wit)
    sink = open(a.out, "a") if a.out else None
    for s in every:
        t = time.perf_counter()
        drv = driver_module(cell.driver).Driver(
            Run(cell, s, 0.0, False, dev))
        setup = time.perf_counter() - t
        drv.unit()
        drv.release()
        kinds = []
        if s in set(seeds(a.seeds)):
            kinds.append(("program", {}))
        if s in ctl:
            kinds.append(("control", {"control": control}))
        if s in flt:
            kinds += [(f"fault.{f}", {"fault": f})
                      for f in a.faults.split(",") if f]
        readings = [(kind, lambda kw=kw: drv.check(**kw))
                    for kind, kw in kinds]
        if s in wit:
            readings.append(("witness", drv.witness))
        for kind, read in readings:
            t = time.perf_counter()
            got = read()
            many = got if kind == "witness" else {kind: got}
            for k, nums in many.items():
                line = {"cell": cell.name, "seed": s, "kind": k,
                        "numbers": nums, "setup_s": setup,
                        "detail": getattr(drv, "last_detail", None),
                        "check_s": time.perf_counter() - t,
                        "kind_of_card": torch.cuda.get_device_name(dev)}
                print(json.dumps(line), flush=True)
                if sink:
                    sink.write(json.dumps(line) + "\n")
                    sink.flush()
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
