"""Time what a fresh Python process of the port pays before its work.

    python -m d3net_tpu_torch.scripts.process_start [--reps 2] [--cache DIR]
        [--cpu]

Each step runs in a new interpreter, ``--reps`` times in turn: the bare
interpreter, ``import torch``, torch with a CUDA context (left out with
``--cpu``; without a GPU and without ``--cpu`` it raises), the port's
``checks`` module (what ``chip_smoke.py``'s curriculum hook imports) and
``scripts.train --help``. With ``--cache`` every process
shares that bytecode cache (``PYTHONPYCACHEPREFIX``): the first process to
import a module writes its bytecode there, so later ones read instead of
compiling; without it, each process reads the installation's own
``__pycache__`` where there is one. Prints one JSON line: the wall seconds
of each step's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

STEPS = {
    "bare": ["-c", "pass"],
    "import_torch": ["-c", "import torch"],
    "torch_cuda_init": ["-c", "import torch; torch.zeros(1, device='cuda'); "
                              "torch.cuda.synchronize()"],
    "import_checks": ["-c", "from d3net_tpu_torch import checks"],
    "train_help": ["-m", "d3net_tpu_torch.scripts.train", "--help"],
}


def time_starts(reps: int = 2, cache: Optional[str] = None,
                cuda: bool = True) -> Dict[str, List[float]]:
    """Wall seconds of each step's ``reps`` runs (``torch_cuda_init`` only
    with ``cuda``); a run that exits non-zero raises."""
    env = dict(os.environ)
    if cache:
        env["PYTHONPYCACHEPREFIX"] = cache
        env.pop("PYTHONDONTWRITEBYTECODE", None)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    out: Dict[str, List[float]] = {k: [] for k in STEPS
                                   if cuda or k != "torch_cuda_init"}
    for _ in range(reps):
        for name in out:
            t0 = time.time()
            res = subprocess.run([sys.executable, *STEPS[name]], env=env,
                                 capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"{name}: exit {res.returncode}\n"
                                   f"{res.stderr[-2000:]}")
            out[name].append(round(time.time() - t0, 3))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache", default=None,
                    help="a bytecode cache directory the processes share")
    ap.add_argument("--cpu", action="store_true",
                    help="leave out the CUDA context's start")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("process_start: no CUDA device; pass --cpu to "
                           "time the starts without a CUDA context")
    res = time_starts(args.reps, args.cache, not args.cpu)
    print(json.dumps({"reps": args.reps, "cache": bool(args.cache),
                      "seconds": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
