"""How often a process's first vector-math call comes out wrong on the CPU.

    python -m pim_tpu_torch.tools.vml_first_call [--procs 320] [--jobs 12]

Torch's CPU build computes float exp, sqrt and the like through MKL's VML.
This starts `--procs` fresh Python processes, `--jobs` at a time, in each
of two modes.  Each process sets two torch threads and makes its first VML
call on 4,096 float32 values, which torch splits into two chunks of 2,048
on two threads: `torch.exp`, then `torch.sqrt`, each held against numpy in
float64.  Mode `bare` imports torch alone; mode `port` imports
`pim_tpu_torch` first, whose import makes one single-element call.  For
each mode it prints the processes in which some value was off by more than
1e-6 relative, the largest such error, and on which chunk the bad values
lay.  CPU only; about a minute for 320 processes a mode on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = r"""
import json, sys
import numpy as np
if sys.argv[1] == "port":
    import pim_tpu_torch  # noqa: F401
import torch
torch.set_num_threads(2)
u = np.random.default_rng(1).random(4096, dtype=np.float32)
x = torch.from_numpy(u.copy())
res = {}
for name, fn, ref in (("exp", torch.exp, np.exp), ("sqrt", torch.sqrt, np.sqrt)):
    want = ref(u.astype(np.float64))
    rel = np.abs(fn(x).numpy().astype(np.float64) - want) / np.abs(want)
    bad = np.nonzero(rel > 1e-6)[0]
    res[name] = [int(bad.size), float(rel.max()), int((bad < 2048).sum())]
print(json.dumps(res))
"""


def _one(mode: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _CHILD, mode], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=320)
    ap.add_argument("--jobs", type=int, default=12)
    args = ap.parse_args()
    for mode in ("bare", "port"):
        with ThreadPoolExecutor(args.jobs) as pool:
            runs = list(pool.map(_one, [mode] * args.procs))
        for name in ("exp", "sqrt"):
            bad = [r[name] for r in runs if r[name][0] > 0]
            worst = max((b[1] for b in bad), default=0.0)
            first_chunk = sum(b[2] for b in bad)
            print(f"{mode} {name}: {len(bad)} of {args.procs} processes with values off by more "
                  f"than 1e-6 relative (largest {worst:.3e}; {sum(b[0] for b in bad)} values, "
                  f"{first_chunk} of them in the caller's chunk)")


if __name__ == "__main__":
    main()
