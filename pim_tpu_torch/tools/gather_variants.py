"""Device time of the gather kernels' variants, on a CUDA device.

    python -m pim_tpu_torch.tools.gather_variants [--out FILE]

For K3 (column gather) and K7 (texel gather) at the main path's table
shapes, 262,144 lanes, on seeded random indices (-1 and T among them) and
on the same indices sorted (coherent, as sorted hits give them), it launches
each variant the kernels have through the library's C interface, 32-bit and
64-bit offsets alike, holds every output bit for bit against the plain
version, and times each call two ways in the same process:

  - `queued`: DEVICE_RUNS back-to-back calls queued behind a GPU sleep
    between two CUDA events, so the device runs them without waiting on
    the host; BATCHES timings in the order 32, 64, 64, 32, ... bit;
  - `profiler`: torch.profiler over DEVICE_RUNS calls, the self device time
    of the kernels they launched over DEVICE_RUNS (a trace that lost its
    device activity is taken again).

`torch.index_select` on the clipped indices is timed both ways beside them.
It prints one line per variant and, with `--out`, writes every number as
JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from pim_tpu_torch.tools import devtime

N = 262_144
DEVICE_RUNS = 25
BATCHES = 4
PROFILER_TRIES = 5
# (name, kernel, [F or C, T], K): the main path's tables
CASES = (
    ("K3 cornell tri", "k3", (48, 108), 1),
    ("K3 e1m1 tri", "k3", (48, 81552), 1),
    ("K3 e1m1 light", "k3", (98, 867), 1),
    ("K7 atlas", "k7", (4, 32768), 12),
    ("K7 sky", "k7", (3, 6144), 4),
)


def queued_ms(fn) -> float:
    """Device ms a call: DEVICE_RUNS calls queued behind a GPU sleep
    (`devtime.queued_ms`)."""
    fn()
    torch.cuda.synchronize()
    ms, ahead = devtime.queued_ms(fn, DEVICE_RUNS)
    if not ahead:
        raise RuntimeError("the device reached the calls before the host had queued them")
    return ms


def profiler_ms(fn) -> float:
    """Device ms a call: the self device time of the kernels of DEVICE_RUNS
    calls in one trace."""
    from pim_tpu_torch.tools.perf_table import _device_ms, _is_kernel

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(DEVICE_RUNS):
                fn()
            torch.cuda.synchronize()
        ms = sum(_device_ms(e) for e in prof.key_averages() if _is_kernel(e))
        if ms > 0.0:
            return ms / DEVICE_RUNS
    raise RuntimeError(f"{PROFILER_TRIES} traces in a row held no device time")


def launcher(lib, kind, form, table, idx, out, wide: bool, vec: bool = True):
    """fn() launching one variant of K3 (`kind` "k3"; `form` "staged",
    "direct" or "rows", the last on gather_kernel.table_rows(table)) or K7
    ("k7"; "staged" or "direct") on `table` and `idx` into `out`, with
    64-bit offsets if `wide` and on the vector path if `vec` (which needs a
    lane count that is a multiple of 4 and 16-byte aligned indices)."""
    from pim_tpu_torch import native
    from pim_tpu_torch.render.gather_kernel import table_rows

    s = native.stream_ptr(table.device)
    a, t = table.shape
    n = idx.numel()
    i32 = idx.dtype == torch.int32
    if kind == "k3" and form == "rows":
        rows = table_rows(table)
        fn = lib.pim_gather_cols_rows_i32 if i32 else lib.pim_gather_cols_rows_i64
        return lambda: native.check(lib, fn(rows.data_ptr(), a, t, idx.data_ptr(), n,
                                            out.data_ptr(), wide, vec, s), "rows")
    staged = form == "staged"
    if kind == "k3":
        fn = lib.pim_gather_cols_i32 if i32 else lib.pim_gather_cols_i64
    else:
        fn = lib.pim_gather_texels
    return lambda: native.check(lib, fn(table.data_ptr(), a, t, idx.data_ptr(), n,
                                        out.data_ptr(), staged, wide, vec, s), form)


def main(argv=None) -> None:
    from pim_tpu_torch import native
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import table_gather as tg

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for every number")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_variants: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda)
    lib = native.load()
    gen = torch.Generator(device="cpu").manual_seed(2024)
    results = []
    for name, kind, (a, t), k in CASES:
        table = torch.randn((a, t), generator=gen).to(dev)
        rand = torch.randint(-1, t + 1, (k, N), generator=gen, dtype=torch.int32)
        rand[0, :2] = torch.tensor([-1, t], dtype=torch.int32)
        staged = a * t * 4 <= gk.STAGE_MAX_BYTES
        forms = ["staged" if staged else "direct"]
        if kind == "k3" and not staged and a % 4 == 0:
            forms.append("rows")
        for pattern, ix in (("random", rand), ("sorted", torch.sort(rand, dim=1).values)):
            idx = (ix[0] if kind == "k3" else ix).contiguous().to(dev)
            if kind == "k3":
                plain = gk.gather_cols_plain(table, idx)
                lib_in = idx.clamp(0, t - 1).to(torch.int64)
            else:
                plain = tg.gather_texels_plain(table, idx)
                lib_in = idx.clamp(0, t - 1).to(torch.int64).reshape(-1)
            library = lambda: torch.index_select(table, 1, lib_in)  # noqa: E731
            lib_t = dict(queued=[queued_ms(library) for _ in range(BATCHES)],
                         profiler=profiler_ms(library))
            print(f"{name} {pattern} index_select: queued {statistics.median(lib_t['queued']):.4f} "
                  f"ms {lib_t['queued']}, profiler {lib_t['profiler']:.4f} ms")
            for form in forms:
                fns, times = {}, {0: [], 1: []}
                for wide in (0, 1):
                    out = torch.empty_like(plain)
                    fns[wide] = launcher(lib, kind, form, table, idx, out, bool(wide))
                    fns[wide]()
                    torch.cuda.synchronize()
                    if not torch.equal(out.view(torch.int32), plain.view(torch.int32)):
                        raise AssertionError(f"{name} {form} wide={wide} differs from plain")
                for b in range(BATCHES):
                    for wide in ((0, 1) if b % 2 == 0 else (1, 0)):
                        times[wide].append(queued_ms(fns[wide]))
                for wide in (0, 1):
                    prof = profiler_ms(fns[wide])
                    q = times[wide]
                    print(f"{name} {pattern} {form} {'64' if wide else '32'}-bit: bitwise_equal=True "
                          f"queued {statistics.median(q):.4f} ms [min {min(q):.4f}, max "
                          f"{max(q):.4f}], profiler {prof:.4f} ms")
                    results.append(dict(case=name, pattern=pattern, form=form, wide=wide,
                                        queued_ms=q, profiler_ms=prof,
                                        library_queued_ms=lib_t["queued"],
                                        library_profiler_ms=lib_t["profiler"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__, results=results), f, indent=1)


if __name__ == "__main__":
    main()
