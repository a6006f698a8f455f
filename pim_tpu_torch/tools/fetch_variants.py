"""K3-bwd, K6 and K7-bwd timed on seeded random inputs and on the e1m1 main
path's own calls, on a CUDA device.

    python -m pim_tpu_torch.tools.fetch_variants [--forms] [--out FILE]

Builds the e1m1 scene on the card and records, with
`fetch_check.recorded_calls`, the calls one 512^2, 10-bounce, 1-spp serving
step hands K6 (atlas and sky apart) and those one 512^2, 3-bounce training
step hands K3-bwd and K7-bwd.  Beside them it makes seeded random inputs at
the main path's shapes: K3-bwd on the [48, 81552] tri table (262,144
lanes, -1 and T among the indices) and on the [4, 208] material graft (the
tri table's 81,552 material ids); K6 on the atlas (2 x 262,144 queries,
C = 4) and the sky (262,144, C = 3), a fifth of them invalid.  On each it
holds the wrapper against its plain version (K6 bit for bit; K3-bwd and
K7-bwd within gamma(adds - 1) * sum |g| of a float64 plain sum) and times the
wrapper and one PyTorch call that computes the same function (`index_add_`,
`embedding_bag`): device ms a call, DEVICE_RUNS calls queued behind a GPU
sleep, the median of BATCHES.  With `--forms` it also launches every form
of K3-bwd and K7-bwd through the library's C interface, checks each the
same way and times it.  K7-bwd also runs on seeded random indices: the
atlas ([4, 12, 262144] into the [4, 32768] planes) and the sky ([3, 4,
262144] into 6,144 texels), -1 and T among them.

It drives only the package's wrappers and plain versions, so it also times
an older tree of the package, for a comparison of two trees in turns in one
run on the card: run it as a file with that tree first on the path (no
`--forms` there),

    PYTHONPATH=OLD_TREE python pim_tpu_torch/tools/fetch_variants.py

It loads tools/fetch_check.py from beside this file, whichever tree of the
package that file's helpers then import.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import time

import torch

N = 262_144
DEVICE_RUNS = 25
BATCHES = 3
QUEUE_CYCLES = 40_000_000
SEED = 606


def _fetch_check():
    """tools/fetch_check.py of this file's tree, loaded by its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fetch_check.py")
    spec = importlib.util.spec_from_file_location("fetch_check", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def queued_ms(fn, batches: int = BATCHES) -> list:
    """Device ms a call, `batches` times, sorted: DEVICE_RUNS calls queued
    behind a GPU sleep between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        for _ in range(DEVICE_RUNS):
            fn()
        end.record()
        if start.query():
            raise RuntimeError("the device reached the calls before the host had queued them")
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / DEVICE_RUNS)
    return sorted(out)


def bwd_forms(f: int, t: int):
    """(name, form, vec) of every K3-bwd form for a [f, t] sum: "staged"
    where it fits, "direct", and "rows" (the row-major sum) where F % 4 ==
    0 and the sum is not staged; the vector and the scalar path."""
    from pim_tpu_torch.render import gather_kernel as gk

    if f * t * 4 <= gk.STAGE_MAX_BYTES:
        forms = ("staged", "direct")
    else:
        forms = ("direct", "rows") if f % 4 == 0 else ("direct",)
    return [(f"{form} {'vec' if vec else 'scalar'}", form, vec) for form in forms
            for vec in (1, 0)]


def bwd_launcher(g, idx, t, form, vec, wide=0, clip=False):
    """(fn() launching one form of K3-bwd into a zeroed sum, fn() -> the
    [F, t] sum after it); 64-bit offsets with `wide`; K7-bwd with `clip`
    (g [C, K*N], idx [K*N] int32, every lane clipped into [0, t)).  The
    "rows" form sums into a row-major buffer, whose transposed view is the
    sum, as in the wrappers."""
    from pim_tpu_torch import native

    lib = native.load()
    f, n = g.shape
    s = native.stream_ptr(g.device)
    i32 = idx.dtype == torch.int32
    if form == "rows":
        buf = torch.zeros((t, f), dtype=torch.float32, device=g.device)
        fn = (lib.pim_gather_texels_bwd_rows if clip else
              lib.pim_gather_cols_bwd_rows_i32 if i32 else lib.pim_gather_cols_bwd_rows_i64)

        def run():
            buf.zero_()
            native.check(lib, fn(g.data_ptr(), f, t, idx.data_ptr(), n, buf.data_ptr(), wide,
                                 vec, s), "gather_cols_bwd_rows")
        return run, lambda: buf.T
    grad = torch.zeros((f, t), dtype=torch.float32, device=g.device)
    fn = (lib.pim_gather_texels_bwd if clip else
          lib.pim_gather_cols_bwd_i32 if i32 else lib.pim_gather_cols_bwd_i64)

    def run():
        grad.zero_()
        native.check(lib, fn(g.data_ptr(), f, t, idx.data_ptr(), n, grad.data_ptr(),
                             form == "staged", wide, vec, s), "gather_cols_bwd")
    return run, lambda: grad


def main(argv=None) -> None:
    from pim_tpu_torch.app import build_e1m1_scene
    from pim_tpu_torch.render import fetch as F
    from pim_tpu_torch.render import gather_kernel as gk
    from pim_tpu_torch.render import table_gather as tg

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", action="store_true",
                    help="time every form of K3-bwd and K7-bwd through the C interface")
    ap.add_argument("--out", default=None, help="JSON file for every number")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fetch_variants: no CUDA device is available")
    fc = _fetch_check()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, gk.__file__)
    t0 = time.perf_counter()
    scene = build_e1m1_scene(dev)
    torch.cuda.synchronize()
    meta, arrays, _ = scene
    serve = fc.serving_step_calls(scene)
    train = fc.training_step_calls(scene)
    torch.cuda.synchronize()
    print(f"e1m1 build and the two recorded steps: {time.perf_counter() - t0:.1f} s; K6 calls "
          f"atlas {len(serve['k6_atlas'])}, sky {len(serve['k6_sky'])}; K3-bwd calls "
          f"{len(train['k3_bwd'])}, K7-bwd calls {len(train['k7_bwd'])}")

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    tt = arrays.tri_table
    tri = torch.randint(-1, tt.shape[1] + 1, (N,), generator=gen, dtype=torch.int32)
    tri[:2] = torch.tensor([-1, tt.shape[1]], dtype=torch.int32)
    bwd_cases = [("random tri", torch.randn((48, N), generator=gen).to(dev), tri.to(dev),
                  tt.shape[1]),
                 ("random graft", torch.randn((4, tt.shape[1]), generator=gen).to(dev),
                  tt[F.MAT_ID].to(torch.int64), meta.mat_count)]
    bwd_cases += [(f"main {i}", *call) for i, call in enumerate(train["k3_bwd"])]
    k7_cases = []
    for label, planes, k in (("atlas", arrays.atlas_planes, 12),
                             ("sky", arrays.sky.reshape(-1, 3).T, 4)):
        c, t = planes.shape
        idx = torch.randint(0, t, (k, N), generator=gen, dtype=torch.int32)
        idx[0, :2] = torch.tensor([-1, t], dtype=torch.int32)
        k7_cases.append((f"random {label}", torch.randn((c, k, N), generator=gen).to(dev),
                         idx.to(dev), t))
    k7_cases += [(f"main {i}", *call) for i, call in enumerate(train["k7_bwd"])]
    k6_cases = []
    for label, planes, c, k in (("atlas", arrays.atlas_corners, 4, 2),
                                ("sky", arrays.sky_corners, 3, 1)):
        t = planes.shape[1]
        idx = torch.randint(0, t, (k, N), generator=gen, dtype=torch.int32)
        idx[0, :2] = torch.tensor([-1, t], dtype=torch.int32)
        tx, ty = torch.rand((k, N), generator=gen), torch.rand((k, N), generator=gen)
        valid = torch.rand((k, N), generator=gen) < 0.8
        tx[~valid] = float("nan")
        k6_cases.append((f"random {label}", planes, *(x.to(dev) for x in (idx, tx, ty, valid)),
                         c))
    for label in ("atlas", "sky"):
        k6_cases += [(f"main {label} {i}", *call)
                     for i, call in enumerate(serve[f"k6_{label}"])]

    result = {"device": smi, "torch": torch.__version__, "tree": gk.__file__, "k3_bwd": [],
              "k6": [], "k7_bwd": []}
    for label, g, idx, t in bwd_cases:
        out = gk.gather_cols_bwd(g, idx, t)
        ok, err, ratio = fc.scatter_error(out, gk.gather_cols_bwd_plain, g, idx, t)
        row = dict(case=label, shape=list(g.shape), t=t, within_bound=ok, max_abs_err=err,
                   err_over_bound=ratio, **fc.lane_counts(g, idx),
                   ms=queued_ms(lambda: gk.gather_cols_bwd(g, idx, t)),
                   library_ms=queued_ms(fc.index_add_call(g, idx, t)))
        print(f"K3-bwd {label} {tuple(g.shape)} -> [{g.shape[0]}, {t}]: within bound {ok} "
              f"(err/bound {ratio:.3e}); lanes {row['lanes']}, idx 0 {row['idx0']}, g 0 "
              f"{row['g0']}, both {row['idx0_g0']}; {statistics.median(row['ms']):.4f} ms "
              f"{row['ms']}, index_add_ {statistics.median(row['library_ms']):.4f}")
        if not ok:
            raise AssertionError(f"K3-bwd {label} leaves the bound")
        if args.forms:
            row["forms"] = {}
            for name, form, vec in bwd_forms(g.shape[0], t):
                if vec and (g.shape[1] % 4 or idx.data_ptr() % 16 or g.data_ptr() % 16):
                    continue
                run, grad = bwd_launcher(g, idx, t, form, vec)
                run()
                ok_f = fc.scatter_error(grad(), gk.gather_cols_bwd_plain, g, idx, t)[0]
                ms = queued_ms(run)
                row["forms"][name] = dict(within_bound=ok_f, ms=ms)
                print(f"  {name}: within bound {ok_f}; {statistics.median(ms):.4f} ms {ms}")
                if not ok_f:
                    raise AssertionError(f"K3-bwd {label} {name} leaves the bound")
        result["k3_bwd"].append(row)
    for label, g, idx, t in k7_cases:
        out = tg.gather_texels_bwd(g, idx, t)
        ok, err, ratio = fc.scatter_error(out, tg.gather_texels_bwd_plain, g, idx, t)
        row = dict(case=label, shape=list(g.shape), t=t, within_bound=ok, max_abs_err=err,
                   err_over_bound=ratio, **fc.lane_counts(g.reshape(g.shape[0], -1),
                                                          idx.clamp(0, t - 1).reshape(-1)),
                   ms=queued_ms(lambda: tg.gather_texels_bwd(g, idx, t)),
                   library_ms=queued_ms(fc.texel_index_add_call(g, idx, t)))
        print(f"K7-bwd {label} {tuple(g.shape)} -> [{g.shape[0]}, {t}]: within bound {ok} "
              f"(err/bound {ratio:.3e}); lanes {row['lanes']}, clipped to 0 {row['idx0']}, g 0 "
              f"{row['g0']}, both {row['idx0_g0']}; {statistics.median(row['ms']):.4f} ms "
              f"{row['ms']}, index_add_ {statistics.median(row['library_ms']):.4f}")
        if not ok:
            raise AssertionError(f"K7-bwd {label} leaves the bound")
        if args.forms:
            row["forms"] = {}
            g2, idx2 = g.reshape(g.shape[0], -1), idx.reshape(-1)
            for name, form, vec in bwd_forms(g.shape[0], t):
                if vec and (idx2.shape[0] % 4 or idx2.data_ptr() % 16 or g2.data_ptr() % 16):
                    continue
                run, grad = bwd_launcher(g2, idx2, t, form, vec, clip=True)
                run()
                ok_f = fc.scatter_error(grad(), tg.gather_texels_bwd_plain, g2, idx2, t)[0]
                ms = queued_ms(run)
                row["forms"][name] = dict(within_bound=ok_f, ms=ms)
                print(f"  {name}: within bound {ok_f}; {statistics.median(ms):.4f} ms {ms}")
                if not ok_f:
                    raise AssertionError(f"K7-bwd {label} {name} leaves the bound")
        result["k7_bwd"].append(row)
    for label, planes, idx, tx, ty, valid, c in k6_cases:
        out = tg.gather_bilinear(planes, idx, tx, ty, valid, c=c)
        plain = tg.gather_bilinear_plain(planes, idx, tx, ty, valid, c)
        same = torch.equal(out.view(torch.int32), plain.view(torch.int32))
        row = dict(case=label, shape=list(idx.shape), c=c, bitwise_equal=same,
                   ms=queued_ms(lambda: tg.gather_bilinear(planes, idx, tx, ty, valid, c=c)),
                   library_ms=queued_ms(fc.embedding_bag_call(planes, idx, tx, ty, valid, c)))
        print(f"K6 {label} {tuple(idx.shape)} C={c}: bitwise equal {same}; "
              f"{statistics.median(row['ms']):.4f} ms {row['ms']}, embedding_bag "
              f"{statistics.median(row['library_ms']):.4f}")
        if not same:
            raise AssertionError(f"K6 {label} differs from its plain version")
        result["k6"].append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
