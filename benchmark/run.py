"""The benchmark of ``tidy3d_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``, from the start of this process to the start
of the window): imports and CUDA, the simulation drawn from the seed, the
port's lowering under the card's mode-solver scope (``lower_s``), and a
warm-up solve of a tenth of the plan's steps, which loads every kernel
library (built into the checkout's ``build/kernels`` on a first run).

The window runs whole solves back to back, as ``web.run`` makes them after
lowering (runner, memory gate, time loop, monitor data, synchronize), and
starts none once ``--seconds`` have passed. ``gcell_steps_per_s`` is the
cells times the simulation's own steps of every solve over the window's
wall time; ``peak_mem_gib`` the card's peak allocation in it. With
``--trace 1`` the first solve of the window runs under ``torch.profiler``
and the per-layer metrics are reported instead.

After the window, with the solver's state freed, the plain reference
(``benchmark/reference``) solves the same simulation on the card and every
solve's monitor data is held to it (``harness/compare.py``). The last line
of standard output is the result as one JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tidy3d_tpu")


def _environment():
    """Caches inside the checkout, at fixed paths; no JAX behind a
    library's back."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None, device=None) -> int:
    """One run; returns the exit code. ``device``: tests pass the CPU here
    to drive a run without the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import numpy as np
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import compare, program, work

    c = cells.load(args.workload)
    chips = int(c["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"benchmark: needs {chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda:0")
        torch.cuda.init()
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tidy3d_tpu_torch as td

    params = cells.draw(c["config"], c["mix"], args.seed)
    pb = c["module"].problem(params)
    spans = program.Spans()
    with spans("lower"):
        sim = c["module"].simulation(td, params)
        plan = program.lower(sim, device)
    lower_s = spans.last("lower")
    with spans("warm_up"):
        program.warm_up(sim, plan, device, spans)
    gc.collect()
    cells_steps = int(np.prod(plan.shape)) * int(plan.num_steps)

    # the window
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                   else ProfilerActivity.CPU])
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    t_w0 = time.perf_counter()
    results, failed, assemble_s, tier = [], 0, [], None
    counts0 = counts1 = None
    while not results or time.perf_counter() - t_w0 < args.seconds:
        traced = prof is not None and not results
        if traced:
            counts0 = program.counters()
            prof.start()
        try:
            with spans("window") if traced else contextlib.nullcontext():
                data, tier, k = program.solve(sim, plan, device, spans)
        except Exception as exc:  # a solve that fails counts as failed
            print(f"benchmark: solve {len(results)} failed: {exc!r}",
                  file=sys.stderr)
            failed += 1
            results.append(None)
            if traced:
                prof.stop()
            break
        if traced:
            prof.stop()
            counts1 = program.counters()
        assemble_s.append(spans.last("assemble"))
        results.append(program.outputs(data, pb))
        del data
    t_w1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    window = t_w1 - t_w0
    solves = len(results)
    print(f"benchmark: {args.workload} seed {args.seed}: tier {tier}, "
          f"{solves} solves in {window:.3f} s, drawn {params['drawn']}",
          file=sys.stderr)
    names = ("runner_init", "run", "assemble")
    per = {n: [t1 - t0 for m, t0, t1 in spans.done if m == n] for n in names}
    print("benchmark: set-up " + ", ".join(
        f"{n} {spans.last(n):.3f} s" for n in ("lower", "warm_up"))
        + f", before lowering {spans.done[0][1] - T0:.3f} s; per solve "
        + "; ".join(f"{n} " + " ".join(f"{v:.3f}" for v in per[n][1:])
                    for n in names), file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4

    metrics, device_info, breakdown = {}, {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": chips, "memory_peak_bytes": int(peak)}, None
    if not args.trace:
        values = {"gcell_steps_per_s": (solves - failed) * cells_steps
                  / window / 1e9,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from benchmark.harness.trace import Trace

        tr = Trace(prof, spans.wall) if counts1 is not None else None
        ctx = {"lower_s": lower_s, "assemble_s": assemble_s, "trace": tr,
               "k": k, "steps": int(plan.num_steps),
               "work": work.describe(pb), "kernels": {}, "peaks": None}
        peaks = json.loads((BENCH / "peaks.json").read_text())
        ctx["peaks"] = peaks.get(device_info["kind"])
        launches_ok = tr is not None
        if tr is not None:
            for key, (_, needles) in program.KERNELS.items():
                calls = counts1[key][0] - counts0[key][0]
                dev = counts1[key][1] - counts0[key][1]
                names = tr.kernel_names(*needles)
                seen = tr.launches(names)
                ok = seen >= dev
                launches_ok &= ok
                ctx["kernels"][key] = {"calls": calls, "names": names,
                                       "ok": ok,
                                       "seconds": tr.kernel_s(names)}
                if calls:
                    print(f"benchmark: {key}: {calls} calls, {dev} launches "
                          f"counted, {seen} traced", file=sys.stderr)
            print(f"benchmark: trace: {tr.alignment()}", file=sys.stderr)
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(),
                         "idle_gaps": tr.idle_gaps()}
        ctx["launches_ok"] = launches_ok
        for m in c["per_layer"]:
            v = _reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            else:
                print(f"benchmark: {m['name']}: not measured",
                      file=sys.stderr)
        del prof, tr, ctx

    # the check: the plain reference on the card, the solver's state freed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from benchmark.reference import yee

    t_r = time.perf_counter()
    ref = yee.solve(pb, device)
    ref_s = time.perf_counter() - t_r
    per_solve = [compare.gaps(r, ref, pb) for r in results if r is not None]
    numbers = compare.worst(per_solve)
    limits = c["config"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and bool(checks) and all(
        ch["value"] <= ch["limit"] for ch in checks.values())
    print(f"benchmark: reference solve {ref_s:.1f} s", file=sys.stderr)

    out = {"correct": correct, "attempted": solves, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, ch in checks.items():
        print(f"check {name} {ch['value']:.6e} limit {ch['limit']:.6e}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
