"""Run one cell of the benchmark on the card this process starts on.

    python3 nbbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and ``checks`` last: each number compared beside its limit,
which are also the last lines of standard error.  Exits non-zero, with no
result, when there is no CUDA card or fewer than the cell asks for, and
when the process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
# Kernel and compile caches at fixed paths inside the checkout, so that only
# a checkout's first run builds.  The program's nvcc build sits in
# nbody3d_tpu_torch/_build/; these catch a Triton kernel or a torch
# extension that a later version of the program may add.
_CACHE = CHECKOUT / ".nbbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from nbbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"nbbench: {cell.name} needs {cell.chips} CUDA card(s); this process sees {n}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = harness.kind_module(cell.traffic["kind"]).run(
        cell, args.seed, args.seconds, bool(args.trace), dev, T_START)

    found = harness.forbidden_modules()
    if found:
        print(f"nbbench: the process holds {found} after the window", file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", flush=True)
    for line in out["lines"]:
        print(line, flush=True)

    limits = {k: float(v) for k, v in cell.workload["limits"].items()}
    correct, checks = harness.judge(out["numbers"], limits)
    device = dict(out["device"])
    if args.trace:
        rec = out.get("record")
        metrics = {}
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(rec) if rec else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if rec:
            device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result_extra = {"breakdown": harness.breakdown(rec)} if rec else {}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        result_extra = {}
    result = {
        "correct": correct, "attempted": out["attempted"], "failed": 0 if correct else 1,
        "metrics": metrics, "device": device, **result_extra,
    }
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
