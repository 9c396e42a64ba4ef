"""The control: the plain reference put in the program's place, computed
in the precision next below the one the configuration states (bfloat16 for
float32), and driven through the cell's own traffic and comparison.  Its
readings are the upper ends the limits are set under; it has to come out
as not correct.  The benchmark's own runs do not run it.

    python3 nbbench/control.py --workload <cell> --seeds <n> [<n> ...]

runs, for each seed, one window of a single chunk (a step cell) or a single
gradient (the gradient cell) at the cell's own size, and prints each
number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# The precision next below the configuration's: float32's is bfloat16.
LOWER = {"float32": "bfloat16"}


class ReferenceSim:
    """A stand-in for the program's ``Simulation`` (``state``,
    ``run_async``, ``wait_chunk``): the reference's force in ``dtype`` and
    the frame-shifted Verlet update on a float32 state, unpadded."""

    def __init__(self, config: dict, pos_mass, vel, dev, dtype):
        import torch
        from types import SimpleNamespace

        self.torch, self.dtype, self.sim = torch, dtype, config["sim"]
        pm = torch.as_tensor(pos_mass, device=dev)
        self.state = SimpleNamespace(pos_mass=pm, vel=torch.as_tensor(vel, device=dev),
                                     accel=torch.zeros_like(pm))

    def run_async(self, k: int):
        from nbbench.reference import physics

        t = self.torch
        s, h = self.state, float(self.sim["dt"]) / 2
        pm, v, a = s.pos_mass, s.vel, s.accel
        for _ in range(k):
            f = t.zeros_like(pm)
            f[:, :3] = physics.accel(pm[:, :3], pm[:, 3], self.sim["G"], self.sim["eps2"], dtype=self.dtype).float()
            v = v + (a + f) * h
            pm = pm + (v + f * h) * (2 * h)
            a = f
        s.pos_mass, s.vel, s.accel = pm, v, a
        return k

    def wait_chunk(self, token) -> None:
        if self.state.pos_mass.is_cuda:
            self.torch.cuda.synchronize()


def control_sim(dtype):
    def make_sim(cell, pos_mass, vel, dev):
        return lambda: ReferenceSim(cell.config, pos_mass, vel, dev, dtype)

    return make_sim


def control_loss(dtype):
    """The reference's gradient in ``dtype`` as the program's loss would
    give it: ``loss(v) = sum(v * g)``, whose gradient by ``v`` is ``g``."""

    def make_loss(cell, pos_mass, vel, dev):
        import torch

        from nbbench.reference import physics

        sim = cell.config["sim"]
        pm = torch.as_tensor(pos_mass, device=dev)
        v0 = torch.as_tensor(vel, device=dev)
        g = torch.zeros_like(pm)
        g[:, :3] = physics.rollout_grad(pm[:, :3], v0[:, :3], pm[:, 3], sim["G"], sim["eps2"], sim["dt"],
                                        int(cell.traffic["rollout"]), dtype=dtype).float()
        return (pm, v0, torch.zeros_like(pm)), lambda v: (v * g).sum()

    return make_loss


def run_control(cell, seed: int, dev) -> tuple[bool, dict]:
    """One control window of ``cell`` (a single chunk or gradient);
    ``(correct, {number: {value, limit}})``."""
    import torch

    from nbbench import harness

    dtype = getattr(torch, LOWER[cell.config["precision"]])
    kind = cell.traffic["kind"]
    inject = {"make_sim": control_sim(dtype)} if kind == "step" else {"make_loss": control_loss(dtype)}
    out = harness.kind_module(kind).run(cell, seed, 0.0, False, dev, time.perf_counter(), **inject)
    limits = {k: float(v) for k, v in cell.workload["limits"].items()}
    return harness.judge(out["numbers"], limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from nbbench import harness

    if not torch.cuda.is_available():
        print("nbbench control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        correct, checks = run_control(cell, seed, dev)
        print(json.dumps({"control": cell.name, "precision": LOWER[cell.config["precision"]], "seed": seed,
                          "correct": correct, "seconds": time.perf_counter() - t, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
