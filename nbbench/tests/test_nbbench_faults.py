"""Each cell's run on the CPU at a small size, sound and with the program's
step broken underneath: the comparison has to find every fault the cell
can have.  The faults are planted in the program's step function; the rest
of the run is the harness's own (all but the look for a card)."""

import time

import pytest
import torch

from nbbench import harness
from nbbench.tests.conftest import small_cell

# Bodies a cell keeps on the CPU: whole 256-row tiles, two at least.
SIZES = {"sphere262k-sym.step": 4096, "galaxy40k-exact.step": 512, "galaxy40k-exact.grad": 256}
SEED = 3_000_000_123


def _step_of(state_cls):
    def unchanged(inner):
        return lambda s, dt, G: state_cls(s.pos_mass, s.vel, s.accel, s.step + 1)

    def half_left_out(inner):
        def step(s, dt, G):
            keep = tuple(t.detach().clone() for t in (s.pos_mass, s.vel, s.accel))
            out = inner(s, dt, G)
            h = out.pos_mass.shape[0] // 2
            parts = []
            for new, old in zip((out.pos_mass, out.vel, out.accel), keep):
                parts.append(torch.cat([new[:h], old[h:]]))
            return state_cls(*parts, out.step)
        return step

    def altered(inner):
        def step(s, dt, G):
            out = inner(s, dt, G)
            bump = torch.zeros_like(out.pos_mass)
            bump[0, 0] = 1e-2
            return state_cls(out.pos_mass + bump, out.vel, out.accel, out.step)
        return step

    return {"unchanged": unchanged, "half_left_out": half_left_out, "altered": altered}


def _run(name: str, cpu):
    cell = small_cell(name, SIZES[name])
    out = harness.kind_module(cell.traffic["kind"]).run(cell, SEED, 0.3, False, cpu, time.perf_counter())
    limits = {k: float(v) for k, v in cell.workload["limits"].items()}
    return harness.judge(out["numbers"], limits)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_is_correct(name, cpu):
    ok, checks = _run(name, cpu)
    assert ok, checks


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_planted_fault_is_not_correct(name, fault, cpu, monkeypatch):
    from nbody3d_tpu_torch import SimState, engine
    from nbody3d_tpu_torch.ops import step as step_mod

    orig = step_mod.make_step_fn
    plant = _step_of(SimState)[fault]

    def make_step_fn(*a, **k):
        return plant(orig(*a, **k))

    monkeypatch.setattr(engine, "make_step_fn", make_step_fn)
    monkeypatch.setattr(step_mod, "make_step_fn", make_step_fn)
    try:
        ok, checks = _run(name, cpu)
    except RuntimeError as e:
        # A rollout whose steps return their state unchanged leaves the
        # loss without a path to v0: autograd raises and the run prints no
        # result, which fails it as surely.
        assert fault == "unchanged" and "does not require grad" in str(e)
        return
    assert not ok, checks
