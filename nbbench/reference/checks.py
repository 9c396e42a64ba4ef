"""The comparisons that decide ``correct``: the program's outputs against
the plain reference of :mod:`nbbench.reference.physics`.

A step cell hands over the state at the start of the window's last chunk
(``a``) and at its end (``b``), each ``(pos_mass, vel, accel)`` as the
program keeps them: ``(N_pad, 4)`` float32, real bodies first.  The
reference reads them only to judge them.  The numbers, each held to a limit
of the cell's workload file:

- ``bodies_err``: the bodies are kept as a set: real rows whose mass is not
  the input's, sorted (the re-sort may permute rows), padding rows with mass,
  and entries that are not finite.  A count; exact.
- ``force_err``: the acceleration ``b`` carries is the force at the
  positions before its last step, which frame-shifted Verlet gives back:
  ``x_prev = x - (v + a dt/2) dt``, rounded to float32.  The reference's
  float64 force there, every body, as ``max_i |a_i - f_i| / (|f_i| +
  median_j |f_j|)``.
- ``follow_err``: the reference steps ``a`` on for the chunk's steps in
  float64; the 99th percentile over bodies of the gap in position and in
  velocity, each over the median change across the chunk.  Only where rows
  keep their order.
- ``energy_drift``: ``|E_b - E_a| / (KE_b + |PE_b|)``, both energies the
  reference's own.  Frame-shifted Verlet keeps the velocity one step
  behind the positions; each end's velocity is brought level with its
  positions as the next step would, ``v + (a + f(x)) dt/2``, with the
  reference's ``f``.
- ``momentum_err``: ``max |P_b - P_a| / sum m |v_b|``, those velocities.

A gradient cell hands over its last gradient by ``v0``: ``grad_err`` is
``max |g - g_ref| / max |g_ref|`` over the x, y and z lanes of the real rows.
"""

from __future__ import annotations

import torch

from nbbench.reference import physics

F64 = torch.float64
# follow_err's quantile over bodies: a body that passes within a few eps of a
# galaxy's centre in the chunk (dt * omega > 1 there) turns a float32 ulp into
# a gap as large as the control's, and the reference's own float64 trajectory
# is no better; the top 1% of bodies is left to force_err, a function of the
# state and not of its history.
FOLLOW_Q = 0.99


def _real(state: tuple, n: int) -> tuple:
    return tuple(t[:n] for t in state)


def bodies_err(b: tuple, n_real: int, masses: torch.Tensor) -> float:
    pm, vel, acc = b
    bad = sum(int((~torch.isfinite(t)).sum()) for t in b)
    got = torch.sort(pm[:n_real, 3].to(F64)).values
    want = torch.sort(masses.to(device=pm.device, dtype=F64)).values
    bad += int((got != want).sum())
    bad += int((pm[n_real:, 3] != 0).sum())
    return float(bad)


def previous_positions(b: tuple, n_real: int, dt: float) -> torch.Tensor:
    pm, vel, acc = _real(b, n_real)
    x = pm[:, :3].to(F64) - (vel[:, :3].to(F64) + acc[:, :3].to(F64) * (dt / 2)) * dt
    return x.to(torch.float32)


def force_err(b: tuple, n_real: int, sim: dict) -> float:
    pm = b[0][:n_real]
    x_prev = previous_positions(b, n_real, sim["dt"])
    f = physics.accel(x_prev, pm[:, 3], sim["G"], sim["eps2"])
    got = b[2][:n_real, :3].to(F64)
    mag = f.norm(dim=1)
    return float(((got - f).norm(dim=1) / (mag + mag.median())).max())


def follow_err(a: tuple, b: tuple, n_real: int, steps: int, sim: dict) -> float:
    pa, va, aa = _real(a, n_real)
    pb, vb, _ = _real(b, n_real)
    x, v, _ = physics.follow(pa[:, :3], va[:, :3], aa[:, :3], pa[:, 3], sim["G"], sim["eps2"], sim["dt"], steps)
    dx = (pb[:, :3].to(F64) - x).norm(dim=1).quantile(FOLLOW_Q) / (x - pa[:, :3].to(F64)).norm(dim=1).median()
    dv = (vb[:, :3].to(F64) - v).norm(dim=1).quantile(FOLLOW_Q) / (v - va[:, :3].to(F64)).norm(dim=1).median()
    return float(torch.maximum(dx, dv))


def conservation(a: tuple, b: tuple, n_real: int, sim: dict) -> dict[str, float]:
    ends = []
    for pm, vel, acc in (_real(a, n_real), _real(b, n_real)):
        ends.append(physics.energy(pm[:, :3], vel[:, :3], acc[:, :3], pm[:, 3], sim["G"], sim["eps2"], sim["dt"]))
    ea, eb = ends
    drift = abs((eb["ke"] + eb["pe"]) - (ea["ke"] + ea["pe"])) / (eb["ke"] + abs(eb["pe"]))
    dp = (eb["momentum"] - ea["momentum"]).abs().max()
    return {"energy_drift": drift, "momentum_err": float(dp) / eb["momentum_scale"]}


def step_numbers(names, a: tuple, b: tuple, *, n_real: int, steps: int, masses, sim: dict) -> dict[str, float]:
    """The numbers ``names`` asks for (start_err comes from the set-up)."""
    out: dict[str, float] = {}
    if "bodies_err" in names:
        out["bodies_err"] = bodies_err(b, n_real, masses)
    if "force_err" in names:
        out["force_err"] = force_err(b, n_real, sim)
    if "follow_err" in names:
        out["follow_err"] = follow_err(a, b, n_real, steps, sim)
    if {"energy_drift", "momentum_err"} & set(names):
        out.update({k: v for k, v in conservation(a, b, n_real, sim).items() if k in names})
    return out


def grad_err(g: torch.Tensor, pos_mass, vel, n_real: int, steps: int, sim: dict) -> float:
    pm = torch.as_tensor(pos_mass, device=g.device)[:n_real]
    v0 = torch.as_tensor(vel, device=g.device)[:n_real]
    ref = physics.rollout_grad(pm[:, :3], v0[:, :3], pm[:, 3], sim["G"], sim["eps2"], sim["dt"], steps)
    got = g[:n_real, :3].to(F64)
    return float((got - ref).abs().max() / ref.abs().max())


def start_err(state: tuple, pos_mass, vel) -> float:
    """Entries of the program's first state that are not the inputs
    (padding rows must be zero)."""
    pm, v, acc = state
    n = pos_mass.shape[0]
    want_pm = torch.as_tensor(pos_mass, device=pm.device)
    want_v = torch.as_tensor(vel, device=pm.device)
    bad = int((pm[:n] != want_pm).sum()) + int((v[:n] != want_v).sum()) + int((acc != 0).sum())
    bad += int((pm[n:] != 0).sum()) + int((v[n:] != 0).sum())
    return float(bad)
