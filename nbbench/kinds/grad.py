"""Traffic kind ``grad``: the gradient by ``v0`` of ``mean |x_k|^2`` after a
``rollout`` step Verlet rollout from the seed's inputs, through the
program's ``make_step_fn`` step under ``torch.autograd.grad``.

The traffic file gives ``rollout`` (k), ``warm`` (gradients in the
set-up) and ``trace_from`` / ``trace_units`` (the gradients a ``--trace
1`` run profiles).  The window enqueues gradients back to back with at
most two in flight, from the first enqueue to the end of the last
gradient; in a ``--trace 1`` run each backward is timed on its own,
between two ``torch.cuda.synchronize()`` calls, outside the profiled
gradients, which run as the window runs them.  The last gradient goes to
the reference's comparison once the window has closed.
"""

from __future__ import annotations

import time


def program_gradient(cell, pos_mass, vel, dev):
    """``(first state, loss(v) -> scalar)`` of the program for this cell."""
    import torch

    from nbody3d_tpu_torch import SimConfig, SimState, init_state, pad_count
    from nbody3d_tpu_torch.ops.step import make_step_fn, pad_multiple

    cfg = SimConfig(**cell.config["sim"])
    n = pos_mass.shape[0]
    st = init_state(pos_mass, vel, n_pad=pad_count(n, pad_multiple(cfg, dev)), device=dev)
    step = make_step_fn(cfg, st.n_pad, n, dev)
    k = int(cell.traffic["rollout"])

    def loss(v):
        s = SimState(st.pos_mass, v, torch.zeros_like(st.pos_mass), 0)
        for _ in range(k):
            s = step(s, cfg.dt, cfg.G)
        return (s.pos_mass[:, :3] ** 2).sum() / n

    return (st.pos_mass, st.vel, st.accel), loss


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, make_loss=None) -> dict:
    import torch

    from nbbench import harness, yardstick
    from nbbench.reference import checks

    tr = cell.traffic
    k = int(tr["rollout"])
    pos_mass, vel = harness.make_inputs(cell, seed)
    n_real = pos_mass.shape[0]
    state, loss = (make_loss or program_gradient)(cell, pos_mass, vel, dev)
    v_in = state[1]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def gradient():
        v = v_in.detach().requires_grad_()
        return torch.autograd.grad(loss(v), v)[0]

    start_err = checks.start_err(state, pos_mass, vel)
    for _ in range(int(tr["warm"])):
        gradient()
    stretch = harness.Stretch(torch) if trace else None
    if stretch is not None:
        stretch.warm(lambda: (gradient(), sync()))
    sync()
    setup_s = time.perf_counter() - t_start

    lo, hi = int(tr["trace_from"]), int(tr["trace_from"]) + int(tr["trace_units"])
    backward_s, events, g = [], [], None
    n_done, t_tr = 0, 0.0
    t0 = time.perf_counter()
    while True:
        if stretch is not None and n_done == lo:
            sync()
            stretch.start()
            t_tr = time.perf_counter()
        if trace and not lo <= n_done < hi:
            v = v_in.detach().requires_grad_()
            value = loss(v)
            sync()
            tb = time.perf_counter()
            g = torch.autograd.grad(value, v)[0]
            sync()
            backward_s.append(time.perf_counter() - tb)
        else:
            g = gradient()
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > 2:
                events.pop(0).synchronize()
        n_done += 1
        done = time.perf_counter() - t0 >= seconds
        if stretch is not None and (n_done == hi or (done and lo < n_done < hi)):
            sync()
            stretch.stop()
            stretch.window_s, stretch.units = time.perf_counter() - t_tr, n_done - lo
        if done:
            break
    sync()
    window_s = time.perf_counter() - t0

    device = harness.device_report(torch, dev, cell.chips) if dev.type == "cuda" else {"platform": "cpu"}
    out = {
        "attempted": n_done,
        "device": device,
        "numbers": {"start_err": start_err},
        "lines": [f"window {window_s:.6f} s, {n_done} gradients of a {k}-step rollout"],
        "end_to_end": {"setup_s": setup_s, "grad_steps_per_s": n_done * k / window_s},
    }
    if stretch is not None and stretch.units:
        from nbody3d_tpu_torch.ops.launch import launch_counts

        bound = yardstick.pair_bound_s(n_real, gradient=True)
        out["record"] = harness.trace_record(
            stretch, steps=stretch.units * k, pair_bound_s=bound["seconds"],
            spans={"backward_s": backward_s, "rollout": k},
        )
        out["lines"].append(f"program launch counts since start (ops/launch registry): "
                            f"{ {n: c for n, c in launch_counts().items() if c} }")
        out["lines"].append(f"pair bound {bound['seconds'] * 1e3:.6f} ms a rollout step ({bound['by']})")

    g = g.detach().clone()
    del state, loss, v_in
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"]["grad_err"] = checks.grad_err(g, pos_mass, vel, n_real, k, cell.config["sim"])
    return out
