"""Traffic kind ``step``: the program steps the configuration in chunks, as
the live viewer does, through ``Simulation.run_async`` and ``wait_chunk``.

The traffic file gives ``chunk`` (steps a chunk), ``segment_chunks`` (a
fresh ``Simulation`` from the seed's inputs every that many chunks, so
that every run simulates the same stretch of time whatever its speed),
``warm_chunks`` x ``warm_steps`` (the set-up's chunks: they build or load
the kernels and run every shape the window runs), and ``trace_from`` /
``trace_chunks`` (the chunks a ``--trace 1`` run profiles).

The window runs from the first chunk's enqueue to the end of the last
chunk's event, and holds whole chunks: the chunk that would end past
``seconds`` (by the last chunk's time) is the last.  The state at the start
of the last chunk is copied, and with the state at its end it goes to the
reference's comparison once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np


def program_sim(cell, pos_mass, vel, dev):
    """``make() -> Simulation`` of the program for this cell."""
    from nbody3d_tpu_torch import SimConfig, Simulation

    cfg = SimConfig(**cell.config["sim"])
    return lambda: Simulation(cfg, pos_mass, vel, device=dev)


def _state(sim) -> tuple:
    s = sim.state
    return s.pos_mass, s.vel, s.accel


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, make_sim=None) -> dict:
    import torch

    from nbbench import harness, yardstick
    from nbbench.reference import checks

    tr = cell.traffic
    k, seg = int(tr["chunk"]), int(tr["segment_chunks"])
    pos_mass, vel = harness.make_inputs(cell, seed)
    n_real = pos_mass.shape[0]
    make = (make_sim or program_sim)(cell, pos_mass, vel, dev)

    # Set-up: the first Simulation's state against the inputs, then the
    # warm chunks (the first kernel launch builds or loads the library).
    sim = make()
    start_err = checks.start_err(_state(sim), pos_mass, vel)
    for _ in range(int(tr["warm_chunks"])):
        sim.wait_chunk(sim.run_async(int(tr["warm_steps"])))
    stretch = harness.Stretch(torch) if trace else None
    if stretch is not None:
        stretch.warm(lambda: sim.wait_chunk(sim.run_async(int(tr["warm_steps"]))))
    sim = make()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    lo, hi = int(tr["trace_from"]), int(tr["trace_from"]) + int(tr["trace_chunks"])
    chunk_s, enqueue_s = [], []
    seg_i, prev, snap, t_tr = 0, 0.0, None, 0.0
    t0 = time.perf_counter()
    while True:
        j = len(chunk_s)
        if seg_i == seg:
            sim, seg_i = make(), 0
        last = time.perf_counter() - t0 + prev >= seconds
        if last:
            snap = tuple(t.clone() for t in _state(sim))
        if stretch is not None and j == lo:
            stretch.start()
            t_tr = time.perf_counter()
        te = time.perf_counter()
        token = sim.run_async(k)
        tq = time.perf_counter()
        sim.wait_chunk(token)
        td = time.perf_counter()
        if stretch is not None and (j == hi - 1 or (last and lo <= j < hi)):
            stretch.stop()
            stretch.window_s, stretch.units = td - t_tr, j - lo + 1
        chunk_s.append(td - te)
        enqueue_s.append(tq - te)
        seg_i += 1
        prev = td - te
        if last:
            break
    window_s = td - t0

    device = harness.device_report(torch, dev, cell.chips) if dev.type == "cuda" else {"platform": "cpu"}
    steps = len(chunk_s) * k
    out = {
        "attempted": len(chunk_s),
        "device": device,
        "numbers": {"start_err": start_err},
        "lines": [
            f"window {window_s:.6f} s, {len(chunk_s)} chunks of {k} steps, {steps} steps, "
            f"{n_real * (n_real - 1) * steps / window_s / 1e9:.4f} G-int/s (N(N-1) x steps/s); "
            f"chunk_ms_p95 over {len(chunk_s)} chunks",
        ],
        "end_to_end": {
            "setup_s": setup_s,
            "steps_per_s": steps / window_s,
            "chunk_ms_p95": float(np.percentile(np.asarray(chunk_s) * 1e3, 95)),
        },
    }
    if stretch is not None and stretch.units:
        from nbody3d_tpu_torch.ops.launch import launch_counts

        outside = [t for i, t in enumerate(enqueue_s) if not lo <= i < lo + stretch.units]
        bound = yardstick.pair_bound_s(n_real)
        out["record"] = harness.trace_record(
            stretch, steps=stretch.units * k, pair_bound_s=bound["seconds"],
            spans={"enqueue_s": outside, "chunk_steps": k},
        )
        out["lines"].append(f"program launch counts since start (ops/launch registry): "
                            f"{ {n: c for n, c in launch_counts().items() if c} }")
        out["lines"].append(f"pair bound {bound['seconds'] * 1e3:.6f} ms a step ({bound['by']}, "
                            f"{bound['pairs']:.6g} pairs)")

    # The window has closed and the peak is read: free the program's
    # state, then the reference judges the last chunk.
    b = tuple(t.clone() for t in _state(sim))
    del sim
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    names = list(cell.workload["limits"])
    out["numbers"].update(checks.step_numbers(
        names, snap, b, n_real=n_real, steps=k, masses=torch.as_tensor(pos_mass[:, 3]),
        sim=cell.config["sim"],
    ))
    return out
