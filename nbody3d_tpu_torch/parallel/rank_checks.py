"""What the multi-rank tests run on each rank (``parallel.launch.spawn``).

A spawned rank imports the module of its function anew, and the test
modules import jax, so the ranks' functions live here.  :func:`run_cases`
runs a list of cases on the mesh each builds and returns rank 0's results
as numpy (other ranks return None); a rank that imported the JAX package
fails (and ``spawn`` fails one that imported jax).  The states come from
:func:`random_bodies`, which the tests call too, so the JAX package gets
the same inputs.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.parallel import mesh as mesh_mod
from nbody3d_tpu_torch.parallel import sharded
from nbody3d_tpu_torch.state import init_state


def random_bodies(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_sharded.py``'s ``random_state`` bodies: positions
    N(0, 1), masses U(1, 50), velocities N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    pm = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(1, 50, size=(n, 1))], axis=1).astype(np.float32)
    v = np.concatenate([rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1).astype(np.float32)
    return pm, v


def clustered_bodies(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_p3m_distributed.py``'s ``_clustered`` bodies: eight
    clumps (centres N(0, 16), spread 0.4), masses U(1, 50) and one 1e7 body,
    velocities N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 3)) * 4
    pos = centers[rng.integers(0, 8, size=n)] + rng.normal(size=(n, 3)) * 0.4
    m = rng.uniform(1, 50, size=(n, 1))
    m[0, 0] = 1e7
    pm = np.concatenate([pos, m], axis=1).astype(np.float32)
    v = np.concatenate([rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1).astype(np.float32)
    return pm, v


def case_bodies(case: dict) -> tuple[np.ndarray, np.ndarray]:
    """A case's bodies: ``"random"`` (:func:`random_bodies`, the default),
    ``"clustered"`` (:func:`clustered_bodies`) or ``"zeldovich"`` (the
    port's ``zeldovich_box`` of ``case["n1"]``³ bodies in ``case["box"]``,
    EdS velocities, ``tests/test_expansion.py``'s amplitude 0.02)."""
    kind = case.get("bodies", "random")
    if kind == "zeldovich":
        from nbody3d_tpu_torch.models.cosmo import zeldovich_box

        pm, v, _ = zeldovich_box(case["n1"], case["box"], amp=0.02, velocity="eds", G=case["G"],
                                 rng=np.random.default_rng(case["seed"]))
        return pm, v
    return (clustered_bodies if kind == "clustered" else random_bodies)(case["seed"], case["n"])


def _mesh(spec):
    """``"x"``: the 1-D mesh; ``(rows, cols)``: the grid mesh (``(None,
    None)``: its default shape)."""
    return mesh_mod.default_mesh() if spec == "x" else mesh_mod.grid_mesh(*spec)


def _numpy(state):
    return tuple(t.numpy().copy() for t in (state.pos_mass, state.vel, state.accel)) + (state.step,)


def _step_case(mesh, case: dict):
    """``steps`` sharded steps of :func:`random_bodies` (padded to
    ``n_pad``); the gathered state."""
    cfg = SimConfig(**case["config"])
    pm, v = case_bodies(case)
    n = pm.shape[0]
    n_pad = case.get("n_pad", n)
    state = sharded.shard_state(init_state(pm, v, n_pad=n_pad, device="cpu"), mesh)
    step = sharded.make_sharded_step(cfg, n_pad, n, mesh, src_chunks=case.get("src_chunks"))
    for _ in range(case.get("steps", 1)):
        state = step(state, case.get("dt", 1e-4), case.get("G", 1e-4))
    return _numpy(sharded.gather_state(state, mesh))


def _diag_case(mesh, case: dict):
    cfg = SimConfig(**case.get("config", {}))
    pm, v = random_bodies(case["seed"], case["n"])
    state = sharded.shard_state(init_state(pm, v, device="cpu"), mesh)
    d = sharded.make_sharded_diagnostics(cfg, case["n"], mesh)(state, case.get("G", 1e-4))
    return tuple(t.numpy().copy() for t in d)


class _Spy:
    """Records, in call order, each ``batch_isend_irecv`` ("send") and
    each hop force ("force") of the sharded module."""

    def __init__(self):
        self.log: list[str] = []

    def wrap(self, what: str, fn):
        def spy(*args, **kw):
            self.log.append(what)
            return fn(*args, **kw)

        return spy


def _order_case(mesh, case: dict):
    """The ring's call order on this rank, with the kernel route's force
    (``force_exact``'s twin here) and the transfers spied on."""
    spy = _Spy()
    saved = dist.batch_isend_irecv, sharded.force_exact, sharded.accel_partial
    dist.batch_isend_irecv = spy.wrap("send", saved[0])
    sharded.force_exact = spy.wrap("force", saved[1])
    sharded.accel_partial = spy.wrap("force", saved[2])
    try:
        _step_case(mesh, case)
    finally:
        dist.batch_isend_irecv, sharded.force_exact, sharded.accel_partial = saved
    return spy.log


FRAME = dict(width=96, height=64)


def frame_camera(radius: float = 5.0):
    """The camera of the rank cases' frames (the tests render one device's
    frames with it too)."""
    from nbody3d_tpu_torch.utils.camera import Camera

    return Camera(target=np.zeros(3), radius=radius)


def _engine_case(mesh, case: dict):
    """``Simulation(mesh=...)``: a preset run with Morton re-sorts, the
    diagnostics, a checkpoint saved and loaded back sharded (npz and
    JSON), and the loaded state's frame (the sharded render)."""
    from nbody3d_tpu_torch.engine import Simulation

    cfg = SimConfig(**case["config"])
    sim = Simulation.from_preset(case["preset"], cfg, n=case["n"], mesh=mesh)
    sim.run(case["steps"], chunk=case["chunk"])
    d = sim.diagnostics()
    out = {"arrays": sim.arrays(), "n_pad": sim.n_pad, "shard": sim.state.pos_mass.shape[0],
           "step": sim.step_count, "diag": tuple(np.asarray(x) for x in d)}
    path = case["path"]
    for suffix in (".npz", ".json"):
        sim.save(path + suffix)
        dist.barrier()  # rank 0 has written the file
        back = Simulation.load(path + suffix, mesh=mesh)
        out["loaded" + suffix] = back.arrays()
        out["frame" + suffix] = back.render_frame(camera=frame_camera(), **FRAME)
    return out


def _checkpoint_dir_case(mesh, case: dict):
    """A sharded run saved as one checkpoint directory (rank 0 writes the
    gathered state) and loaded back on the mesh: the gathered arrays before
    and after, and this rank's rows of the loaded state."""
    from nbody3d_tpu_torch.engine import Simulation

    sim = Simulation(SimConfig(**case["config"]), *case_bodies(case), mesh=mesh)
    sim.run(case["steps"], chunk=case["steps"])
    arrays = sim.arrays()
    sim.save(case["path"])
    dist.barrier()  # rank 0 has written the directory
    back = Simulation.load(case["path"], mesh=mesh)
    return {"arrays": arrays, "loaded": back.arrays(), "shard": back.state.pos_mass.numpy().copy()}


def _render_case(mesh, case: dict):
    """The frames of a sharded ``Simulation`` after its run (Morton re-sorts,
    or a P3M step): ``render_frame`` by each resolve, and each resolve's
    pipelined begin, a chunk of one step enqueued after it, and its finish;
    with the gathered state the frames render from and its padding rows'
    largest mass."""
    from nbody3d_tpu_torch.engine import Simulation
    from nbody3d_tpu_torch.render.rasterize import RESOLVES

    sim = Simulation.from_preset(case["preset"], SimConfig(**case["config"]), n=case["n"], mesh=mesh)
    sim.run(case["steps"], chunk=case["chunk"])
    cam = frame_camera()
    state = sim.global_state()
    out = {"arrays": sim.arrays(), "pad_mass": float(state.pos_mass[sim.n_real:, 3].abs().max()),
           "step": sim.step_count}
    for res in RESOLVES:
        out[res] = sim.render_frame(camera=cam, resolve=res, **FRAME)
    handles = {res: sim.render_frame_begin(cam, resolve=res, **FRAME) for res in RESOLVES}
    token = sim.run_async(1)
    for res in RESOLVES:
        out["pipelined " + res] = sim.render_frame_finish(handles[res])
    sim.wait_chunk(token)
    out["step_after"] = sim.step_count
    return out


def _regenerate_case(mesh, case: dict):
    """``regenerate()`` with no seed on a mesh: the seed each rank ends with,
    its shard and the gathered state."""
    from nbody3d_tpu_torch.engine import Simulation

    sim = Simulation.from_preset(case["preset"], SimConfig(**case.get("config", {})), n=case["n"], mesh=mesh)
    new = sim.regenerate()
    return {"seed": new.config.seed, "shard": new.state.pos_mass.numpy().copy(), "arrays": new.arrays(),
            "n_pad": new.n_pad}


def _serve_case(mesh, case: dict):
    """A served mesh without HTTP: rank 0's ``LiveViewer`` driven through
    pipelined frames, a dt change, pause and unpause, regenerate, export
    and import, and a pause with paused frames, then stopped; the other
    ranks in ``viewer.follow``.  Every rank logs the op records it sends or
    takes; every rank returns its log, runtime, step and seed, and the
    gathered state (after the stop: a collective outside the protocol);
    rank 0 also its last JPEG and the camera it was rendered with."""
    import time

    from nbody3d_tpu_torch import viewer
    from nbody3d_tpu_torch.engine import Simulation

    log = []
    broadcast = viewer._broadcast

    def logged(record, side):
        got = broadcast(record, side)
        log.append((got["op"], got.get("runtime"), got.get("k"), got.get("seed")))
        return got

    viewer._broadcast = logged
    try:
        side = viewer.control_group()
        sim = Simulation.from_preset(case["preset"], SimConfig(**case.get("config", {})), n=case["n"], mesh=mesh)
        if mesh.rank != 0:
            sim = viewer.follow(sim, side)
            frame = cam = None
        else:
            v = viewer.LiveViewer(sim, steps_per_frame=2, diagnostics_every=3, side=side, **FRAME)

            def until(pred, what):
                deadline = time.monotonic() + 60
                while not pred():
                    if v.error is not None or time.monotonic() > deadline:
                        raise RuntimeError(f"serve case: {what} ({v.error!r})")
                    time.sleep(0.01)

            def frames(k):
                n = v.chunks_done
                until(lambda: v.chunks_done >= n + k, f"{k} pipelined frames")

            def paused_frames(k):
                n = v._frames_done
                until(lambda: v._frames_done >= n + k, f"{k} paused frames")

            v.start()
            frames(3)
            v.control({"logdt": ["-3.8"], "orbit": ["30,5"]})
            frames(2)
            v.control({"pause": ["1"]})
            paused_frames(2)
            v.control({"pause": ["1"]})
            frames(2)
            v.regenerate()
            frames(2)
            v.import_state(v.export_state(".npz"), ".npz")
            frames(2)
            v.control({"pause": ["1"]})
            paused_frames(2)
            v.stop()
            if v.error is not None:
                raise RuntimeError("the viewer's loop failed") from v.error
            sim, frame, cam = v.sim, v._frame, v.camera.to_dict()
        return {"log": log, "runtime": (sim._dt, sim._G, sim._old_dt), "step": sim.step_count,
                "seed": sim.config.seed, "arrays": sim.arrays(), "frame": frame, "camera": cam}
    finally:
        viewer._broadcast = broadcast


def _serve_import_fails_case(mesh, case: dict):
    """A served mesh whose import fails on rank 1 alone (its copy of the
    checkpoint cannot be read): rank 0's ``LiveViewer``, no loop thread,
    exports at step 0, makes a pipelined frame, imports the export, makes
    another frame and stops; the other ranks in ``viewer.follow``.  Every
    rank returns its step and gathered state, rank 0 also what its import
    raised."""
    from nbody3d_tpu_torch import viewer
    from nbody3d_tpu_torch.engine import Simulation

    load = viewer._load_bytes

    def unreadable(old, data, suffix):
        raise OSError(f"rank {mesh.rank} cannot read its copy of the checkpoint")

    if mesh.rank == 1:
        viewer._load_bytes = unreadable
    try:
        side = viewer.control_group()
        sim = Simulation.from_preset(case["preset"], SimConfig(**case.get("config", {})), n=case["n"], mesh=mesh)
        raised = None
        if mesh.rank != 0:
            sim = viewer.follow(sim, side)
        else:
            v = viewer.LiveViewer(sim, steps_per_frame=2, side=side, **FRAME)
            data = v.export_state(".npz")
            v.pipelined_frame()
            try:
                v.import_state(data, ".npz")
            except RuntimeError as e:
                raised = str(e)
            v.pipelined_frame()
            v.stop()
            sim = v.sim
        return {"step": sim.step_count, "arrays": sim.arrays(), "raised": raised}
    finally:
        viewer._load_bytes = load


def _mesh_case(mesh, case: dict):
    """The mesh as this rank sees it, and an all-gather of the ranks along
    each axis (their global ranks, in group order)."""
    along = {}
    for axis, group in mesh.groups.items():
        size = dist.get_world_size(group)
        out = torch.empty(size, dtype=torch.int64)
        mesh_mod.all_gather_single(out, torch.tensor([mesh.rank]), group=group)
        along[axis] = out.tolist()
    return {"shape": mesh.shape, "axes": mesh.axis_names, "rank": mesh.rank, "coords": mesh.coords,
            "along": along, "info": mesh_mod.mesh_info()}


def _mesh_errors_case(mesh, case: dict):
    """What the constructors raise for a device count or shape that does
    not fit the process group."""
    out = []
    for make in (lambda: mesh_mod.default_mesh(dist.get_world_size() + 1),
                 lambda: mesh_mod.grid_mesh(rows=dist.get_world_size() + 1),
                 lambda: mesh_mod.grid_mesh(2, dist.get_world_size())):
        try:
            make()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _mesh_force(mesh, case: dict):
    """The sharded mesh force of the case's config and the rank's group."""
    from nbody3d_tpu_torch.ops.step import resolve_backend
    from nbody3d_tpu_torch.parallel.mesh_force import ShardedP3M, ShardedPM

    cfg = SimConfig(**case["config"])
    pm, _ = case_bodies(case)
    n_pad = case.get("n_pad", pm.shape[0])
    full = init_state(pm, np.zeros_like(pm), n_pad=n_pad, device="cpu").pos_mass
    force = (ShardedP3M if cfg.method == "p3m" else ShardedPM)(cfg, n_pad, pm.shape[0], mesh.size,
                                                              resolve_backend(cfg, mesh.device))
    return force, full, full.view(mesh.size, -1, 4)


def _p3m_stages_case(mesh, case: dict):
    """Every rank's integer stages of one sharded P3M force evaluation: the
    splitters, its rows' destinations, its sorted slice's gids, its halo's
    tiles, its rows' global neighbour lists and the final mask."""
    from nbody3d_tpu_torch.parallel.exchange import DistGroup

    force, _, shards = _mesh_force(mesh, case)
    trace: dict = {}
    force.accel(DistGroup(mesh.rank, mesh.size), [shards[mesh.rank]], case.get("G", 1e-4), trace)
    sr = trace["short_range"][0]
    return {"K": trace["splitters"][0].numpy(), "Gs": trace["splitters"][1].numpy(),
            "dest": trace["dest"][0].numpy(), "gid_s": trace["gid_s"][0].numpy(),
            "halo_ids": trace["halo_ids"][0].numpy(), "nbr_idx": sr["nbr_global"].numpy(),
            "final_mask": sr["nbr_mask"].numpy(), "demand": int(sr["demand"])}


def _replay_case(mesh, case: dict):
    """The sharded force of the ranks, gathered, and (rank 0) the same
    D-rank force replayed in this one process (``ReplayGroup``)."""
    from nbody3d_tpu_torch.parallel.exchange import DistGroup, ReplayGroup

    force, full, shards = _mesh_force(mesh, case)
    g = case.get("G", 1e-4)
    got = sharded.gather_rows(force.accel(DistGroup(mesh.rank, mesh.size), [shards[mesh.rank]], g)[0], mesh)
    replay = torch.cat(force.accel(ReplayGroup(mesh.size), list(shards), g)) if mesh.rank == 0 else None
    return {"ranks": got.numpy(), "replay": None if replay is None else replay.numpy()}


CASES = {"step": _step_case, "p3m_stages": _p3m_stages_case, "replay": _replay_case, "diag": _diag_case,
         "order": _order_case, "engine": _engine_case, "render": _render_case, "regenerate": _regenerate_case,
         "serve": _serve_case, "serve_import_fails": _serve_import_fails_case, "mesh": _mesh_case,
         "mesh_errors": _mesh_errors_case,
         "checkpoint_dir": _checkpoint_dir_case}
# The cases whose every rank's result comes back (each rank's view).
EVERY_RANK = ("mesh", "p3m_stages", "render", "regenerate", "serve", "serve_import_fails", "checkpoint_dir")


def run_cases(rank: int, world: int, cases: list[dict]):
    """Run ``cases`` (each ``{"kind": ..., "mesh": "x" | (rows, cols),
    ...}``) in order; rank 0 returns their results, and every rank
    those of the :data:`EVERY_RANK` cases."""
    out = []
    for case in cases:
        res = CASES[case["kind"]](_mesh(case.get("mesh", "x")), case)
        out.append(res if rank == 0 or case["kind"] in EVERY_RANK else None)
    if any(m.split(".")[0] == "nbody3d_tpu" for m in sys.modules):
        raise RuntimeError("a rank of the port imported the JAX package")
    return out


def raise_on(rank: int, world: int, bad: int):
    """Rank ``bad`` raises; the others wait for it in a collective."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def hang_on(rank: int, world: int, bad: int):
    """Rank ``bad`` never reaches the collective the others wait in."""
    if rank == bad:
        import time

        time.sleep(3600)
    dist.barrier()


def env_of(rank: int, world: int):
    """What a rank sees of its process: whether jax is loaded, its threads."""
    return {"jax": "jax" in sys.modules, "threads": torch.get_num_threads(), "pid": os.getpid(),
            "rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend()}


def peers_running_after(rank: int, world: int, delay: float):
    """Rank 0 waits ``delay`` seconds after every rank has returned and
    says, rank by rank, whether the others' processes still run: a rank
    that is done must stay in its group until every rank is done (Linux
    ``/proc``).  The other ranks return None at once."""
    import time

    pids = [None] * world
    dist.all_gather_object(pids, os.getpid())
    if rank != 0:
        return None
    time.sleep(delay)
    running = []
    for pid in pids[1:]:
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except FileNotFoundError:
            state = "gone"
        running.append(state not in ("Z", "X", "gone"))
    return running
