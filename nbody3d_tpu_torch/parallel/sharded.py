"""Sharded direct steps over a :class:`~nbody3d_tpu_torch.parallel.mesh.Mesh`.

The JAX package's ``nbody3d_tpu/parallel/sharded.py`` in PyTorch's idiom:
each rank holds its shard of ``(pos_mass, vel, accel)`` on its device, the
rows ``rank*shard .. (rank+1)*shard`` of the padded global state (ranks
row-major over the mesh axes), and one step is one force accumulation
followed by the integrator with the valid mask taken by global row.  The
force's exchange schedule, by ``config.strategy``:

- ``"ring"``: the source shard travels round the ring.  Hop k runs the
  force of the resident targets against the shard of rank ``my - k``;
  the transfer of hop k+1's shard (``batch_isend_irecv``: send to
  ``my + 1``, receive from ``my - 1``) is posted before hop k's force and
  waited for before hop k+1 reads it, into two buffers used in turn, so
  that the wire overlaps the force and no buffer in flight is written.
  Hop 0 is the shard against itself (``SELF_DIAG``), later hops have no
  self pair (``(NO_DIAG, 0, NO_DIAG)``).  With one rank the ring is the
  gather.
- ``"gather"``: every shard all-gathered, then the resident targets
  against all of them, the self pairs on the diagonal ``(my*shard, 0,
  NO_DIAG)``.
- ``"ringsym"`` (and ``"ring"`` with ``force_mode="sym"``): Newton-3 over
  the ring, :func:`make_ringsym_step`.
- ``"2d"``: the grid decomposition over a ``(rows, cols)`` mesh,
  :func:`make_grid2d_step`.

The hop's force is the single device's: ``force_exact`` (no mask: a zero
separation adds zero), ``force_fast`` with the hop's diagonal (``sym``
becomes ``fast`` on gather and 2d, as in the JAX package), the sym chain
and ``pair_sym`` for ringsym, or on the plain route (``backend="jnp"``)
``accel_partial``.  The functions that make one rank's hop
(:func:`hop_force`, :func:`ring_diag`, :func:`gather_diag`,
:func:`grid_diag`, :class:`SymHops`) are what the steps call; a replay of
a D-rank run in one process (``chip_smoke.py`` phase 17a) calls them with
slices of one state in place of the collectives.

Mesh methods (``pm``, ``p3m``) take their own schedules whatever the
strategy, their bodies sharded over every rank of the mesh (a 2-D mesh's
ranks row-major): :func:`make_pm_sharded_step` (one grid sum a force
evaluation) and :func:`make_p3m_sharded_step` (the splitter exchange into
the Morton-sorted layout, the grid sum, the halo ring and the inverse
exchange, ``parallel/exchange.py``), whose forces ``parallel/mesh_force.py``
writes over a :class:`~nbody3d_tpu_torch.parallel.exchange.RankGroup`.
Their integrator tail, :func:`_finish_mesh_step`, runs the static
integrators or, with a comoving background, ``ops/expansion.py``'s
kick-drift with ``rho_bar`` from the summed mass.  The sharded steps have
no gradient (the kernels refuse tensors that require grad).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.ops import diagnostics as diag
from nbody3d_tpu_torch.ops.cuda_force import NO_DIAG, SELF_DIAG, accel_pair_sym, force_exact, force_fast
from nbody3d_tpu_torch.ops.force_torch import accel_partial
from nbody3d_tpu_torch.ops.integrate import integrate_from_accum
from nbody3d_tpu_torch.ops.step import (
    GPU_TILE, SYM_MAX_N, _check_supported, fit_block, make_sym_accel_fn, resolve_backend,
)
from nbody3d_tpu_torch.parallel.mesh import Mesh, all_gather_single, reduce_scatter_single
from nbody3d_tpu_torch.state import SimState

DISJOINT = (NO_DIAG, 0, NO_DIAG)
StepFn = Callable[[SimState, float, float], SimState]


# ------------------------------------------------------------ the state
def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """This rank's rows of the global (padded) ``state``, on its device:
    every rank holds the same global state (made from one seed) and keeps
    ``rank*shard .. (rank+1)*shard``."""
    n = state.pos_mass.shape[0]
    if n % mesh.size:
        raise ValueError(f"n_pad={n} not divisible by mesh size {mesh.size}")
    shard = n // mesh.size
    rows = slice(mesh.rank * shard, (mesh.rank + 1) * shard)
    p, v, a = (t[rows].to(mesh.device).clone() for t in (state.pos_mass, state.vel, state.accel))
    return SimState(p, v, a, state.step)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global rows of a sharded ``(shard, k)`` tensor, on every rank."""
    out = x.new_empty((x.shape[0] * mesh.size,) + tuple(x.shape[1:]))
    all_gather_single(out, x.contiguous())
    return out


def gather_state(state: SimState, mesh: Mesh) -> SimState:
    """The global state of a sharded one, on every rank (collective)."""
    return SimState(*(gather_rows(t, mesh) for t in (state.pos_mass, state.vel, state.accel)), state.step)


def broadcast_int(value: int, mesh: Mesh) -> int:
    """Rank 0's ``value`` on every rank (collective; a host sync)."""
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, 0)
    return int(t.item())


# ------------------------------------------------------ one rank's hops
def _partial(tgt: torch.Tensor, src: torch.Tensor, G: float, diag_, eps2: float) -> torch.Tensor:
    """The plain route's hop: ``accel_partial`` on the source rows
    ``[x, y, z, G*m]``, transposed, with the diagonal ``(off, lo, hi)``."""
    off, lo, hi = diag_
    src_t = torch.cat([src[:, :3], src[:, 3:4] * float(G)], dim=1).T
    return accel_partial(tgt, src_t, off, eps2=eps2, diag_lo=lo, diag_hi=hi)


def hop_force(config: SimConfig, device: torch.device | str) -> Callable:
    """``force(tgt, src, G, diag) -> (N_t, 4)`` of one hop of the ring,
    gather and 2-D steps on ``device``'s route: ``force_exact`` (no mask:
    the self pair adds zero), ``force_fast`` with the diagonal ``diag =
    (off, lo, hi)`` (``sym`` runs as ``fast`` here), or on the plain route
    ``accel_partial`` with the same diagonal."""
    eps2 = config.eps2
    if resolve_backend(config, device) == "plain":
        return lambda tgt, src, G, diag_: _partial(tgt, src, G, diag_, eps2)
    mode = "fast" if config.force_mode == "sym" else config.force_mode
    if mode == "exact":
        return lambda tgt, src, G, diag_: force_exact(tgt, src, G, eps2)
    if mode == "fast":
        return lambda tgt, src, G, diag_: force_fast(tgt, src, G, eps2, diag_)
    raise ValueError(f"unknown force_mode {config.force_mode!r}")


def ring_diag(k: int) -> tuple[int, int, int]:
    """Hop k's diagonal: the resident shard against itself at hop 0, no
    self pair after."""
    return SELF_DIAG if k == 0 else DISJOINT


def gather_diag(my: int, shard: int) -> tuple[int, int, int]:
    """Local row r is global ``my*shard + r``, the gathered source column."""
    return (my * shard, 0, NO_DIAG)


def grid_diag(r: int, c: int, m: int) -> tuple[int, int, int]:
    """The 2-D tile's self pairs: source column ``row + (r - c)*m`` for
    target rows in ``[c*m, (c+1)*m)`` only (the source set joins pieces
    that are not neighbours, so the unrestricted diagonal would mask one
    real pair a row outside that range)."""
    return ((r - c) * m, c * m, (c + 1) * m)


class SymHops:
    """One rank's Newton-3 hops of :func:`make_ringsym_step` on
    ``device``'s route, for shards of ``shard`` rows.

    ``self_force(pm, G)``: the shard against itself (the kernel route's
    sym chain, ``make_sym_accel_fn``); ``pair_force(tgt, src, G)``: the
    target-side and source-side partials of two disjoint shards (the kernel
    route's ``pair_sym``, on ``src_chunks`` source chunks of whole tiles:
    as few as hold at most ``SYM_MAX_N`` rows each, unless given)."""

    def __init__(self, config: SimConfig, shard: int, device, src_chunks: int | None = None):
        self.eps2 = config.eps2
        self.route = resolve_backend(config, device)
        if self.route == "kernels" and config.force_mode == "exact":
            # The JAX package's refusal (its ringsym is the bf16 sym schedule);
            # the port adds no configuration it lacks.
            raise ValueError(
                "strategy 'ringsym' runs the Newton-3 sym schedule (force_mode='sym'), "
                "as in the JAX package; use strategy='ring' with force_mode='exact' "
                "for the exact force"
            )
        self.b = fit_block(shard, min(config.block_target, GPU_TILE))
        nt = shard // self.b
        if src_chunks is None:
            src_chunks = -(-shard // SYM_MAX_N)
            while nt % src_chunks:
                src_chunks += 1
        if src_chunks < 1 or nt % src_chunks:
            raise ValueError(f"{src_chunks} source chunks do not split {nt} tiles of {self.b} evenly")
        self.src_chunks = src_chunks
        self._sym = make_sym_accel_fn(config, shard) if self.route == "kernels" else None

    def self_force(self, pm: torch.Tensor, G: float) -> torch.Tensor:
        if self._sym is not None:
            return self._sym(pm, G)
        return _partial(pm, pm, G, SELF_DIAG, self.eps2)

    def pair_force(self, tgt: torch.Tensor, src: torch.Tensor, G: float) -> tuple[torch.Tensor, torch.Tensor]:
        if self._sym is None:
            # The plain route: two partial sums, no weight shared.
            return _partial(tgt, src, G, DISJOINT, self.eps2), _partial(src, tgt, G, DISJOINT, self.eps2)
        size = src.shape[0] // self.src_chunks
        at, ars = None, []
        for a in range(self.src_chunks):
            at_a, ar_a = accel_pair_sym(tgt, src[a * size : (a + 1) * size], G, eps2=self.eps2, b=self.b)
            at = at_a if at is None else at + at_a
            ars.append(ar_a)
        return at, (ars[0] if len(ars) == 1 else torch.cat(ars))


def ringsym_keeps(k: int, my: int, d: int) -> bool:
    """Whether rank ``my`` computes pair hop ``k``: all do, but for even D
    the last hop pairs ranks ``i`` and ``i + D/2`` twice, and only ``i <
    D/2`` computes it."""
    return not (d % 2 == 0 and k == d // 2 and my >= d // 2)


# -------------------------------------------------------- the exchanges
def _ring_sources(first: torch.Tensor, n: int, mesh: Mesh, axis: str):
    """Yield the ``n`` shards a ring visits: ``first``, then each one
    received from the previous rank while it goes on to the next.  The
    transfer of shard k+1 is posted before shard k is yielded and waited
    for before it is yielded; two receive buffers take turns, and one is
    written again only after its send was waited for."""
    d, my = mesh.axis_size(axis), mesh.rank
    group = mesh.groups[axis]
    bufs = (torch.empty_like(first), torch.empty_like(first))
    cur = first
    for k in range(n):
        reqs = ()
        if k + 1 < n:
            nxt = bufs[k % 2]
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, (my + 1) % d, group),
                dist.P2POp(dist.irecv, nxt, (my - 1) % d, group),
            ])
        yield cur
        for req in reqs:
            req.wait()
        if reqs:
            cur = nxt


def _shift_back(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` of rank ``my + 1``: send to ``my - 1``, receive from ``my + 1``."""
    d, my = mesh.axis_size(axis), mesh.rank
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, (my - 1) % d, mesh.groups[axis]),
        dist.P2POp(dist.irecv, out, (my + 1) % d, mesh.groups[axis]),
    ]):
        req.wait()
    return out


def _valid(shard: int, row0: int, n_real: int, device) -> torch.Tensor:
    """The ``(shard, 1)`` mask of real rows, by global row."""
    return torch.arange(row0, row0 + shard, device=device)[:, None] < n_real


def _integrated(config: SimConfig, accum: Callable, n_pad: int, n_real: int, mesh: Mesh) -> StepFn:
    """The step: ``config.integrator`` over the force closure
    ``accum(pos_mass, G)`` (re-run for each force evaluation: yoshida4
    runs the whole exchange three times), rows by global index."""
    shard = n_pad // mesh.size
    valid = _valid(shard, mesh.rank * shard, n_real, mesh.device) if n_real < n_pad else None

    def step(state: SimState, dt: float, G: float) -> SimState:
        g = float(G)
        p, v, a = integrate_from_accum(
            config.integrator, lambda pm: accum(pm, g), state.pos_mass, state.vel, state.accel, float(dt), valid
        )
        return SimState(p, v, a, state.step + 1)

    return step


# ------------------------------------------------------------- the steps
def make_sharded_step(
    config: SimConfig, n_pad: int, n_real: int, mesh: Mesh, *, src_chunks: int | None = None
) -> StepFn:
    """``step(state, dt, G) -> state`` on this rank's shard.  ``n_pad``
    must split into equal shards (the engine pads to ``pad_multiple ×
    mesh.size``); ``src_chunks`` is ringsym's source chunk count
    (:class:`SymHops`)."""
    _check_supported(config)
    if config.cosmology != "none":
        from nbody3d_tpu_torch.ops.expansion import validate_cosmo_config

        validate_cosmo_config(config)  # a comoving run needs a mesh method: direct fails here
    if config.method == "pm":
        # The grid replaces the pairwise exchange: one grid sum a force
        # evaluation, whatever the strategy says.
        return make_pm_sharded_step(config, n_pad, n_real, mesh)
    if config.method == "p3m":
        return make_p3m_sharded_step(config, n_pad, n_real, mesh)
    if n_pad % mesh.size:
        raise ValueError(f"n_pad={n_pad} not divisible by mesh size {mesh.size}")
    if config.strategy == "2d":
        return make_grid2d_step(config, n_pad, n_real, mesh)
    if config.strategy == "ringsym" or (config.strategy == "ring" and config.force_mode == "sym"):
        return make_ringsym_step(config, n_pad, n_real, mesh, src_chunks=src_chunks)
    if config.strategy not in ("ring", "gather"):
        raise ValueError(f"unknown strategy {config.strategy!r}")
    axis = config.mesh_axis
    d = mesh.axis_size(axis)
    if d != mesh.size:
        raise ValueError(f"strategy {config.strategy!r} needs a 1-D mesh, got {mesh.shape}")
    shard = n_pad // d
    my = mesh.rank
    force = hop_force(config, mesh.device)

    if config.strategy == "gather" or d == 1:

        def accum(pm, G):
            return force(pm, gather_rows(pm, mesh), G, gather_diag(my, shard))

    else:

        def accum(pm, G):
            acc = torch.zeros_like(pm)
            for k, src in enumerate(_ring_sources(pm, d, mesh, axis)):
                acc += force(pm, src, G, ring_diag(k))
            return acc

    return _integrated(config, accum, n_pad, n_real, mesh)


def make_ringsym_step(
    config: SimConfig, n_pad: int, n_real: int, mesh: Mesh, *, src_chunks: int | None = None
) -> StepFn:
    """Newton-3 ring: each unordered pair of shards computed by one rank,
    both directions from one weight a pair.  Hop 0 is the shard against
    itself; then ``H = D//2`` forward hops bring the shard of ``my - k``
    (the next one's transfer posted before this hop's force), whose
    source-side partial ``rev_k`` is owed to rank ``my - k``; for even D
    the last hop is shared and only ranks ``< D/2`` compute it (every rank
    still forwards).  The partials go home on a carry rotated backward H
    hops: ``rev_k`` is added before the carry's k-th remaining shift, so
    it moves k ranks back.  H forward and H backward shifts of a shard:
    the plain ring's wire bytes for half its force work."""
    axis = config.mesh_axis
    d = mesh.axis_size(axis)
    if d != mesh.size:
        raise ValueError(f"strategy 'ringsym' needs a 1-D mesh, got {mesh.shape}")
    shard = n_pad // d
    my = mesh.rank
    hops = SymHops(config, shard, mesh.device, src_chunks)
    n_hops = d // 2

    def accum(pm, G):
        acc = hops.self_force(pm, G)
        revs = []
        sources = _ring_sources(pm, n_hops + 1, mesh, axis)
        next(sources)  # hop 0: the resident shard
        for k, src in enumerate(sources, start=1):
            if ringsym_keeps(k, my, d):
                at, ar = hops.pair_force(pm, src, G)
                acc += at
            else:
                ar = torch.zeros_like(pm)
            revs.append(ar)
        carry = torch.zeros_like(pm)
        for k in range(n_hops, 0, -1):
            carry = _shift_back(carry + revs[k - 1], mesh, axis)
        return acc + carry

    return _integrated(config, accum, n_pad, n_real, mesh)


def make_grid2d_step(config: SimConfig, n_pad: int, n_real: int, mesh: Mesh) -> StepFn:
    """2-D grid decomposition over a ``(R, C)`` mesh: rank ``(r, c)`` owns
    global rows ``(r*C + c)*m ..`` (``m = n_pad/D``) and computes the tile
    [target segment r] x [source set c]:

      targets = all-gather over "col"        -> rows r*n/R .. (r+1)*n/R
      sources = all-gather over "row"        -> the C-th pieces, (n/C, 4)
      partial = the tile force, diagonal :func:`grid_diag`
      accel   = reduce-scatter over "col"    -> this rank's m rows

    ~n/R + n/C + n/R rows a step on the wire against the ring's n."""
    if len(mesh.axis_names) != 2:
        raise ValueError(f"strategy '2d' needs a 2-axis mesh, got {mesh.axis_names}")
    ax_r, ax_c = mesh.axis_names
    nrows, ncols = mesh.shape
    m = n_pad // mesh.size
    r, c = mesh.coords
    force = hop_force(config, mesh.device)
    col, row = mesh.groups[ax_c], mesh.groups[ax_r]

    def accum(pm, G):
        tgt = pm.new_empty((m * ncols, 4))
        all_gather_single(tgt, pm, group=col)
        src = pm.new_empty((m * nrows, 4))
        all_gather_single(src, pm, group=row)
        part = force(tgt, src, G, grid_diag(r, c, m))
        out = torch.empty_like(pm)
        reduce_scatter_single(out, part, group=col)
        return out

    return _integrated(config, accum, n_pad, n_real, mesh)


def _finish_mesh_step(config: SimConfig, accum: Callable, group, n_pad: int, n_real: int, mesh: Mesh) -> StepFn:
    """The integrator tail of the sharded mesh steps: the static
    integrators over ``accum(pos_mass, G)``, or with a comoving background
    ``ops/expansion.py``'s kick-drift, its ``rho_bar`` from the mass summed
    over the ranks (``group.sum``: the same bits on every rank)."""
    if config.cosmology == "none":
        return _integrated(config, accum, n_pad, n_real, mesh)
    from nbody3d_tpu_torch.ops.expansion import _Windows, comoving_update

    shard = n_pad // mesh.size
    valid = _valid(shard, mesh.rank * shard, n_real, mesh.device) if n_real < n_pad else None
    inv_vol = 1.0 / float(config.box_size) ** 3
    windows = _Windows(config)

    def step(state: SimState, dt: float, G: float) -> SimState:
        dt, G = float(dt), float(G)
        rho_bar = group.sum([torch.sum(state.pos_mass[:, 3])]) * inv_vol
        new_p, new_w, g = comoving_update(config, accum(state.pos_mass, G), state.pos_mass, state.vel, state.step,
                                          dt, G, rho_bar, valid, windows)
        return SimState(new_p, new_w, g, state.step + 1)

    return step


def make_pm_sharded_step(config: SimConfig, n_pad: int, n_real: int, mesh: Mesh) -> StepFn:
    """Sharded particle mesh (``config.method == "pm"``): each rank
    CIC-deposits its rows onto the whole grid, the grids are summed over
    the ranks (4·M³ bytes a rank, whatever N), every rank solves the same
    problem and gathers at its rows (``mesh_force.ShardedPM``).  Any mesh
    shape: the bodies shard over all ranks."""
    from nbody3d_tpu_torch.parallel.mesh_force import ShardedPM

    return _mesh_step(ShardedPM, config, n_pad, n_real, mesh)


def make_p3m_sharded_step(config: SimConfig, n_pad: int, n_real: int, mesh: Mesh) -> StepFn:
    """Sharded P3M (``config.method == "p3m"``, ``mesh_force.ShardedP3M``):
    a rank's live buffers are O(N/D + halo).  Each force evaluation keys
    the rank's rows, moves them to their slice of the global Morton order
    (``exchange.select_splitters``/``exchange_to_sorted``), runs the mesh
    leg on that slice with one grid sum, the short range over the slice
    and a halo of remote tiles filled by the ring, and sends the results
    home (``exchange.inverse_exchange``).  On the torus: the fixed box, the
    wrapped keys, no heavy split, and ``rcut < L/2``."""
    from nbody3d_tpu_torch.parallel.mesh_force import ShardedP3M

    return _mesh_step(ShardedP3M, config, n_pad, n_real, mesh)


def _mesh_step(force_cls, config: SimConfig, n_pad: int, n_real: int, mesh: Mesh) -> StepFn:
    """The step of a ``mesh_force`` force on this rank of the process group."""
    from nbody3d_tpu_torch.parallel.exchange import DistGroup

    force = force_cls(config, n_pad, n_real, mesh.size, resolve_backend(config, mesh.device))
    group = DistGroup(mesh.rank, mesh.size)
    return _finish_mesh_step(config, lambda pm, G: force.accel(group, [pm], G)[0], group, n_pad, n_real, mesh)


# ----------------------------------------------------------- diagnostics
def make_sharded_diagnostics(config: SimConfig, n_pad: int, mesh: Mesh) -> Callable:
    """``compute(state, G) -> Diagnostics`` of a sharded state, the same
    on every rank: each rank's kinetic energy, momenta and mass, and the
    potential of its rows against the gathered positions (the self pair
    left out by global index, half of each pair), all summed in float32
    by one ``all_reduce`` (``ops/diagnostics.py``'s precision)."""
    shard = n_pad // mesh.size
    row0 = mesh.rank * shard
    # Rows a pair block, (rows, n_pad) at most 2^28 pairs: a power of two,
    # which fit_block halves to a divisor of any shard of whole granules.
    chunk = fit_block(shard, 1 << (min(1024, max(8, (1 << 28) // max(n_pad, 1))).bit_length() - 1))

    def compute(state: SimState, G: float) -> diag.Diagnostics:
        pm, vel = state.pos_mass, state.vel
        pe = diag.potential_energy(pm, G, eps2=config.eps2, chunk=chunk, sources=gather_rows(pm, mesh), row0=row0)
        parts = torch.cat([
            diag.kinetic_energy(pm, vel)[None], pe[None], diag.momentum(pm, vel),
            diag.angular_momentum(pm, vel), torch.sum(pm[:, 3])[None],
        ])
        dist.all_reduce(parts)
        ke, pe = parts[0], parts[1]
        return diag.Diagnostics(ke, pe, ke + pe, parts[2:5], parts[5:8], parts[8])

    return compute
