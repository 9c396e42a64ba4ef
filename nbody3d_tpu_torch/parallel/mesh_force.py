"""The sharded PM and P3M forces, one force evaluation over a :class:`RankGroup`.

The JAX package's ``make_pm_sharded_step``/``make_p3m_sharded_step``
(``nbody3d_tpu/parallel/sharded.py``) in PyTorch's idiom.  A force is
written once, stage by stage, over the ranks that a ``RankGroup``
(``parallel/exchange.py``) holds: per-rank values are lists, one entry a
held rank, and replicated values (the box, the grids, the splitters) are
single tensors made by the group's collectives.  The sharded step holds one
rank (:class:`~nbody3d_tpu_torch.parallel.exchange.DistGroup`); a replay of
a D-rank step in one process holds all D
(:class:`~nbody3d_tpu_torch.parallel.exchange.ReplayGroup`) and runs the
same code.

PM (:class:`ShardedPM`): each rank CIC-deposits its rows onto the whole
grid (the isolated box from the global bounds of the real rows), the grids
are summed over the ranks, every rank solves the same Poisson problem
(``pm.solve_potential``/``force_grids``, or ``ewald.spectral_accel_grids``
on the torus, with the interlaced second leg) and gathers at its rows.

P3M (:class:`ShardedP3M`), per force evaluation:

1. the global box of the real rows (MIN/MAX), the heavy split (each rank's
   candidates, all-gathered, re-sorted by gid, top-k with the lowest gid
   first among ties), Morton keys, and the exchange into the sorted layout
   (``exchange.py``; at D = 1 the local (key, gid) sort);
2. the TSC mesh leg on the rank's sorted slice: ``mesh_deposit``, the grid
   summed over the ranks, the solve, ``mesh_gather``; the net-force
   projection with summed moments;
3. the short range: tile AABBs all-gathered, the rank's rows of the
   neighbour selection (``p3m._select_neighbors(row0=, nrows=)``), the
   k-th distances all-gathered for the mutual mask; the halo of remote
   tiles those rows want, nearest first under ``h_cap`` (a stable sort,
   ``lax.top_k``'s order), made mutual by an all-gathered bitmap (a pair
   survives only if both owners kept the other's tile); the halo filled by
   the ring, and one ``short_range`` launch over ``[slice ; halo]`` with the
   rank's tiles as targets;
4. the inverse exchange to the engine rows, and the heavy bodies' exact
   pairs with the force on each heavy body summed over the ranks.

The kernels are those of one device (``mesh_cuda.deposit``/``gather``,
``p3m.short_range_tiles``) on the ``"kernels"`` route, their plain twins
on ``"plain"``.  ``trace``, a dict, collects each held rank's operands and
the stages' results for ``chip_smoke.py`` phase 18a's checks.
"""

from __future__ import annotations

import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.ops import mesh_cuda, p3m
from nbody3d_tpu_torch.ops import pm as pm_ops
from nbody3d_tpu_torch.ops.ewald import spectral_accel_grids, wrap_box
from nbody3d_tpu_torch.ops.morton import morton_keys_box
from nbody3d_tpu_torch.ops.step import fit_block
from nbody3d_tpu_torch.parallel import exchange
from nbody3d_tpu_torch.parallel.exchange import RankGroup

_BIG = 3.0e38  # padding rows' stand-in in the bound reductions


def _bounds(group: RankGroup, pos: list, valid: list):
    """Global ``(lo (3,), hi (3,))`` of the real rows: MIN/MAX of each
    rank's masked bounds, the same bits as bounding the gathered rows."""
    lo = group.amin([torch.amin(torch.where(v[:, None], p, _BIG), dim=0) for p, v in zip(pos, valid)])
    hi = group.amax([torch.amax(torch.where(v[:, None], p, -_BIG), dim=0) for p, v in zip(pos, valid)])
    return lo, hi


class _Shards:
    """What both forces share: the shard, the route, the rows' gids."""

    def __init__(self, config: SimConfig, n_pad: int, n_real: int, d: int, route: str):
        if n_pad % d:
            raise ValueError(f"n_pad={n_pad} not divisible by mesh size {d}")
        self.config, self.n_pad, self.n_real, self.d = config, n_pad, n_real, d
        self.shard = n_pad // d
        self.grid = config.pm_grid
        self.eps2 = float(config.eps2)
        self.periodic = config.boundary == "periodic"
        self.box = float(config.box_size)
        if self.periodic and self.box <= 0:
            raise ValueError("boundary='periodic' requires box_size > 0")
        self.plain = route == "plain"
        self.deposit = mesh_cuda.deposit_plain if self.plain else mesh_cuda.deposit

    def gather(self, grids, c4, fm, order: int, sorted_rows: bool):
        if self.plain:
            return mesh_cuda.gather_plain(grids, c4, fm, self.grid, order, self.periodic)
        return mesh_cuda.gather(grids, c4, fm, self.grid, order, self.periodic, sorted_rows=sorted_rows)

    def gids(self, group: RankGroup, dev) -> list[torch.Tensor]:
        return [torch.arange(r * self.shard, (r + 1) * self.shard, device=dev, dtype=torch.int32)
                for r in group.ranks]

    def torus(self, dev):
        """``(L, h)`` of the periodic box as f32 0-d tensors on ``dev``
        (filled there: no copy from the host, which would wait for the device)."""
        L = torch.full((), self.box, dtype=torch.float32, device=dev)
        return L, L / self.grid


class ShardedPM(_Shards):
    """The sharded PM force (``config.method == "pm"``)."""

    def accel(self, group: RankGroup, pms: list, G: float) -> list[torch.Tensor]:
        """Each held rank's ``(shard, 4)`` accelerations (w lane 0) of its
        rows ``pms``."""
        dev, grid = pms[0].device, self.grid
        mass = [p[:, 3] for p in pms]
        if self.periodic:
            L, h = self.torus(dev)
            lo = torch.zeros(3, dtype=torch.float32, device=dev)
            pos = [wrap_box(p[:, :3], L) for p in pms]

            def leg(shift):
                ops = [mesh_cuda.mesh_operands(*pm_ops._cic_cells(wrap_box(p + shift, L), lo, h, grid,
                                                                   periodic=True), m)
                       for p, m in zip(pos, mass)]
                rho = group.sum([self.deposit(c4, fm, grid, 2, True) for c4, fm in ops])
                grids = spectral_accel_grids(rho, L, pm_ops.PERIODIC_SIGMA_CELLS * h, order=2)
                return [self.gather(grids, c4, fm, 2, sorted_rows=False) for c4, fm in ops]

            acc = leg(0.0)
            if self.config.mesh_interlace:
                acc = [0.5 * (a + b) for a, b in zip(acc, leg(0.5 * h))]
            return [a * G for a in acc]
        valid = [g < self.n_real for g in self.gids(group, dev)]
        lo, h = pm_ops.box_from_bounds(*_bounds(group, [p[:, :3] for p in pms], valid), grid)
        ops = [mesh_cuda.mesh_operands(*pm_ops._cic_cells(p[:, :3], lo, h, grid), p[:, 3]) for p in pms]
        rho = group.sum([self.deposit(c4, fm, grid, 2) for c4, fm in ops])
        grids = pm_ops.force_grids(pm_ops.solve_potential(rho, h, self.eps2), h)
        return [self.gather(grids, c4, fm, 2, sorted_rows=False) * G for c4, fm in ops]


class ShardedP3M(_Shards):
    """The sharded P3M force (``config.method == "p3m"``); the static
    sizes as the JAX package picks them: tiles that divide a shard, the
    halo capacity ``p3m_halo_tiles`` (0: ``max(2·tiles_per, 4·nbr_k, 64)``,
    at most the remote tiles), no heavy split on the torus."""

    def __init__(self, config: SimConfig, n_pad: int, n_real: int, d: int, route: str):
        super().__init__(config, n_pad, n_real, d, route)
        self.block = fit_block(self.shard, p3m.p3m_block(n_pad, config.p3m_block))
        self.nb = n_pad // self.block
        self.tiles_per = self.nb // d
        self.nbr_k = min(config.p3m_nbr_k, self.nb)
        self.heavy_k = min(config.p3m_heavy_k, n_pad)
        if self.periodic:
            p3m.periodic_scales(self.grid, self.box, config.p3m_sigma_cells, config.p3m_rcut_sigmas)  # rcut < L/2
            self.heavy_k = 0  # no periodic form of the exact heavy pairs
        h_cap = int(config.p3m_halo_tiles)
        if h_cap <= 0:
            h_cap = max(2 * self.tiles_per, 4 * self.nbr_k, 64)
        self.h_cap = max(1, min(h_cap, max(self.nb - self.tiles_per, 1)))
        self.cand_k = min(self.heavy_k, self.shard)

    # ------------------------------------------------------- the stages
    def heavy_set(self, group: RankGroup, pms: list, gids: list):
        """``(hp (K, 4), hgid (K,))``, the same on every rank: the
        ``heavy_k`` most massive bodies, the lowest gid first among equal
        masses."""
        cand = [torch.sort(p[:, 3], descending=True, stable=True).indices[: self.cand_k] for p in pms]
        cand_pm = group.cat([p[c] for p, c in zip(pms, cand)])
        cand_gid = group.cat([g[c] for g, c in zip(gids, cand)])
        ordg = torch.argsort(cand_gid, stable=True)
        cm, cg = cand_pm[ordg], cand_gid[ordg]
        sel = torch.sort(cm[:, 3], descending=True, stable=True).indices[: self.heavy_k]
        return cm[sel], cg[sel]

    def sorted_slices(self, group: RankGroup, pm_k: list, gids: list, keys: list, trace=None):
        """Each held rank's ``(ps_raw, gid_s)``: its slice of the global
        (key, gid) order."""
        if self.d == 1:
            return [exchange.sort_local(p, g, k) for p, g, k in zip(pm_k, gids, keys)]
        splitters = exchange.select_splitters(group, keys, gids, self.shard, self.n_pad)
        if trace is not None:
            trace.update(splitters=splitters,
                         dest=[exchange.destinations(k, g, *splitters) for k, g in zip(keys, gids)])
        return exchange.exchange_to_sorted(group, pm_k, gids, keys, splitters)

    def mesh_leg(self, group: RankGroup, pos: list, mass: list, lo, h, sigma, L, trace=None) -> list:
        """One TSC leg at the sorted slices' (on the torus: wrapped)
        positions: deposit, the grids summed, the solve, the gather."""
        grid = self.grid
        ops = [mesh_cuda.mesh_operands(*p3m._tsc_cells(p, lo, h, grid, self.periodic), m)
               for p, m in zip(pos, mass)]
        rho = group.sum([self.deposit(c4, fm, grid, 3, self.periodic) for c4, fm in ops])
        if self.periodic:
            grids = spectral_accel_grids(rho, L, sigma, order=3)
        else:
            grids = p3m.solve_accel_long(rho, h, self.eps2, sigma, order=3)
        if trace is not None:
            trace.setdefault("mesh", []).append(dict(ops=ops, grids=grids))
        return [self.gather(grids, c4, fm, 3, sorted_rows=True) for c4, fm in ops]

    def halo(self, group: RankGroup, neg: list, nbr_idx: list, trace=None):
        """Each held rank's ``(slot_of (nb,), halo_ok (tiles_per, k),
        demand)``: the remote tiles its rows want, nearest first, in at most
        ``h_cap`` slots (``slot_of`` is ``h_cap`` for a tile it does not
        keep), and which of its pairs survive the truncation on both sides."""
        nb, tp, h_cap = self.nb, self.tiles_per, self.h_cap
        dev = neg[0].device
        wanted = []
        for me, ng, idx in zip(group.ranks, neg, nbr_idx):
            cross = idx // tp != me
            score = torch.full((nb,), -torch.inf, dtype=torch.float32, device=dev)
            score.scatter_reduce_(0, idx.reshape(-1), torch.where(cross, ng, -torch.inf).reshape(-1), "amax")
            top, ids = p3m._top_k(score, h_cap)
            wanted.append((torch.where(top > -torch.inf, ids, nb), torch.sum(score > -torch.inf)))
        if trace is not None:
            trace["halo_ids"] = [ids for ids, _ in wanted]
        # The bitmap of every rank's kept tiles (sentinel column nb).
        halo_all = group.cat([ids[None] for ids, _ in wanted])  # (d, h_cap)
        in_halo = torch.zeros((self.d, nb + 1), dtype=torch.bool, device=dev).scatter_(1, halo_all, True)
        out = []
        for me, idx, (ids, demand) in zip(group.ranks, nbr_idx, wanted):
            owner = idx // tp
            cross = owner != me
            i_tile = me * tp + torch.arange(tp, device=dev)[:, None]
            halo_ok = torch.where(cross, in_halo[me][idx] & in_halo[owner, i_tile], True)
            slot_of = torch.full((nb + 1,), h_cap, dtype=torch.int64, device=dev)
            slot_of[ids] = torch.arange(h_cap, device=dev)
            out.append((slot_of[:nb], halo_ok, demand))
        return out

    # -------------------------------------------------------- the force
    def accel(self, group: RankGroup, pms: list, G: float, trace: dict | None = None) -> list[torch.Tensor]:
        """Each held rank's ``(shard, 4)`` accelerations (w lane 0) of its
        resident rows ``pms``."""
        c = self.config
        dev, grid, tp, block = pms[0].device, self.grid, self.tiles_per, self.block
        gids = self.gids(group, dev)
        valid = [g < self.n_real for g in gids]
        if self.periodic:
            L, h = self.torus(dev)
            lo = torch.zeros(3, dtype=torch.float32, device=dev)
            pos_k = [wrap_box(p[:, :3], L) for p in pms]
        else:
            L, pos_k = None, [p[:, :3] for p in pms]
        lo_w, hi_w = _bounds(group, pos_k, valid)
        if not self.periodic:
            lo, h = pm_ops.box_from_bounds(lo_w, hi_w, grid)
        sigma = c.p3m_sigma_cells * h
        rcut = c.p3m_rcut_sigmas * sigma

        if self.heavy_k:
            hp, hgid = self.heavy_set(group, pms, gids)
        keys = [morton_keys_box(p, lo_w, hi_w, v) for p, v in zip(pos_k, valid)]
        pm_k = [torch.cat([pk, p[:, 3:4]], 1) for pk, p in zip(pos_k, pms)] if self.periodic else list(pms)
        slices = self.sorted_slices(group, pm_k, gids, keys, trace)
        gid_s = [g for _, g in slices]
        mass_s = [ps[:, 3] for ps, _ in slices]
        if self.heavy_k:
            mass_s = [torch.where((g[:, None] == hgid[None, :]).any(1), 0.0, m) for g, m in zip(gid_s, mass_s)]
        pos_s = [ps[:, :3] for ps, _ in slices]
        ps = [torch.cat([p, m[:, None]], 1).contiguous() for p, m in zip(pos_s, mass_s)]
        if trace is not None:
            trace.update(keys=keys, pm_k=pm_k, ps_raw=[s for s, _ in slices], gid_s=gid_s, ps=ps, lo=lo, h=h,
                         sigma=sigma, rcut=rcut, L=L)

        # The long range, and the net-force projection over all ranks.
        acc_m = self.mesh_leg(group, pos_s, mass_s, lo, h, sigma, L, trace)
        if self.periodic and c.mesh_interlace:
            shifted = [wrap_box(p + 0.5 * h, L) for p in pos_s]
            acc_m = [0.5 * (a + b) for a, b in zip(acc_m, self.mesh_leg(group, shifted, mass_s, lo, h, sigma, L,
                                                                          trace))]
        msum = torch.clamp(group.sum([torch.sum(m) for m in mass_s]), min=1e-30)
        wsum = group.sum([torch.sum(m[:, None] * a, dim=0) for m, a in zip(mass_s, acc_m)])
        acc_m = [a - wsum[None, :] / msum for a in acc_m]

        # The short range: the rank's rows of the selection, the halo, one launch.
        aabbs = [p3m._sorted_aabbs(s, self.n_real, block, row0=me * self.shard) for me, s in zip(group.ranks, ps)]
        lo_b, hi_b = group.cat([a[0] for a in aabbs]), group.cat([a[1] for a in aabbs])
        sel = [p3m._select_neighbors(lo_b, hi_b, h, self.nbr_k, L=L, row0=me * tp, nrows=tp) for me in group.ranks]
        kth_all = group.cat([kth for kth, _, _ in sel])
        neg = [ng for _, ng, _ in sel]
        nbr_idx = [idx for _, _, idx in sel]
        nbr_mask = [p3m.mutual_neighbor_mask(ng, idx, kth_all) for ng, idx in zip(neg, nbr_idx)]
        halos = self.halo(group, neg, nbr_idx, trace)
        filled = exchange.ring_halo_fill(group, ps, [s for s, _, _ in halos], tp, block, self.h_cap)
        acc = []
        for i, me in enumerate(group.ranks):
            slot_of, halo_ok, demand = halos[i]
            idx = nbr_idx[i]
            cross = idx // tp != me
            final_mask = nbr_mask[i] * halo_ok.to(torch.float32)
            nbr_local = torch.where(cross, tp + slot_of[idx], idx - me * tp)
            nbr_local = torch.where(final_mask > 0, nbr_local, 0)
            ps_src = torch.cat([ps[i], filled[i].reshape(-1, 4)]).contiguous()
            acc_s = p3m.short_range_tiles(ps_src, nbr_local, self.eps2, sigma, rcut, block, nbr_mask=final_mask,
                                          backend="jnp" if self.plain else "auto",
                                          box=self.box if self.periodic else None, nt=tp)
            if trace is not None:
                trace.setdefault("short_range", []).append(dict(ps=ps_src, nbr_idx=nbr_local, nbr_mask=final_mask,
                                                                nt=tp, demand=demand, nbr_global=idx))
            acc.append(acc_m[i] + acc_s)
        acc = exchange.inverse_exchange(group, acc, gid_s, self.shard)

        if self.heavy_k:
            parts = [p3m.heavy_pairs(p, hp, self.eps2) for p in pms]
            a_on = group.sum([on for _, on in parts])
            for i, ((a_from, _), g) in enumerate(zip(parts, gids)):
                match = g[:, None] == hgid[None, :]
                heavy = match.any(1)[:, None]
                acc[i] = torch.cat([torch.where(heavy, a_on[match.int().argmax(1)], acc[i][:, :3] + a_from),
                                    acc[i][:, 3:]], 1)
        return [a * G for a in acc]
