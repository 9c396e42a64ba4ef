"""The equal-count spatial exchange of the sharded P3M step.

The JAX package's ``nbody3d_tpu/parallel/exchange.py`` in PyTorch's idiom.
Each rank keeps O(N/D) rows; no rank ever holds the N rows:

1. Local Morton keys against the global box (``ops/morton.py::
   morton_keys_box``, the box from one MIN/MAX all-reduce).
2. :func:`select_splitters`: the D-1 order statistics of the (key, gid)
   tuples at global ranks ``r * shard`` by bisection, ~31 + log2(N) rounds
   of an all-reduce of D-1 counts.  gid (the engine row) breaks key ties
   as a stable sort by key of the concatenated rows does, so the partition
   is the global stable sort's equal-count slices.
3. :func:`exchange_to_sorted`: the rows go round the ring; each rank keeps
   those destined for it (:func:`destinations`, from the replicated
   splitters: destinations never cross the wire), exactly ``shard`` of
   them, and sorts them by (key, gid): rank ``my`` ends with
   ``sorted[my*shard : (my+1)*shard]``.
4. :func:`inverse_exchange`: per-row results ride the ring back to their
   engine rows by gid.
5. :func:`ring_halo_fill`: the sorted slices go round the ring once more
   and each rank copies the remote tiles its neighbour lists want into its
   halo.

Every function is one rank's local work over the ranks that a
:class:`RankGroup` holds, with the collectives that join the ranks as the
group's methods: :class:`DistGroup` holds this process's rank of a
``torch.distributed`` group (one entry a list), :class:`ReplayGroup` all D
ranks in one process, a sum or a concatenation over the list where the
collective was (``chip_smoke.py`` phase 18a replays a D-rank step on one
card so).  A ring hop fills the rows it keeps by a ``cumsum`` of its mask
into a buffer with one spare "drop" row, as JAX's ``mode="drop"`` scatters
do, so no round and no hop reads a count on the host.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import torch
import torch.distributed as dist

from nbody3d_tpu_torch.ops.morton import PAD_KEY
from nbody3d_tpu_torch.parallel.mesh import all_gather_single

Tensors = Sequence[torch.Tensor]


class RankGroup:
    """The ranks of a sharded step that this process holds (``ranks``, in
    order; per-rank values are lists in that order) out of ``d``, and the
    collectives over all ``d``.  ``sum`` adds floating values in rank order
    (``((x0 + x1) + x2) + ...``), so every rank and a replay get the same
    bits; ``amin``/``amax``/``cat`` and integer sums are exact in any
    order.  ``ring(xs)`` yields, hop by hop, what each held rank sees of a
    ring of tuples: at hop k the tuple of rank ``my - k``."""

    d: int
    ranks: tuple[int, ...]

    def sum(self, xs: Tensors) -> torch.Tensor:
        raise NotImplementedError

    def amin(self, xs: Tensors) -> torch.Tensor:
        raise NotImplementedError

    def amax(self, xs: Tensors) -> torch.Tensor:
        raise NotImplementedError

    def cat(self, xs: Tensors) -> torch.Tensor:
        raise NotImplementedError

    def ring(self, xs: Sequence[tuple]) -> Iterator[list[tuple]]:
        raise NotImplementedError


def _fold(op, xs) -> torch.Tensor:
    """``op(...op(op(xs[0], xs[1]), xs[2])...)``: rank order."""
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x)
    return acc


class ReplayGroup(RankGroup):
    """All ``d`` ranks in this process: the collectives are sums,
    reductions and concatenations over the list."""

    def __init__(self, d: int):
        self.d = d
        self.ranks = tuple(range(d))

    def sum(self, xs):
        return _fold(torch.add, xs)

    def amin(self, xs):
        return _fold(torch.minimum, xs)

    def amax(self, xs):
        return _fold(torch.maximum, xs)

    def cat(self, xs):
        return torch.cat(list(xs))

    def ring(self, xs):
        for k in range(self.d):
            yield [xs[(r - k) % self.d] for r in self.ranks]


class DistGroup(RankGroup):
    """This process's rank of the initialized ``torch.distributed`` world,
    ``d`` ranks in rank order (a 2-D mesh's ranks row-major, as the JAX
    package flattens its mesh axes).  The ring posts the transfer of hop
    k+1 (send to ``my + 1``, receive from ``my - 1``) before hop k's tuple
    is used and waits for it before hop k+1's, into two buffers used in
    turn (``sharded._ring_sources``' schedule)."""

    def __init__(self, rank: int, d: int):
        self.d = d
        self.ranks = (rank,)

    @property
    def group(self):
        return dist.group.WORLD

    def sum(self, xs):
        (x,) = xs
        if not x.is_floating_point():
            out = x.clone()
            dist.all_reduce(out, group=self.group)
            return out
        return _fold(torch.add, self._gather(x))

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.d,) + tuple(x.shape))
        all_gather_single(out.view(-1), x.contiguous().view(-1), group=self.group)
        return out

    def _reduce(self, xs, op):
        (x,) = xs
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def amin(self, xs):
        return self._reduce(xs, dist.ReduceOp.MIN)

    def amax(self, xs):
        return self._reduce(xs, dist.ReduceOp.MAX)

    def cat(self, xs):
        (x,) = xs
        return self._gather(x).reshape((-1,) + tuple(x.shape[1:]))

    def ring(self, xs):
        (first,) = xs
        d, (my,) = self.d, self.ranks
        bufs = (tuple(torch.empty_like(t) for t in first), tuple(torch.empty_like(t) for t in first))
        cur = tuple(t.contiguous() for t in first)
        for k in range(d):
            reqs = ()
            if k + 1 < d:
                nxt = bufs[k % 2]
                ops = [dist.P2POp(dist.isend, t, (my + 1) % d, self.group) for t in cur]
                ops += [dist.P2POp(dist.irecv, t, (my - 1) % d, self.group) for t in nxt]
                reqs = dist.batch_isend_irecv(ops)
            yield [cur]
            for req in reqs:
                req.wait()
            if reqs:
                cur = nxt


# ------------------------------------------------------------- splitters
def count_le(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """One rank's ``(d-1,)`` counts of its keys ``<= vals[r]``."""
    return torch.sum(keys[None, :] <= vals[:, None], dim=1)


def count_lt(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return torch.sum(keys[None, :] < vals[:, None], dim=1)


def count_gid_le(keys: torch.Tensor, gids: torch.Tensor, K: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """One rank's counts of its rows with key ``== K[r]`` and gid ``<= vals[r]``."""
    return torch.sum((keys[None, :] == K[:, None]) & (gids[None, :] <= vals[:, None]), dim=1)


def _bisect(lo, hi, rounds: int, total_at: Callable, want: torch.Tensor):
    """``rounds`` halvings of ``[lo, hi]`` towards the least ``v`` with
    ``total_at(v) >= want``, all on the device."""
    for _ in range(rounds):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        ge = total_at(mid) >= want
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    return hi


def select_splitters(group: RankGroup, keys: Tensors, gids: Tensors, shard: int, n_total: int):
    """The exact splitters ``(K, Gs)``, each ``(d-1,)`` int64 and the same on
    every rank: the (key, gid) tuple at global rank ``r * shard`` (r = 1 ..
    d-1) of the order (key, gid) over all ``n_total`` rows.  ``keys`` and
    ``gids`` are the held ranks' ``(shard,)`` int32 rows; each round adds
    the ranks' :func:`count_le` (then :func:`count_lt`, :func:`count_gid_le`)
    with ``group.sum``."""
    d = group.d
    dev = keys[0].device
    ranks = torch.arange(1, d, device=dev, dtype=torch.int64) * shard
    keys = [k.long() for k in keys]
    gids = [g.long() for g in gids]
    # K_r = min{K : #(keys <= K) >= rank + 1}: 31 rounds over the int32 key
    # space (Morton keys are 30-bit, padding the maximum).
    zeros = torch.zeros(d - 1, dtype=torch.int64, device=dev)
    K = _bisect(zeros, torch.full_like(zeros, PAD_KEY), 31,
                lambda v: group.sum([count_le(k, v) for k in keys]), ranks + 1)
    # Within the run of equal keys: the (t_r)-th gid, t_r = rank - #(keys < K_r).
    t = ranks - group.sum([count_lt(k, K) for k in keys])
    giters = max(1, int(n_total - 1).bit_length())
    Gs = _bisect(zeros, torch.full_like(zeros, max(n_total - 1, 0)), giters,
                 lambda v: group.sum([count_gid_le(k, g, K, v) for k, g in zip(keys, gids)]), t + 1)
    return K, Gs


def destinations(keys: torch.Tensor, gids: torch.Tensor, K: torch.Tensor, Gs: torch.Tensor) -> torch.Tensor:
    """Each row's destination rank: how many splitter tuples ``(K_r, G_r)
    <= (key, gid)``, which is the equal-count slice of the global stable
    sort the row lands in."""
    keys, gids = keys.long()[None, :], gids.long()[None, :]
    ge = (keys > K[:, None]) | ((keys == K[:, None]) & (gids >= Gs[:, None]))
    return torch.sum(ge, dim=0)


# ---------------------------------------------------------- the exchanges
def _keep(recv: list, fill: torch.Tensor, vals: tuple, mask: torch.Tensor) -> torch.Tensor:
    """Write the rows of ``vals`` where ``mask`` after the ``fill`` rows
    already kept (each buffer has one spare last row, where the others go);
    the new fill."""
    spare = recv[0].shape[0] - 1
    slots = torch.where(mask, fill + torch.cumsum(mask, 0) - 1, spare)
    for buf, v in zip(recv, vals):
        buf[slots] = v
    return fill + torch.sum(mask)


def sort_local(pm: torch.Tensor, gids: torch.Tensor, keys: torch.Tensor):
    """Rows in (key, gid) order: a stable sort by gid, then a stable sort
    by key, as the global stable sort by key orders gid-ordered rows."""
    s1 = torch.argsort(gids, stable=True)
    order = s1[torch.argsort(keys[s1], stable=True)]
    return pm[order], gids[order]


def exchange_to_sorted(group: RankGroup, pms: Tensors, gids: Tensors, keys: Tensors, splitters):
    """Route every row to its destination rank and sort there: for each
    held rank ``(ps (shard, C), gid_s (shard,))``, its slice of the global
    (key, gid) order.  ``pms``/``gids``/``keys`` are the held ranks'
    resident rows; they ride the ring, and each receiver keeps what
    :func:`destinations` sends it."""
    K, Gs = splitters
    shard = pms[0].shape[0]
    recv = [[torch.empty((shard + 1,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device) for t in (p, g, k)]
            for p, g, k in zip(pms, gids, keys)]
    fill = [torch.zeros((), dtype=torch.int64, device=pms[0].device) for _ in pms]
    for visiting in group.ring(list(zip(pms, gids, keys))):
        for i, (me, (p, g, k)) in enumerate(zip(group.ranks, visiting)):
            fill[i] = _keep(recv[i], fill[i], (p, g, k), destinations(k, g, K, Gs) == me)
    return [sort_local(p[:shard], g[:shard], k[:shard]) for p, g, k in recv]


def inverse_exchange(group: RankGroup, values: Tensors, gids: Tensors, shard: int) -> list[torch.Tensor]:
    """Per-row ``values (shard, C)`` of the sorted layout (row identity
    ``gids``) back to the engine rows: rank ``gid // shard`` takes the row
    at local row ``gid % shard``.  Exact: gids are a permutation."""
    out = [v.new_zeros((shard + 1,) + tuple(v.shape[1:])) for v in values]
    for visiting in group.ring(list(zip(values, gids))):
        for i, (me, (v, g)) in enumerate(zip(group.ranks, visiting)):
            g = g.long()
            out[i][torch.where(g // shard == me, g - me * shard, shard)] = v
    return [o[:shard] for o in out]


def ring_halo_fill(group: RankGroup, ps: Tensors, slot_of: Tensors, tiles_per: int, block: int,
                   h_cap: int) -> list[torch.Tensor]:
    """Each held rank's halo ``(h_cap, block, 4)``: the sorted slices
    ``ps`` (``tiles_per`` tiles of ``block`` rows) go round the ring, and at
    each hop a rank copies the visiting tiles it wants into their slots;
    ``slot_of (nb,)`` maps a global tile to its halo slot (``h_cap``: not
    wanted; a rank's own tiles are never wanted)."""
    lane = torch.arange(tiles_per, device=ps[0].device)
    halo = [p.new_zeros((h_cap + 1, block, 4)) for p in ps]
    for hop, visiting in enumerate(group.ring([(p,) for p in ps])):
        for i, (me, (buf,)) in enumerate(zip(group.ranks, visiting)):
            owner = (me - hop) % group.d  # whose slice visits at this hop
            halo[i][slot_of[i][owner * tiles_per + lane]] = buf.view(tiles_per, block, 4)
    return [h[:h_cap] for h in halo]
