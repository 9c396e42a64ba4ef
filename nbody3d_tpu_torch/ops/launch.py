"""What every kernel wrapper shares: input checks, the launch, launch counts.

The nineteen kernels (sources in ``nbody3d_tpu_torch/csrc/``, built by
``_build``) and their wrappers:

====================  ===================  ===================================
kernel                wrapper module       computes
====================  ===================  ===================================
``force_exact``       ``cuda_force``       all-pairs f32 force (exact mode)
``sym_diag_prep``     ``cuda_force``       sym step 1: source rows, in-tile
``sym_hops``          ``cuda_force``       sym step 2: off-diagonal tile pairs
``sym_epilogue``      ``cuda_force``       sym step 3: sum, mask, Verlet
``sym_diag``          ``cuda_force``       uncentred sym force 1: in-tile
``sym_combine``       ``cuda_force``       sym force 3: sum the partials
``pair_sym``          ``cuda_force``       Newton-3 pairs of two disjoint sets
``fused_step_exact``  ``cuda_force``       exact force + Verlet, one launch
``force_fast``        ``cuda_force``       fast mode: bf16 tensor-core force
``fused_step_fast``   ``cuda_force``       fast force + Verlet, one launch
``vjp_full``          ``force_vjp``        force VJP, every target x source
``vjp_sym_diag``      ``force_vjp``        sym VJP 1: in-tile pairs
``vjp_sym_hops``      ``force_vjp``        sym VJP 2: off-diagonal tile pairs
``vjp_combine``       ``force_vjp``        sym VJP 3: sum, scale by G, Ḡ
``splat_resolve``     ``render.resolve``   the renderer's depth-min resolve
``short_range``       ``p3m``              P3M's block-sparse short-range pass
``short_range_bwd``   ``p3m``              its VJP: x̄, m̄ and σ̄, gather only
``mesh_deposit``      ``mesh_cuda``        TSC/CIC mass deposit onto the mesh
``mesh_gather``       ``mesh_cuda``        TSC/CIC interpolation of the forces
====================  ===================  ===================================

A wrapper checks its tensors (dtype, shape, contiguous, one device, no
autograd: the kernels never see a tensor that requires grad; gradients
reach them through ``force_vjp.make_diff_accel`` and the
``torch.autograd.Function``s of the sym step, P3M's short range and the
mesh legs), takes its plain twin only because the tensors
lie on the CPU, and otherwise launches through :func:`launch`, which adds
one to the kernel's count.
"""

from __future__ import annotations

import functools

import torch

KERNELS = (
    "force_exact", "sym_diag_prep", "sym_hops", "sym_epilogue", "sym_diag", "sym_combine", "pair_sym",
    "fused_step_exact", "force_fast", "fused_step_fast",
    "vjp_full", "vjp_sym_diag", "vjp_sym_hops", "vjp_combine",
    "splat_resolve", "short_range", "mesh_deposit", "mesh_gather", "short_range_bwd",
)
MAX_TILE = 1024  # threads per CUDA block

_LAUNCHES = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def check_rows(
    name: str, *tensors: torch.Tensor, width: int = 4, dtype: torch.dtype = torch.float32
) -> torch.device:
    """Every tensor of ``dtype``, ``(N, width)``, contiguous, on one CPU or
    CUDA device, and not requiring grad.  Returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name}: expected an (N, {width}) tensor, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: inputs require grad, but the kernels never take such "
                "tensors; differentiate through ops.step.make_step_fn or "
                "ops.force_vjp.make_diff_accel"
            )
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name}: no kernel for device {dev}")
    return dev


def check_tile(name: str, n: int, b: int, min_tiles: int = 2) -> int:
    """``nt = n / b`` for a tile ``b`` in ``[1, MAX_TILE]`` that divides
    ``n``; raises below ``min_tiles`` tiles."""
    if not 1 <= b <= MAX_TILE or n % b != 0:
        raise ValueError(f"{name}: tile {b} must divide N={n} and be in [1, {MAX_TILE}]")
    nt = n // b
    if nt < min_tiles:
        raise ValueError(f"{name}: needs nt >= {min_tiles} tiles, got N={n}, b={b}")
    return nt


def split_hops(nt: int) -> list[tuple[int, int, int]]:
    """``(k0, nk, grid_i)`` of each hop launch, as the JAX ``_sym_hops_raw``:
    call B (k = 1..half-1 for even nt, 1..half for odd) over every tile,
    then for even nt call C (the shared half hop) over tiles i < nt/2.
    Every unordered pair of distinct tiles falls in exactly one launch."""
    half = nt // 2
    calls = []
    nk_b = half - 1 if nt % 2 == 0 else half
    if nk_b > 0:
        calls.append((1, nk_b, nt))
    if nt % 2 == 0:
        calls.append((half, 1, half))
    return calls


# Source tiles a sym_hops, vjp_sym_hops or pair_sym block takes:
# csrc/sym_pairs.cuh kRun, which the C entry points check the grids against.
SYM_RUN = 8


def sym_runs(n_src: int, run: int = SYM_RUN) -> int:
    """Blocks along the run axis for ``n_src`` source tiles (or hops) taken
    in runs of ``run``, the last run cut short."""
    return -(-n_src // run)


def hop_blocks(nt: int, run: int = SYM_RUN) -> list[tuple[int, int, int, int]]:
    """``(k0, nk, grid_i, runs)`` of each ``sym_hops`` and ``vjp_sym_hops``
    launch: the launches of :func:`split_hops`, each a grid of ``grid_i``
    target tiles by ``runs`` runs of hops."""
    return [(k0, nk, grid_i, sym_runs(nk, run)) for k0, nk, grid_i in split_hops(nt)]


def hop_schedule(nt: int, run: int = SYM_RUN):
    """``(i, [j, ...])`` of every ``sym_hops`` and ``vjp_sym_hops`` block,
    launch by launch: its target tile and the source tiles of its run, in
    the kernel's order (block ``(i, r)`` takes hops ``k0 + r*run`` up to
    the launch's end)."""
    for k0, nk, grid_i, runs in hop_blocks(nt, run):
        for i in range(grid_i):
            for r in range(runs):
                ks = range(k0 + r * run, min(k0 + nk, k0 + (r + 1) * run))
                yield i, [(i + k) % nt for k in ks]


def pair_schedule(nt: int, ns: int, run: int = SYM_RUN):
    """``(i, [j, ...])`` of every ``pair_sym`` block: target tile ``i`` and
    its run of consecutive source tiles (block ``(i, r)`` takes run
    ``(r + i) mod runs``, source tiles from ``run`` times that up to
    ``ns``)."""
    runs = sym_runs(ns, run)
    for i in range(nt):
        for r in range(runs):
            first = (r + i) % runs * run
            yield i, list(range(first, min(ns, first + run)))


# force_exact and fused_step_exact (csrc/exact.cuh): target rows a block (2 a
# thread, 128 threads), sources a staged tile, the most CTAs a cluster.
EXACT_ROWS = 256
EXACT_TILE = 128
EXACT_MAX_SPLIT = 8
# CTAs an SM at which the row blocks alone fill the card: chosen on an H100
# (PERF.md section 6), where two-galaxy's 157 row blocks ran fastest
# at S = 6 of 1-8 (942 CTAs, 7.1 an SM) and the sphere's 1,024 (7.8 an SM)
# leave S = 1, bit for bit the first design.  vjp_full (exact.cuh's
# schedule with the VJP pair) also ran fastest at S = 6 there.
EXACT_FILL = 7
H100_SMS = 132


def exact_split(n_t: int, n_s: int, sms: int = H100_SMS) -> int:
    """CTAs S that take each block of ``EXACT_ROWS`` target rows of a
    ``force_exact``, ``fused_step_exact`` or ``vjp_full`` launch, each over
    a contiguous range of the ``EXACT_TILE``-source tiles
    (:func:`source_ranges`): 1 where the row blocks alone give
    ``EXACT_FILL`` CTAs an SM of ``sms``, else the least S that does, at
    most ``EXACT_MAX_SPLIT`` and the tile count."""
    blocks = -(-n_t // EXACT_ROWS)
    cap = max(1, min(EXACT_MAX_SPLIT, -(-n_s // EXACT_TILE)))
    return min(cap, -(-EXACT_FILL * sms // blocks))


def source_ranges(n_tiles: int, split: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` source tiles of each rank of ``split``, in rank order
    (csrc/exact.cuh range_start): contiguous, each tile in one range."""
    return [(r * n_tiles // split, (r + 1) * n_tiles // split) for r in range(split)]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def lib():
    from nbody3d_tpu_torch._build import load_library

    return load_library()


def launch(name: str, dev: torch.device, fn, *args) -> None:
    """Call a C entry point on ``dev``'s current stream; raise on a CUDA error."""
    for t in args:
        if isinstance(t, torch.Tensor) and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")
    c_args = [t.data_ptr() if isinstance(t, torch.Tensor) else t for t in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*c_args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    _LAUNCHES[name] += 1
