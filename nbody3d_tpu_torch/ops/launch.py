"""What every kernel wrapper shares: input checks, the launch, launch counts.

The nine kernels (sources in ``nbody3d_tpu_torch/csrc/``, built by
``_build``) and their wrappers:

==================  ===================  ===================================
kernel              wrapper module       computes
==================  ===================  ===================================
``force_exact``     ``cuda_force``       all-pairs f32 force (exact mode)
``sym_diag_prep``   ``cuda_force``       sym step 1: source rows, in-tile
``sym_hops``        ``cuda_force``       sym step 2: off-diagonal tile pairs
``sym_epilogue``    ``cuda_force``       sym step 3: sum, mask, Verlet
``vjp_full``        ``force_vjp``        force VJP, every target x source
``vjp_sym_diag``    ``force_vjp``        sym VJP 1: in-tile pairs
``vjp_sym_hops``    ``force_vjp``        sym VJP 2: off-diagonal tile pairs
``vjp_combine``     ``force_vjp``        sym VJP 3: sum, scale by G, Ḡ
``splat_resolve``   ``render.resolve``   the renderer's depth-min resolve
==================  ===================  ===================================

A wrapper checks its tensors (dtype, shape, contiguous, one device, no
autograd: the kernels never see a tensor that requires grad; gradients
reach them through ``force_vjp.make_diff_accel`` and the sym step's
``torch.autograd.Function``), takes its plain twin only because the tensors
lie on the CPU, and otherwise launches through :func:`launch`, which adds
one to the kernel's count.
"""

from __future__ import annotations

import torch

KERNELS = (
    "force_exact", "sym_diag_prep", "sym_hops", "sym_epilogue",
    "vjp_full", "vjp_sym_diag", "vjp_sym_hops", "vjp_combine",
    "splat_resolve",
)
MAX_TILE = 1024  # threads per CUDA block

_LAUNCHES = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def check_rows(name: str, *tensors: torch.Tensor, width: int = 4) -> torch.device:
    """Every tensor float32, ``(N, width)``, contiguous, on one CPU or CUDA
    device, and not requiring grad.  Returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
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
