"""Fast mode (``force_mode="fast"``): the port's limb helpers, the twins
of ``force_fast`` and ``fused_step_fast`` (what the wrappers run on CPU
tensors) and the routes through ``make_step_fn``, ``Simulation`` and the
CLI, against the JAX package.

Tolerances, with their reasons:

- the limb helpers and ``round_to_bf16``: bit for bit (JAX's
  ``src_limbs``, ``_round_to_bf16_f32``, ``ml_dtypes``' round to nearest
  even);
- the twins against a numpy emulation of the MXU built from JAX's own
  operands (JAX's limbs and JAX-rounded weights, exact bf16 products,
  sequential f32 sums; ``tests/test_sym.py:126-134``): max-abs/scale
  <= 1e-5, the f32 summation of the emulation (the twin sums in f64);
- the twins against ``accel_pallas``/``fused_step_pallas(mode="fast")``
  in interpret mode, whose dots are f32 (no bf16 weights), and against the
  f64 direct sum: 5e-3 of scale, the bf16 weight noise
  (``tests/test_pallas.py:50-68``); a 1e7 body's own row 6e-3
  (``tests/test_sym.py:149-172``);
- steps: accelerations 5e-3 of scale; positions within 1e-6, velocities
  within 5e-3 of the acceleration scale times dt (what a 5e-3 force error
  moves in one step) plus 1e-6;
- gradients through two steps against ``jax.grad`` of the JAX package's
  fast step: 2e-3 of scale (the forwards differ by the bf16 weight noise
  only; the backward is the same ideal f32 VJP in both, the rollout
  tolerance of ``tests/test_grad.py``).
"""

import ml_dtypes
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.ops.pallas_force import NO_DIAG as JAX_NO_DIAG  # noqa: E402
from nbody3d_tpu.ops.pallas_force import (  # noqa: E402
    _round_to_bf16_f32,
    accel_pallas,
    fused_step_pallas,
    src_transposed,
)
from nbody3d_tpu.ops.pallas_force import src_limbs as jax_src_limbs  # noqa: E402
from nbody3d_tpu.ops.step import make_step_fn as jax_make_step_fn  # noqa: E402
from nbody3d_tpu.state import SimState as JaxState  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops.integrate import apply_integrator, valid_mask  # noqa: E402
from nbody3d_tpu_torch.ops.launch import KERNELS, launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-3
NO_DIAG = cf.NO_DIAG


def galaxy_like(rng, n, heavy=True, n_real=None):
    """``tests/test_sym.py``'s bodies: clustered, masses 10-50 and a 1e7
    central body; rows from ``n_real`` on are padding (mass 0)."""
    pm = np.concatenate(
        [rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    if heavy:
        pm[0, 3] = 1e7
    if n_real is not None:
        pm[n_real:, 3] = 0.0
    return pm


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def oracle_f64(tgt, src):
    """The f64 direct sum of ``tgt`` rows against ``src`` (self pairs,
    where the separation is zero, add nothing)."""
    d = src[None, :, :3].astype(np.float64) - tgt[:, None, :3].astype(np.float64)
    d2 = (d * d).sum(-1) + EPS2
    w = G * src[None, :, 3].astype(np.float64) * d2**-1.5
    return np.einsum("ts,tsc->tc", w, d)


# ------------------------------------------------------------ limb helpers
def test_round_to_bf16_matches_rtne_and_jax():
    """``tests/test_sym.py:358-381``'s values (ties, tiny, huge) and NaNs:
    bit for bit ml_dtypes' round to nearest even and JAX's bit rule."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.normal(scale=10.0, size=4096).astype(np.float32),
        rng.normal(scale=1e30, size=64).astype(np.float32),
        rng.normal(scale=1e-30, size=64).astype(np.float32),
        np.float32([0.0, -0.0, 1.0, 1e3, 2.0**-126, 3.4e38, -3.4e38, np.inf, -np.inf]),
        np.float32([1.00390625, 1.01171875, -1.00390625, -1.01171875]),  # exact ties
    ])
    got = cf.round_to_bf16(t(vals)).numpy()
    want = vals.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(_round_to_bf16_f32(jnp.asarray(vals))).view(np.uint32))
    nans = np.float32([np.nan, -np.nan]).copy()
    nans.view(np.uint32)[:] |= np.uint32(0x7FFF)  # payloads the +0x7FFF carry would launder
    assert np.isnan(cf.round_to_bf16(t(nans)).numpy()).all()


@pytest.mark.parametrize("n,g,n_real", [(64, 1e-4, 64), (300, 1e-4, 280), (128, 1.0, 128), (40, 3.7e-3, 33)])
def test_src_limbs_bit_equal_to_jax(rng, n, g, n_real):
    pm = galaxy_like(rng, n, n_real=n_real)
    got = cf.src_limbs(t(pm), g).numpy()
    want = np.asarray(jax_src_limbs(jnp.asarray(pm), g))
    assert got.shape == (n, 16)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # and the bf16 matrix is JAX's limbs as the MXU rounds its inputs
    mxu = want.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(cf.limbs_bf16(t(pm), g).float().numpy(), mxu)


def test_src_limbs_reconstruct():
    """``tests/test_pallas.py:72-84``: the three limbs reconstruct gm*x and
    gm to f32 exactness; columns 12-15 are zero."""
    rng = np.random.default_rng(0)
    pm = np.concatenate([rng.normal(scale=5, size=(64, 3)), rng.uniform(1, 50, (64, 1))], axis=1).astype(np.float32)
    s16 = cf.src_limbs(t(pm), G).numpy()
    gm = (G * pm[:, 3:4]).astype(np.float32)
    for c in range(3):
        recon = s16[:, 3 * c] + s16[:, 3 * c + 1] + s16[:, 3 * c + 2]
        np.testing.assert_allclose(recon, gm[:, 0] * pm[:, c], rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(s16[:, 9] + s16[:, 10] + s16[:, 11], gm[:, 0], rtol=1e-7)
    np.testing.assert_array_equal(s16[:, 12:], 0.0)
    # h and m are bf16 values, so only l rounds in the bf16 matrix
    for c in range(4):
        for limb in (3 * c, 3 * c + 1):
            col = s16[:, limb]
            np.testing.assert_array_equal(col, col.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("n", [16, 40, 256])
def test_fragment_order_is_the_mma_b_layout(n):
    """``fragment_order`` against the PTX rule of the m16n8k16 B fragment
    (``csrc/mma.cuh``): lane 4g + t of chunk c holds, for the MMA of
    columns 8nb..8nb+7, b0 = (B[2t][g'], B[2t+1][g']) and b1 = (B[2t+8][g'],
    B[2t+9][g']) with g' = 8nb + g; rows past N are zero."""
    rng = np.random.default_rng(n)
    b = t(rng.normal(size=(n, 16)).astype(np.float32)).to(torch.bfloat16)
    frag = cf.fragment_order(b)
    chunks = -(-n // 16)
    assert frag.shape == (chunks * 32, 8) and frag.dtype == torch.bfloat16 and frag.is_contiguous()
    bp = torch.zeros((chunks * 16, 16), dtype=torch.bfloat16)
    bp[:n] = b
    for c in range(chunks):
        for lane in range(32):
            g, tt = lane // 4, lane % 4
            want = [bp[16 * c + 8 * h + 2 * tt + e, 8 * nb + g] for nb in (0, 1) for h in (0, 1) for e in (0, 1)]
            assert torch.equal(frag[32 * c + lane], torch.stack(want))


# ----------------------------------------------- twins vs the JAX package
def jax_fast(tgt, src, bt=128, bs=128, **kw):
    return np.asarray(accel_pallas(
        jnp.asarray(tgt), src_transposed(jnp.asarray(src), G), jax_src_limbs(jnp.asarray(src), G),
        eps2=EPS2, block_target=bt, block_source=bs, mode="fast", interpret=True, **kw))


@pytest.mark.parametrize("n,bt,bs", [(512, 128, 256), (384, 128, 128)])
def test_twin_matches_jax_static_diagonal(rng, n, bt, bs):
    """The default ``static_diag`` (nomask + the diagonal companion), odd
    block count included, a 1e7 body among the targets."""
    pm = galaxy_like(rng, n)
    got = cf.force_fast(t(pm), t(pm), G, EPS2).numpy()
    want = jax_fast(pm, pm, bt, bs)
    assert got[:, 3].max() == got[:, 3].min() == 0.0
    assert rel(got, want) < 5e-3
    assert rel(got[0], want[0]) < 6e-3  # the heavy body's own row
    assert rel(got[:, :3], oracle_f64(pm, pm)) < 5e-3


def test_twin_matches_jax_disjoint_sets(rng):
    """``(NO_DIAG, 0, NO_DIAG)``: the first half's pull from the second."""
    pm = galaxy_like(rng, 256)
    tgt, src = pm[:128], pm[128:]
    got = cf.force_fast(t(tgt), t(src), G, EPS2, (NO_DIAG, 0, NO_DIAG)).numpy()
    want = jax_fast(tgt, src, static_diag=(JAX_NO_DIAG, 0, JAX_NO_DIAG))
    assert rel(got, want) < 5e-3
    assert rel(got[:, :3], oracle_f64(tgt, src)) < 5e-3


@pytest.mark.parametrize(
    "t0,nt,s0,lo,hi",
    [(128, 128, 0, 0, 128), (128, 256, 0, 32, 200), (64, 128, 0, 0, 64), (0, 256, 128, 128, 256)],
)
def test_twin_matches_jax_traced_diagonal(rng, t0, nt, s0, lo, hi):
    """``static_diag=None`` with a traced ``(offset, lo, hi)``: targets are
    rows ``t0 .. t0 + nt``, sources rows ``s0 ..`` (offset ``t0 - s0``,
    negative in the last case), and only target rows in ``[lo, hi)`` mask
    their self pair (the 2-D grid's restricted diagonal).  Rows outside
    the range keep their self weight and are not compared: the bf16
    softening-floor self term's f32 residue is not noise-bounded."""
    pm = galaxy_like(rng, 384)
    pm[t0 + lo, 3] = 1e7  # a heavy body on the masked diagonal
    tgt, src, off = pm[t0 : t0 + nt], pm[s0:], t0 - s0
    got = cf.force_fast(t(tgt), t(src), G, EPS2, (off, lo, hi)).numpy()
    want = jax_fast(tgt, src, diag_offset=off, diag_lo=lo, diag_hi=hi, static_diag=None)
    inside = np.arange(nt)
    inside = (inside >= lo) & (inside < hi)
    assert rel(got[inside], want[inside]) < 5e-3
    assert rel(got[:, :3][inside], oracle_f64(tgt, src)[inside]) < 5e-3


def _mxu_f32_dot(wmat, smat):
    """``tests/test_sym.py:126-134``: exact bf16 products, sequential f32
    accumulation."""
    out = np.zeros((wmat.shape[0], smat.shape[1]), np.float32)
    for c in range(smat.shape[1]):
        acc = np.zeros(wmat.shape[0], np.float32)
        for s in range(wmat.shape[1]):
            acc = (acc + wmat[:, s] * smat[s, c]).astype(np.float32)
        out[:, c] = acc
    return out


def _epilogue_np(a, pos):
    s = a[:, 9] + a[:, 10] + a[:, 11]
    return np.stack([a[:, 3 * c] + a[:, 3 * c + 1] + a[:, 3 * c + 2] - pos[:, c] * s for c in range(3)], axis=1)


def mxu_emulation(tgt, src, off, lo, hi):
    """The MXU's result from JAX's operands: its limbs rounded to bf16, its
    f32 weights (``lax.rsqrt`` of ``_pair_diffs``' d2) rounded by its bit
    rule, the self pairs zeroed."""
    s16 = np.asarray(jax_src_limbs(jnp.asarray(src), G)).astype(ml_dtypes.bfloat16).astype(np.float32)
    tj, sj = jnp.asarray(tgt), jnp.asarray(src)
    dx, dy, dz = (sj[None, :, c] - tj[:, None, c] for c in range(3))
    d2 = dx * dx + (dy * dy + (dz * dz + EPS2))
    w = np.asarray(_round_to_bf16_f32(jax.lax.rsqrt(d2 * (d2 * d2))))
    rows = np.arange(tgt.shape[0])[:, None]
    cols = np.arange(src.shape[0])[None, :]
    w = np.where((cols - rows == off) & (rows >= lo) & (rows < hi), np.float32(0), w)
    return _epilogue_np(_mxu_f32_dot(w, s16), tgt)


@pytest.mark.parametrize("case", ["self", "disjoint", "offset", "restricted"])
def test_twin_matches_mxu_emulation(rng, case):
    """The twin's rounding is the MXU's: within the emulation's own f32
    summation of it (1e-5 of scale), in the diagonal forms.  With a
    restricted range the rows outside it keep their softening-floor self
    weight, whose ~1e3 terms the emulation's f32 sums carry at their ulp
    (1.3e-5 of scale here): those rows are held to JAX by
    ``test_twin_matches_jax_traced_diagonal``, the masked rows here."""
    pm = galaxy_like(rng, 256)
    tgt, src, diag = {
        "self": (pm, pm, (0, 0, NO_DIAG)),
        "disjoint": (pm[:128], pm[128:], (NO_DIAG, 0, NO_DIAG)),
        "offset": (pm[64:192], pm, (64, 0, 128)),
        "restricted": (pm[64:192], pm, (64, 16, 112)),
    }[case]
    got = cf.force_fast(t(tgt), t(src), G, EPS2, diag).numpy()[:, :3]
    want = mxu_emulation(tgt, src, *diag)
    rows = np.arange(tgt.shape[0])
    masked = (rows >= diag[1]) & (rows < diag[2]) if case == "restricted" else rows >= 0
    assert np.abs(got - want)[masked].max() / np.abs(want).max() < 1e-5


# ----------------------------------------------- mask and gm-limb regressions
def test_self_mask_required_under_f32_accumulation():
    """``tests/test_sym.py:149-172`` with the port's operands: without the
    mask the 1e7 body's self weight (eps2^-3/2 times its gm) fills its
    row's f32 sums (the twin rounds them once, the MXU emulation at every
    add) and its acceleration is lost; with it, bf16 noise."""
    rng = np.random.default_rng(0)
    pm = galaxy_like(rng, 256)
    pm[0, :3] = [0.5, -0.3, 0.2]
    oracle = oracle_f64(pm, pm)
    central = lambda a: np.abs(a[0, :3] - oracle[0]).max() / np.abs(oracle[0]).max()  # noqa: E731
    unmasked = cf.force_fast(t(pm), t(pm), G, EPS2, (NO_DIAG, 0, NO_DIAG)).numpy()
    masked = cf.force_fast(t(pm), t(pm), G, EPS2).numpy()
    assert central(unmasked) > 0.5
    assert central(masked) < 6e-3
    assert central(mxu_emulation(pm, pm, NO_DIAG, 0, NO_DIAG)) > 0.5
    assert central(mxu_emulation(pm, pm, 0, 0, NO_DIAG)) < 6e-3


def test_near_coincident_pair_keeps_gm_limbs():
    """``tests/test_pallas.py:86-118``: a pair closer than the softening
    length cancels ``w*(gm*x) - x*(w*gm)`` at w ~ eps2^-3/2; with every
    column, gm's too, limb-split in bf16 the twin stays at bf16 noise.
    With one raw gm column rounded to bf16 it would not."""
    rng = np.random.default_rng(3)
    n = 64
    pm = np.concatenate([rng.normal(scale=2.0, size=(n, 3)), rng.uniform(1, 50, (n, 1))], axis=1).astype(np.float32)
    pm[1, :3] = pm[0, :3] + 1e-4
    oracle = oracle_f64(pm, pm)
    got = cf.force_fast(t(pm), t(pm), G, EPS2).numpy()
    assert rel(got[:, :3], oracle) < 6e-3
    # the gm-column bug, rebuilt: gm's h limb carries all of gm
    lb = cf.limbs_bf16(t(pm), G).double().numpy()
    raw_gm = lb.copy()
    raw_gm[:, 9] = (G * pm[:, 3]).astype(ml_dtypes.bfloat16).astype(np.float64)
    raw_gm[:, 10:12] = 0.0
    d = pm[None, :, :3].astype(np.float32) - pm[:, None, :3].astype(np.float32)
    d2 = (d * d).sum(-1) + np.float32(EPS2)
    w = cf.round_to_bf16(t((d2.astype(np.float64) ** -1.5).astype(np.float32))).double().numpy()
    np.fill_diagonal(w, 0.0)
    bad = _epilogue_np((w @ raw_gm).astype(np.float32), pm)
    assert rel(bad, oracle) > 6e-3


# ---------------------------------------------------------- fused fast step
def state(rng, n, n_real):
    pm = galaxy_like(rng, n, heavy=False, n_real=n_real)
    pm[n_real:, :3] = 0.0
    vel = np.concatenate([rng.normal(size=(n, 3)) * 0.1, np.zeros((n, 1))], axis=1).astype(np.float32)
    aold = np.concatenate([1e-3 * rng.normal(size=(n, 3)), np.zeros((n, 1))], axis=1).astype(np.float32)
    vel[n_real:] = 0.0
    aold[n_real:] = 0.0
    return pm, vel, aold


def assert_step_close(got, want, a_scale, dt):
    (p, v, a), (p0, v0, a0) = got, want
    assert rel(a, a0) < 5e-3
    np.testing.assert_allclose(p, p0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v0, rtol=0, atol=5e-3 * a_scale * dt + 1e-6)


@pytest.mark.parametrize("n,n_real,bt,bs", [(512, 512, 128, 256), (256, 200, 128, 128), (384, 300, 128, 128)])
def test_fused_twin_matches_jax_fused_fast(rng, n, n_real, bt, bs):
    """``tests/test_pallas.py:175-195``: the fused fast twin against
    ``fused_step_pallas(mode="fast")``; padded rows frozen, zero accel."""
    pm, vel, aold = state(rng, n, n_real)
    got = [x.numpy() for x in cf.fused_step_fast(t(pm), t(vel), t(aold), DT, G, eps2=EPS2, n_real=n_real)]
    want = [np.asarray(x) for x in fused_step_pallas(
        jnp.asarray(pm), jnp.asarray(vel), jnp.asarray(aold), DT, G, eps2=EPS2, n_real=n_real,
        block_target=bt, block_source=bs, mode="fast", interpret=True)]
    assert_step_close(got, want, np.abs(want[2]).max(), DT)
    np.testing.assert_array_equal(got[0][n_real:], pm[n_real:])
    np.testing.assert_array_equal(got[1][n_real:], vel[n_real:])
    np.testing.assert_array_equal(got[2][n_real:], 0.0)
    np.testing.assert_array_equal(got[0][:, 3], pm[:, 3])


@pytest.mark.parametrize("n_real", [256, 250])
def test_fused_twin_is_force_fast_then_verlet(rng, n_real):
    """Bit for bit, as the kernel on the card equals ``force_fast`` and the
    torch Verlet."""
    pm, vel, aold = (t(x) for x in state(rng, 256, n_real))
    got = cf.fused_step_fast(pm, vel, aold, DT, G, eps2=EPS2, n_real=n_real)
    want = apply_integrator("verlet", pm, vel, aold, cf.force_fast(pm, pm, G, EPS2), DT,
                            valid_mask(256, n_real, "cpu"))
    for x, w in zip(got, want):
        assert torch.equal(x, w)


def test_fast_wrappers_check_input(rng):
    pm, vel, aold = (t(x) for x in state(rng, 256, 256))
    with pytest.raises(ValueError, match="eps2"):
        cf.force_fast(pm, pm, G, 0.0)
    with pytest.raises(ValueError, match="eps2"):
        cf.fused_step_fast(pm, vel, aold, DT, G, eps2=-1e-4, n_real=256)
    with pytest.raises(ValueError, match="int32"):
        cf.force_fast(pm, pm, G, EPS2, (1 << 31, 0, NO_DIAG))
    with pytest.raises(ValueError, match="one shape"):
        cf.fused_step_fast(pm, vel, aold[:128].clone(), DT, G, eps2=EPS2, n_real=256)
    with pytest.raises(RuntimeError, match="never take such tensors"):
        cf.force_fast(pm.clone().requires_grad_(), pm, G, EPS2)
    with pytest.raises(TypeError, match="float32"):
        cf.force_fast(pm.double(), pm.double(), G, EPS2)


# ------------------------------------------------------ entry points
def torch_steps(cfg, pm, vel, n_real, k):
    n = pm.shape[0]
    step = make_step_fn(cfg, n, n_real, "cpu")
    s = SimState(t(pm.copy()), t(vel.copy()), torch.zeros((n, 4)), 0)
    for _ in range(k):
        s = step(s, DT, G)
    return [x.numpy() for x in (s.pos_mass, s.vel, s.accel)]


def jax_steps(cfg, pm, vel, n_real, k):
    n = pm.shape[0]
    step = jax_make_step_fn(cfg, n, n_real, platform="cpu")
    s = JaxState(jnp.asarray(pm), jnp.asarray(vel), jnp.zeros((n, 4), jnp.float32), jnp.int32(0))
    for _ in range(k):
        s = step(s, DT, G)
    return [np.asarray(x) for x in (s.pos_mass, s.vel, s.accel)]


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("n,n_real", [(256, 256), (384, 300)])
def test_fast_step_matches_jax(rng, fuse, n, n_real):
    """Three steps of ``make_step_fn(force_mode="fast")`` against the JAX
    package's (backend "pallas", interpret mode), both values of
    ``fuse_integrate``; padded rows frozen."""
    pm, vel, _ = state(rng, n, n_real)
    kw = {"force_mode": "fast", "fuse_integrate": fuse, "block_target": 128, "block_source": 128}
    got = torch_steps(SimConfig(**kw), pm, vel, n_real, 3)
    want = jax_steps(JaxConfig(backend="pallas", **kw), pm, vel, n_real, 3)
    assert_step_close(got, want, np.abs(want[2]).max(), DT)
    if n_real < n:
        np.testing.assert_array_equal(got[0][n_real:], pm[n_real:])
        assert not got[2][n_real:].any()


def test_fused_and_unfused_fast_steps_agree(rng):
    """Without a gradient, either value of ``fuse_integrate`` runs
    ``fused_step_fast``; on the CPU its twin is ``force_fast`` followed by
    the torch Verlet, spelled out here, bit for bit."""
    pm, vel, _ = state(rng, 256, 240)
    p, v, a = t(pm.copy()), t(vel.copy()), torch.zeros((256, 4))
    for _ in range(2):
        p, v, a = apply_integrator("verlet", p, v, a, cf.force_fast(p, p, G, EPS2), DT, valid_mask(256, 240, "cpu"))
    for fuse in (True, False):
        got = torch_steps(SimConfig(force_mode="fast", fuse_integrate=fuse), pm, vel, 240, 2)
        for x, w in zip(got, (p, v, a)):
            np.testing.assert_array_equal(x, w.numpy())


@pytest.mark.parametrize("fuse", [False, True])
def test_fast_simulation_matches_jax(fuse):
    """``Simulation`` (padded to 768 rows) against the JAX package's
    (interpret mode), three steps of plummer n = 600; no kernel launches
    on the CPU."""
    reset_launch_counts()
    cfg = {"force_mode": "fast", "fuse_integrate": fuse}
    ts = Simulation.from_preset("plummer", SimConfig(**cfg), n=600, device="cpu")
    js = JaxSimulation.from_preset("plummer", JaxConfig(backend="pallas", **cfg), n=600, platform="cpu")
    ts.run(3, chunk=3)
    js.run(3, chunk=3)
    assert ts.n_pad == 768 and ts.step_count == js.step_count == 3
    (p, v, a), (p0, v0, a0) = ts.arrays(), js.arrays()
    assert_step_close((p, v, a), (p0, v0, a0), np.abs(a0).max(), ts.dt)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def _fast_grads(step_of, pm, vel, n_real, steps=2):
    """``tests/test_sym.py:490-527``'s loss: gradients by pos_mass, vel, dt
    and G of ``sum |x|^2 + sum |v|^2`` after ``steps`` steps."""
    n = pm.shape[0]
    step = step_of(n, n_real)
    args = [t(pm.copy()).requires_grad_(), t(vel.copy()).requires_grad_(),
            torch.tensor(DT, requires_grad=True), torch.tensor(G, requires_grad=True)]
    s = SimState(args[0], args[1], torch.zeros((n, 4)), 0)
    for _ in range(steps):
        s = step(s, args[2], args[3])
    loss = torch.sum(s.pos_mass[:, :3] ** 2) + torch.sum(s.vel[:, :3] ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, args)]


@pytest.mark.parametrize("n_real", [256, 250])
def test_fast_rollout_grad_matches_jax_grad(rng, n_real):
    n = 256
    pm, vel, _ = state(rng, n, n_real)
    pm[0, 3] = 1e5  # a heavy body, as tests/test_torch_grad.py stresses the mask
    got = _fast_grads(lambda n_, r: make_step_fn(SimConfig(force_mode="fast", block_target=128), n_, r, "cpu"),
                      pm, vel, n_real)
    step = jax_make_step_fn(JaxConfig(backend="pallas", force_mode="fast", block_target=128), n, n_real,
                            platform="cpu")

    def loss(pos_mass, vel_, dt, G_):
        s = JaxState(pos_mass, vel_, jnp.zeros((n, 4), jnp.float32), jnp.int32(0))
        for _ in range(2):
            s = step(s, dt, G_)
        return jnp.sum(s.pos_mass[:, :3] ** 2) + jnp.sum(s.vel[:, :3] ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(jnp.asarray(pm), jnp.asarray(vel), jnp.float32(DT),
                                                         jnp.float32(G))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        assert np.abs(g - w).max() / (np.abs(w).max() + 1e-30) < 2e-3


@pytest.mark.parametrize("what", ["v0", "dt", "G", "pos_mass"])
def test_fused_fast_step_refuses_gradients(rng, what):
    pm, vel, _ = state(rng, 256, 256)
    step = make_step_fn(SimConfig(force_mode="fast", fuse_integrate=True), 256, 256, "cpu")
    p, v = t(pm), t(vel)
    dt, g = torch.tensor(DT), torch.tensor(G)
    {"v0": v, "dt": dt, "G": g, "pos_mass": p}[what].requires_grad_()
    with pytest.raises(RuntimeError, match="fuse_integrate=True.*no gradient"):
        step(SimState(p, v, torch.zeros_like(p), 0), dt, g)
    assert step(SimState(p.detach(), v.detach(), torch.zeros_like(p), 0), DT, G).step == 1


def test_cli_run_fast_both_routes(capsys, tmp_path):
    """``cli run --force-mode fast --device cpu``; then ``fuse_integrate=True``
    from a checkpoint's saved config (the CLI keeps it on resume), which
    must take the fused route: the same state as ``Simulation`` with that
    config.  No kernel launches on the CPU."""
    reset_launch_counts()
    assert cli.main(["run", "--device", "cpu", "--preset", "uniform-sphere", "--n", "300", "--steps", "4",
                     "--log-every", "2", "--diagnostics", "--force-mode", "fast",
                     "--outdir", str(tmp_path / "a")]) == 0
    out = capsys.readouterr().out
    assert sum(line.startswith("step=") for line in out.splitlines()) == 2 and "E=" in out
    sim = Simulation.from_preset("uniform-sphere", SimConfig(force_mode="fast", fuse_integrate=True), n=300,
                                 device="cpu")
    sim.save(str(tmp_path / "start.npz"))
    assert cli.main(["run", "--device", "cpu", "--checkpoint", str(tmp_path / "start.npz"), "--steps", "3",
                     "--log-every", "3", "--outdir", str(tmp_path / "b")]) == 0
    resumed = Simulation.load(str(tmp_path / "b" / "final.npz"), device="cpu")
    assert resumed.config.fuse_integrate and resumed.config.force_mode == "fast"
    sim.run(3, chunk=3)
    for x, w in zip(resumed.arrays(), sim.arrays()):
        np.testing.assert_array_equal(x, w)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
