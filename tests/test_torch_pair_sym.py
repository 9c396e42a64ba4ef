"""The Newton-3 pair force between two disjoint sets (``pair_sym``'s plain
twin, what the wrapper runs on CPU tensors) and the macro-tiled sym
schedule that runs it above ``MACRO_MIN_N`` bodies, against the JAX
package on the CPU: the twin against ``accel_pair_sym_pallas`` in interpret
mode and an f64 numpy sum, its momentum balance, ``accel_sym_macro`` and
``make_step_fn`` with the thresholds patched against the JAX package's
``make_sym_accel_fn`` and ``make_step_fn`` under the same patches (as
``tests/test_sym.py::test_sym_huge_n_macro_tiles`` patches them), the
chunk counts at the real thresholds, the dispatch, rollout gradients
against ``jax.grad`` through the JAX macro route, ``Simulation`` and the
CLI, and the wrapper's refusals.

Bounds are the JAX package's sym bounds (``tests/test_sym.py:56, 354``):
max-abs/scale < 2e-5 (both sides f32, sums in other orders; the JAX pair
kernel's interpret mode reconstructs its bf16 limbs to f32 exactly);
gradients max-abs/scale < 1e-5 (``tests/test_torch_sym_unfused.py``).
Inputs are made with numpy from a seed."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.step as jstep  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.ops.pallas_force import accel_pair_sym_pallas  # noqa: E402
from nbody3d_tpu.state import SimState as JaxState  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops import step as tstep  # noqa: E402
from nbody3d_tpu_torch.ops.launch import KERNELS, launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-3


def bodies(rng, n, n_real=None, heavy=None):
    """A cloud of n bodies (masses 10-50), rows from ``n_real`` on padded
    with mass 0, and a 1e7 body at row ``heavy``."""
    pm = np.concatenate([rng.normal(scale=2.0, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1)
    if heavy is not None:
        pm[heavy, 3] = 1e7
    if n_real is not None:
        pm[n_real:, 3] = 0.0
    return pm.astype(np.float32)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def pair_f64(tgt, src, g):
    """Both sides' accelerations by an f64 numpy sum over the pairs
    (``tgt = src`` gives every row's acceleration: the self pair adds 0)."""
    t, s = tgt.astype(np.float64), src.astype(np.float64)
    d = s[None, :, :3] - t[:, None, :3]  # (Nt, Ns, 3): x_j - x_i
    inv3 = (np.sum(d * d, axis=-1) + EPS2) ** -1.5
    acc_t = np.einsum("ij,ijc->ic", g * s[None, :, 3] * inv3, d)
    acc_s = -np.einsum("ij,ijc->jc", g * t[:, None, 3] * inv3, d)
    pad = np.zeros((1, 1))
    return np.concatenate([acc_t, np.broadcast_to(pad, (len(t), 1))], 1), \
        np.concatenate([acc_s, np.broadcast_to(pad, (len(s), 1))], 1)


# (Nt, Ns, tile, heavy side): Nt != Ns, one and several tiles a side.
PAIR_CASES = [(256, 192, 64, "tgt"), (192, 320, 64, "src"), (384, 256, 128, "tgt"), (128, 512, 128, "src")]


def pair_inputs(rng, nt, ns, heavy):
    tgt = bodies(rng, nt, n_real=nt - 40, heavy=5 if heavy == "tgt" else None)
    src = bodies(rng, ns, n_real=ns - 24, heavy=7 if heavy == "src" else None)
    src[:, :3] += 0.5  # disjoint sets: no coincident bodies
    return tgt, src


# ------------------------------------------------------------- (a) twin
@pytest.mark.parametrize("nt,ns,b,heavy", PAIR_CASES)
def test_pair_sym_twin_matches_jax_pair_kernel(rng, nt, ns, b, heavy):
    """Both outputs against ``accel_pair_sym_pallas`` (interpret mode) and
    an f64 direct sum, G = 3.7, padded rows (mass 0) included: < 2e-5 of
    scale; w lanes 0."""
    g = 3.7
    tgt, src = pair_inputs(rng, nt, ns, heavy)
    got_t, got_s = (x.numpy() for x in cf.accel_pair_sym(torch.from_numpy(tgt), torch.from_numpy(src), g,
                                                         eps2=EPS2, b=b))
    want_t, want_s = (np.asarray(x) for x in accel_pair_sym_pallas(jnp.asarray(tgt), jnp.asarray(src), g,
                                                                   eps2=EPS2, block=b, interpret=True))
    f64_t, f64_s = pair_f64(tgt, src, g)
    assert got_t.shape == (nt, 4) and got_s.shape == (ns, 4)
    assert not got_t[:, 3].any() and not got_s[:, 3].any()
    for got, want, f64 in ((got_t, want_t, f64_t), (got_s, want_s, f64_s)):
        assert rel(got, want) < 2e-5
        assert rel(got, f64) < 2e-5


@pytest.mark.parametrize("nt,ns,b,heavy", PAIR_CASES[:2])
def test_pair_sym_newton3_momentum(rng, nt, ns, b, heavy):
    """Σ m a over both sets vanishes: each pair's weight is applied in both
    directions, so the sum is f32 rounding of the rows, < 1e-6 of Σ m |a|."""
    tgt, src = pair_inputs(rng, nt, ns, heavy)
    acc_t, acc_s = cf.accel_pair_sym(torch.from_numpy(tgt), torch.from_numpy(src), G, eps2=EPS2, b=b)
    m_t, m_s = torch.from_numpy(tgt[:, 3:4]).double(), torch.from_numpy(src[:, 3:4]).double()
    p = (m_t * acc_t.double()).sum(0) + (m_s * acc_s.double()).sum(0)
    scale = float((m_t * acc_t.double().norm(dim=1, keepdim=True)).sum()
                  + (m_s * acc_s.double().norm(dim=1, keepdim=True)).sum())
    assert float(p.abs().max()) < 1e-6 * scale


# ---------------------------------------------------------- (f) refusals
def test_pair_sym_refuses_bad_input(rng):
    tgt, src = (torch.from_numpy(x) for x in pair_inputs(rng, 256, 192, "tgt"))
    with pytest.raises(ValueError, match="tile"):
        cf.accel_pair_sym(tgt, src, G, eps2=EPS2, b=128)  # 192 rows are not tiles of 128
    with pytest.raises(ValueError, match="tile"):
        cf.accel_pair_sym(tgt[:200], src, G, eps2=EPS2, b=64)
    for eps2 in (0.0, -1e-4):
        with pytest.raises(ValueError, match="eps2"):
            cf.accel_pair_sym(tgt, src, G, eps2=eps2, b=64)
    with pytest.raises(ValueError, match="tensors on"):
        cf.accel_pair_sym(tgt, src.to("meta"), G, eps2=EPS2, b=64)
    with pytest.raises(ValueError, match="chunks"):
        cf.accel_sym_macro(tgt, G, eps2=EPS2, b=64, m_chunks=3)


# -------------------------------------------------------- (c) composition
@pytest.fixture
def small_macro(monkeypatch):
    """Both packages' thresholds patched as tests/test_sym.py:347-348 does:
    macro above 256 bodies, chunks of at most 128."""
    for mod in (jstep, tstep):
        monkeypatch.setattr(mod, "MACRO_MIN_N", 256)
        monkeypatch.setattr(mod, "SYM_MAX_N", 128)


@pytest.mark.parametrize("n,n_real,m_chunks", [(512, 512, 4), (512, 500, 2), (384, 384, 3)])
def test_accel_sym_macro_matches_direct_and_jax(rng, small_macro, n, n_real, m_chunks):
    """``accel_sym_macro`` against the port's direct ``accel_sym`` at any
    chunk count, and (at the chunk count of the patched thresholds, 4 for
    512 bodies and 3 for 384) the port's ``make_sym_accel_fn`` against the
    JAX package's, interpret mode, and an f64 sum: < 2e-5 of scale, padded
    rows included."""
    pm = bodies(rng, n, n_real=n_real, heavy=3)
    x = torch.from_numpy(pm)
    got = cf.accel_sym_macro(x, G, eps2=EPS2, b=64, m_chunks=m_chunks).numpy()
    direct = cf.accel_sym(x, G, eps2=EPS2, b=64).numpy()
    assert got.shape == (n, 4) and not got[:, 3].any()
    assert rel(got, direct) < 2e-5
    cfg = dict(force_mode="sym", block_target=64)
    ours = tstep.make_sym_accel_fn(SimConfig(**cfg), n)(x, G).numpy()
    theirs = np.asarray(jstep.make_sym_accel_fn(JaxConfig(backend="pallas", **cfg), n, True)(jnp.asarray(pm), G))
    assert tstep.macro_chunks(n) == n // 128
    assert rel(ours, theirs) < 2e-5
    assert rel(ours, pair_f64(pm, pm, G)[0]) < 2e-5  # the self pair adds 0


def _jax_chunks(n: int, monkeypatch) -> tuple[int, int, int]:
    """``(sym calls, pair calls, chunk rows)`` of the JAX package's macro
    schedule for ``n`` bodies, read by tracing it with its kernels
    replaced by recorders (nothing runs)."""
    calls = {"sym": [], "pair": []}

    def sym(c, G, **kw):
        calls["sym"].append(c.shape[0])
        return jnp.zeros_like(c)

    def pair(a, c, G, **kw):
        calls["pair"].append(a.shape[0])
        return jnp.zeros_like(a), jnp.zeros_like(c)

    monkeypatch.setattr(jstep, "accel_sym_pallas", sym)
    monkeypatch.setattr(jstep, "accel_pair_sym_pallas", pair)
    fn = jstep.make_sym_accel_fn(JaxConfig(backend="pallas", force_mode="sym"), n, True)
    jax.eval_shape(fn, jax.ShapeDtypeStruct((n, 4), jnp.float32), 1.0)
    return len(calls["sym"]), len(calls["pair"]), calls["sym"][0]


def _port_chunks(n: int, monkeypatch) -> tuple[int, int, int]:
    """The same for the port, on a meta tensor with its kernels replaced."""
    calls = {"sym": [], "pair": []}

    def sym(c, G, **kw):
        calls["sym"].append(c.shape[0])
        return torch.zeros_like(c)

    def pair(a, c, G, **kw):
        calls["pair"].append(a.shape[0])
        return torch.zeros_like(a), torch.zeros_like(c)

    monkeypatch.setattr(cf, "accel_sym", sym)
    monkeypatch.setattr(cf, "accel_pair_sym", pair)
    out = tstep.make_sym_accel_fn(SimConfig(force_mode="sym"), n)(torch.empty((n, 4), device="meta"), 1.0)
    assert out.shape == (n, 4)
    return len(calls["sym"]), len(calls["pair"]), calls["sym"][0]


# Above the real MACRO_MIN_N = 786,432, multiples of the port's 256-row
# granule; 1,573,120 (ceil gives 3, which does not divide: 4) and 3,145,984
# (5, 6 and 7 do not divide: 8) take the loop.
@pytest.mark.parametrize("n", [786_688, 788_480, 1_048_576, 1_573_120, 2_097_152, 2_359_296, 3_145_984])
def test_macro_chunk_counts_match_jax(n, monkeypatch):
    m = tstep.macro_chunks(n)
    want = _jax_chunks(n, monkeypatch)
    assert want == (m, m * (m - 1) // 2, n // m)
    assert _port_chunks(n, monkeypatch) == want


def _jax_state(pm, vel):
    n = pm.shape[0]
    return JaxState(jnp.asarray(pm), jnp.asarray(vel), jnp.zeros((n, 4), jnp.float32), jnp.int32(0))


@pytest.mark.parametrize("integrator", ["verlet", "yoshida4"])
def test_macro_step_matches_jax(rng, small_macro, monkeypatch, integrator):
    """One ``make_step_fn`` step above the patched threshold (512 bodies
    with a 1e7 body as in tests/test_sym.py's macro test, 4 chunks of 128,
    tile 64, 500 real) against the JAX package's step under the same
    patches (interpret mode): accel < 2e-5 of scale, p within 1e-6 and v
    within that accel bound carried through the kicks (5 dt: yoshida4's
    kick coefficients sum to 4.4 in absolute value); and against the port's
    step below the threshold (the fused route)."""
    n, n_real = 512, 500
    pm = bodies(rng, n, n_real=n_real, heavy=0)
    vel = (rng.normal(size=(n, 4)) * 0.1).astype(np.float32)
    vel[:, 3] = 0.0
    vel[n_real:] = 0.0
    cfg = dict(force_mode="sym", integrator=integrator, block_target=64)
    st = SimState(torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((n, 4)), 0)
    got = tstep.make_step_fn(SimConfig(**cfg), n, n_real, "cpu")(st, DT, G)
    want = jstep.make_step_fn(JaxConfig(backend="pallas", **cfg), n, n_real, platform="cpu")(
        _jax_state(pm, vel), jnp.float32(DT), G)
    a0 = np.asarray(want.accel)
    assert rel(got.accel.numpy(), a0) < 2e-5
    assert np.abs(got.pos_mass.numpy() - np.asarray(want.pos_mass)).max() <= 1e-6
    assert np.abs(got.vel.numpy() - np.asarray(want.vel)).max() <= 2e-5 * np.abs(a0).max() * 5 * DT
    monkeypatch.setattr(tstep, "MACRO_MIN_N", 1 << 30)
    st = SimState(torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((n, 4)), 0)
    below = tstep.make_step_fn(SimConfig(**cfg), n, n_real, "cpu")(st, DT, G)
    assert rel(got.accel.numpy(), below.accel.numpy()) < 2e-5


# ------------------------------------------------------------ (d) dispatch
@pytest.mark.parametrize("threshold,fused", [(256, False), (512, True)])
def test_macro_dispatch_skips_the_fused_step(rng, small_macro, monkeypatch, threshold, fused):
    """Verlet with ``fuse_epilogue=True`` at 512 bodies: above the patched
    threshold the step runs the macro force (6 pair calls for 4 chunks)
    and not the fused step; at ``n_pad <= MACRO_MIN_N`` the fused step."""
    monkeypatch.setattr(tstep, "MACRO_MIN_N", threshold)
    seen = {"fused": 0, "pair": 0}
    fused_step, pair = tstep.sym_step_, cf.accel_pair_sym

    def count_fused(*a, **kw):
        seen["fused"] += 1
        return fused_step(*a, **kw)

    def count_pair(*a, **kw):
        seen["pair"] += 1
        return pair(*a, **kw)

    monkeypatch.setattr(tstep, "sym_step_", count_fused)
    monkeypatch.setattr(cf, "accel_pair_sym", count_pair)
    n = 512
    cfg = SimConfig(force_mode="sym", block_target=64, fuse_epilogue=True)
    st = SimState(torch.from_numpy(bodies(rng, n)), torch.zeros((n, 4)), torch.zeros((n, 4)), 0)
    out = tstep.make_step_fn(cfg, n, n, "cpu")(st, DT, G)
    assert bool(torch.isfinite(out.pos_mass).all())
    assert seen == ({"fused": 1, "pair": 0} if fused else {"fused": 0, "pair": 6})


# ------------------------------------------------------------ (e) gradients
def test_macro_rollout_grad_matches_jax_grad(rng, small_macro):
    """Two steps of the macro route (512 bodies, 500 real, 4 chunks, tile
    128): gradients of ``sum |x|^2 + sum |v|^2`` by pos_mass, v0, dt and G
    against ``jax.grad`` through the JAX package's macro route (interpret
    mode, its ``make_diff_accel`` with the Newton-3 VJP): max-abs/scale <
    1e-5."""
    n, n_real = 512, 500
    pm = bodies(rng, n, n_real=n_real)
    vel = (rng.normal(size=(n, 4)) * 0.1).astype(np.float32)
    vel[:, 3] = 0.0
    vel[n_real:] = 0.0
    cfg = dict(force_mode="sym", block_target=128)
    step = tstep.make_step_fn(SimConfig(**cfg), n, n_real, "cpu")
    args = [torch.from_numpy(pm.copy()).requires_grad_(), torch.from_numpy(vel.copy()).requires_grad_(),
            torch.tensor(DT, requires_grad=True), torch.tensor(G, requires_grad=True)]
    s = SimState(args[0], args[1], torch.zeros((n, 4)), 0)
    for _ in range(2):
        s = step(s, args[2], args[3])
    loss = torch.sum(s.pos_mass[:, :3] ** 2) + torch.sum(s.vel[:, :3] ** 2)
    got = [g.numpy() for g in torch.autograd.grad(loss, args)]
    jax_step = jstep.make_step_fn(JaxConfig(backend="pallas", **cfg), n, n_real, platform="cpu")

    def jloss(pos_mass, vel_, dt, G_):
        s = JaxState(pos_mass, vel_, jnp.zeros((n, 4), jnp.float32), jnp.int32(0))
        for _ in range(2):
            s = jax_step(s, dt, G_)
        return jnp.sum(s.pos_mass[:, :3] ** 2) + jnp.sum(s.vel[:, :3] ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(jnp.asarray(pm), jnp.asarray(vel), jnp.float32(DT),
                                                          jnp.float32(G))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        assert np.abs(g - w).max() / (np.abs(w).max() + 1e-30) < 1e-5


# ------------------------------------------------ Simulation and the CLI
def test_macro_simulation_matches_jax(monkeypatch):
    """``Simulation`` runs the macro route with no change of its own:
    plummer n = 600 (the port pads to 768 rows: 3 chunks of 256; the JAX
    package to 2,048: 8 chunks) with both thresholds patched to 256, three
    steps against the JAX package's ``Simulation``: p within 1e-6, v within
    1e-6 of max(1, its scale), accel < 5e-5 of scale
    (``tests/test_torch_sym_unfused.py``'s bounds)."""
    for mod in (jstep, tstep):
        monkeypatch.setattr(mod, "MACRO_MIN_N", 256)
        monkeypatch.setattr(mod, "SYM_MAX_N", 256)
    pairs = {"n": 0}
    pair = cf.accel_pair_sym

    def count_pair(*a, **kw):
        pairs["n"] += 1
        return pair(*a, **kw)

    monkeypatch.setattr(cf, "accel_pair_sym", count_pair)
    cfg = {"force_mode": "sym", "block_target": 256}
    ts = Simulation.from_preset("plummer", SimConfig(**cfg), n=600, device="cpu")
    js = JaxSimulation.from_preset("plummer", JaxConfig(backend="pallas", **cfg), n=600, platform="cpu")
    ts.run(3, chunk=3)
    js.run(3, chunk=3)
    assert ts.n_pad == 768 and ts.step_count == js.step_count == 3 and pairs["n"] == 3 * 3
    (p, v, a), (p0, v0, a0) = ts.arrays(), js.arrays()
    np.testing.assert_allclose(p, p0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v0, rtol=0, atol=1e-6 * max(1.0, np.abs(v0).max()))
    assert rel(a, a0) < 5e-5


@pytest.mark.parametrize("cmd", ["run", "bench"])
def test_macro_cli(capsys, tmp_path, monkeypatch, cmd):
    """``cli run`` and ``cli bench`` with ``--force-mode sym`` take the
    macro route above the patched threshold (300 bodies pad to 512: two
    chunks of 256, one pair call a step) and launch no kernel on the CPU."""
    monkeypatch.setattr(tstep, "MACRO_MIN_N", 256)
    monkeypatch.setattr(tstep, "SYM_MAX_N", 256)
    pairs = {"n": 0}
    pair = cf.accel_pair_sym

    def count_pair(*a, **kw):
        pairs["n"] += 1
        return pair(*a, **kw)

    monkeypatch.setattr(cf, "accel_pair_sym", count_pair)
    reset_launch_counts()
    common = ["--device", "cpu", "--preset", "uniform-sphere", "--n", "300", "--force-mode", "sym"]
    if cmd == "run":
        argv = ["run", *common, "--steps", "4", "--log-every", "2", "--diagnostics", "--outdir", str(tmp_path)]
    else:
        argv = ["bench", *common, "--steps", "4", "--chunk", "2", "--warmup-steps", "2"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert pairs["n"] == (4 if cmd == "run" else 6)
    assert ("E=" in out) if cmd == "run" else ('"n_pad": 512' in out)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
