"""The fused exact step: the port's ``fused_step_exact`` twin (what the
wrapper runs on CPU tensors) against the JAX package's
``fused_step_pallas(mode="exact")`` in interpret mode, and the route
through ``make_step_fn`` and ``Simulation`` against the unfused exact step
and the JAX package's fused engine.  Exact and fast Verlet steps that need
no gradient run the fused kernel whatever ``fuse_integrate`` says; a step
that needs one runs the force wrapper under ``make_diff_accel`` and the
torch Verlet (``fuse_integrate=True`` refuses it).

Bounds are the JAX package's own (``tests/test_pallas.py:176-250``,
``tests/test_step.py:49-61``): positions rtol 1e-6 / atol 1e-6 (1e-7
where padded), velocities rtol 1e-5 / atol 1e-6, accelerations rtol 1e-5
/ atol 1e-7; padded rows frozen with zero acceleration; ``dt = 0`` leaves
positions and velocities as they were.  Both sides are f32 with different
summation orders.  The twin is ``force_exact``'s followed by the torch
Verlet, bit for bit, as the kernel is on the card."""

import collections

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu.ops.pallas_force import fused_step_pallas  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops import step as tstep  # noqa: E402
from nbody3d_tpu_torch.ops.integrate import apply_integrator, valid_mask  # noqa: E402
from nbody3d_tpu_torch.ops.launch import KERNELS, launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.ops.step import make_step_fn  # noqa: E402
from nbody3d_tpu_torch.state import SimState  # noqa: E402

G, EPS2, DT = 1e-4, 1e-4, 1e-3


def random_state(rng, n, n_real=None):
    """``tests/test_pallas.py``'s bodies (uniform in a cube, masses 1-10,
    small velocities, a lagged acceleration); padded rows are zero."""
    n_real = n if n_real is None else n_real
    pm = np.zeros((n, 4), np.float32)
    vel = np.zeros((n, 4), np.float32)
    aold = np.zeros((n, 4), np.float32)
    pm[:n_real, :3] = rng.uniform(-5, 5, (n_real, 3))
    pm[:n_real, 3] = rng.uniform(1, 10, n_real)
    vel[:n_real, :3] = 0.1 * rng.standard_normal((n_real, 3))
    aold[:n_real, :3] = 1e-3 * rng.standard_normal((n_real, 3))
    return pm, vel, aold


def jax_fused(pm, vel, aold, dt, n_real, bt=128, bs=128):
    out = fused_step_pallas(jnp.asarray(pm), jnp.asarray(vel), jnp.asarray(aold), dt, G, eps2=EPS2,
                            n_real=n_real, block_target=bt, block_source=bs, mode="exact", interpret=True)
    return [np.asarray(x) for x in out]


def port_fused(pm, vel, aold, dt, n_real):
    out = cf.fused_step_exact(*(torch.from_numpy(x.copy()) for x in (pm, vel, aold)), dt, G,
                              eps2=EPS2, n_real=n_real)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("n,n_real,bt,bs", [(512, 512, 128, 256), (256, 200, 128, 128), (384, 300, 128, 128)])
def test_fused_step_matches_jax_fused_step(rng, n, n_real, bt, bs):
    pm, vel, aold = random_state(rng, n, n_real)
    p, v, a = port_fused(pm, vel, aold, DT, n_real)
    p0, v0, a0 = jax_fused(pm, vel, aold, DT, n_real, bt, bs)
    np.testing.assert_allclose(p, p0, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v, v0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a, a0, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(p[n_real:], pm[n_real:])
    np.testing.assert_array_equal(v[n_real:], vel[n_real:])
    np.testing.assert_array_equal(a[n_real:], 0.0)
    np.testing.assert_array_equal(p[:, 3], pm[:, 3])  # masses ride along


@pytest.mark.parametrize("n_real", [256, 250])
def test_fused_twin_is_force_exact_then_verlet(rng, n_real):
    """Bit for bit, as the kernel on the card equals ``force_exact`` and
    the torch Verlet."""
    n = 256
    pm, vel, aold = (torch.from_numpy(x) for x in random_state(rng, n))
    got = cf.fused_step_exact(pm, vel, aold, DT, G, eps2=EPS2, n_real=n_real)
    a = cf.force_exact(pm, pm, G, EPS2)
    want = apply_integrator("verlet", pm, vel, aold, a, DT, valid_mask(n, n_real, "cpu"))
    for x, w in zip(got, want):
        assert torch.equal(x, w)


def test_fused_dt_zero_is_identity_except_accel(rng):
    pm, vel, aold = random_state(rng, 256)
    p, v, a = port_fused(pm, vel, aold, 0.0, 256)
    np.testing.assert_array_equal(p, pm)
    np.testing.assert_array_equal(v, vel)
    np.testing.assert_allclose(a, jax_fused(pm, vel, aold, 0.0, 256)[2], rtol=1e-5, atol=1e-7)


def test_fused_wrapper_checks_input(rng):
    pm, vel, aold = (torch.from_numpy(x) for x in random_state(rng, 256))
    with pytest.raises(ValueError, match="eps2"):
        cf.fused_step_exact(pm, vel, aold, DT, G, eps2=0.0, n_real=256)
    with pytest.raises(ValueError, match="eps2"):
        cf.fused_step_exact(pm, vel, aold, DT, G, eps2=-1e-4, n_real=256)
    with pytest.raises(ValueError, match="one shape"):
        cf.fused_step_exact(pm, vel, aold[:128].clone(), DT, G, eps2=EPS2, n_real=256)
    with pytest.raises(RuntimeError, match="never take such tensors"):
        cf.fused_step_exact(pm.clone().requires_grad_(), vel, aold, DT, G, eps2=EPS2, n_real=256)


# ------------------------------------------------------------- the engine
def run_steps(cfg, pm, vel, n_real, k=2):
    n = pm.shape[0]
    step = make_step_fn(cfg, n, n_real, "cpu")
    s = SimState(torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((n, 4)), 0)
    for _ in range(k):
        s = step(s, DT, G)
    return s


def composed_steps(mode, pm, vel, n_real, k=2):
    """k steps of the force twin and ``apply_integrator("verlet")`` with the
    valid mask, spelled out: what the fused kernel equals bit for bit."""
    n = pm.shape[0]
    force = cf.force_exact if mode == "exact" else cf.force_fast
    p, v, a = torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((n, 4))
    for _ in range(k):
        p, v, a = apply_integrator("verlet", p, v, a, force(p, p, G, EPS2), DT, valid_mask(n, n_real, "cpu"))
    return p, v, a


@pytest.mark.parametrize("n_real", [256, 230])
def test_fused_engine_matches_unfused(rng, n_real):
    """``tests/test_step.py:49-61``: the step, with either value of
    ``fuse_integrate``, against the unfused exact step spelled out
    (``force_exact`` then the torch Verlet); on the CPU both run the same
    twins in the same order, so they agree bit for bit, within the
    reference's rtol 1e-6 / atol 1e-7."""
    pm, vel, _ = random_state(rng, 256, n_real)
    want = composed_steps("exact", pm, vel, n_real)
    for fuse in (True, False):
        s = run_steps(SimConfig(fuse_integrate=fuse), pm, vel, n_real)
        assert s.step == 2
        for x, w in zip((s.pos_mass, s.vel, s.accel), want):
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
            assert torch.equal(x, w)


def test_fused_simulation_matches_jax():
    """``Simulation`` with ``fuse_integrate=True`` against the JAX
    package's fused engine (interpret mode), three steps of plummer
    n = 600; no kernel launches on the CPU."""
    reset_launch_counts()
    ts = Simulation.from_preset("plummer", SimConfig(fuse_integrate=True), n=600, device="cpu")
    js = JaxSimulation.from_preset("plummer", JaxConfig(backend="pallas", fuse_integrate=True), n=600, platform="cpu")
    ts.run(3, chunk=3)
    js.run(3, chunk=3)
    (p, v, a), (p0, v0, a0) = ts.arrays(), js.arrays()
    np.testing.assert_allclose(p, p0, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v, v0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a, a0, rtol=1e-5, atol=1e-7 * np.abs(a0).max())
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("kw", [{"integrator": "yoshida4"}, {"integrator": "euler"}])
def test_fuse_integrate_other_integrators_take_unfused_route(rng, kw):
    """As in JAX, ``fuse_integrate`` fuses only Verlet: the exact step with
    another integrator is the unfused one."""
    pm, vel, _ = random_state(rng, 256)
    sf = run_steps(SimConfig(fuse_integrate=True, **kw), pm, vel, 256)
    su = run_steps(SimConfig(**kw), pm, vel, 256)
    for x, w in zip((sf.pos_mass, sf.vel, sf.accel), (su.pos_mass, su.vel, su.accel)):
        assert torch.equal(x, w)


@pytest.mark.parametrize("what", ["v0", "dt", "G", "pos_mass"])
def test_fused_step_refuses_gradients(rng, what):
    """The JAX fused step has no VJP; the port's raises instead of running
    on without a graph.  On inputs that need no gradient the step runs."""
    pm, vel, _ = random_state(rng, 256)
    step = make_step_fn(SimConfig(fuse_integrate=True), 256, 256, "cpu")
    p, v = torch.from_numpy(pm), torch.from_numpy(vel)
    dt, g = torch.tensor(DT), torch.tensor(G)
    x = {"v0": v, "dt": dt, "G": g, "pos_mass": p}[what]
    x.requires_grad_()
    with pytest.raises(RuntimeError, match="fuse_integrate=True.*no gradient"):
        step(SimState(p, v, torch.zeros_like(p), 0), dt, g)
    assert step(SimState(p.detach(), v.detach(), torch.zeros_like(p), 0), DT, G).step == 1


# ------------------------------------------ the route of the default step
FORCE = {"exact": "force_exact", "fast": "force_fast"}
FUSED = {"exact": "fused_step_exact", "fast": "fused_step_fast"}


def spied_step(monkeypatch, cfg, n, n_real):
    """``make_step_fn(cfg)`` built over counting spies of the ``ops.step``
    module's wrappers and of the accelerations ``make_diff_accel`` makes:
    ``(calls by name, step)``."""
    calls = collections.Counter()

    def spy(name, fn):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return counted

    for name in (*FORCE.values(), *FUSED.values()):
        monkeypatch.setattr(tstep, name, spy(name, getattr(tstep, name)))
    make = tstep.make_diff_accel
    monkeypatch.setattr(tstep, "make_diff_accel", lambda *a, **kw: spy("make_diff_accel", make(*a, **kw)))
    return calls, make_step_fn(cfg, n, n_real, "cpu")


@pytest.mark.parametrize("via", ["make_step_fn", "Simulation"])
@pytest.mark.parametrize("n_real", [256, 230])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_default_verlet_step_runs_the_fused_kernel(rng, monkeypatch, mode, n_real, via):
    """``SimConfig(force_mode=mode)`` on inputs that need no gradient,
    stepped by ``make_step_fn``'s step or by ``Simulation.run`` (which pads
    ``n_real`` rows to 256): one fused call a step and no force call, and
    the state equals the force twin followed by the torch Verlet bit for
    bit."""
    pm, vel, _ = random_state(rng, 256, n_real)
    cfg = SimConfig(force_mode=mode, dt=DT, G=G, eps2=EPS2)
    calls, step = spied_step(monkeypatch, cfg, 256, n_real)
    if via == "Simulation":
        sim = Simulation(cfg, pm[:n_real], vel[:n_real], device="cpu")
        assert sim.n_pad == 256
        s = sim.run(2, chunk=2)
    else:
        s = SimState(torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((256, 4)), 0)
        for _ in range(2):
            s = step(s, DT, G)
    assert calls == {FUSED[mode]: 2}
    for x, w in zip((s.pos_mass, s.vel, s.accel), composed_steps(mode, pm, vel, n_real)):
        assert torch.equal(x, w)


@pytest.mark.parametrize("what", ["v0", "dt", "G"])
@pytest.mark.parametrize("n_real", [256, 230])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_verlet_step_with_a_gradient_takes_the_force_route(rng, monkeypatch, mode, n_real, what):
    """A step whose ``v0``, ``dt`` or ``G`` requires grad runs the force
    wrapper through ``make_diff_accel`` and autograd through the torch
    Verlet, with no fused call; its gradient is the ``backend="jnp"``
    route's (the port's plain route) within the rollout tolerance (rtol
    2e-3, ``tests/test_torch_grad.py``).  Under ``fuse_integrate=True`` the
    same request raises.  The gradient against the JAX package's is held
    by ``test_torch_grad.py::test_rollout_grad_matches_jax_pallas_step``."""
    n, k = 256, 3
    pm, vel, _ = random_state(rng, n, n_real)

    def grad(step):
        args = {"v0": torch.from_numpy(vel.copy()), "dt": DT, "G": G}
        x = args[what] = torch.as_tensor(args[what]).requires_grad_()
        s = SimState(torch.from_numpy(pm.copy()), args["v0"], torch.zeros((n, 4)), 0)
        for _ in range(k):
            s = step(s, args["dt"], args["G"])
        return torch.autograd.grad(torch.sum(s.pos_mass[:n_real, :3] ** 2), x)[0].numpy()

    calls, step = spied_step(monkeypatch, SimConfig(force_mode=mode), n, n_real)
    got = grad(step)
    assert calls == {FORCE[mode]: k, "make_diff_accel": k}
    want = grad(make_step_fn(SimConfig(backend="jnp"), n, n_real, "cpu"))
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-6 * np.abs(want).max())
    with pytest.raises(RuntimeError, match="fuse_integrate=True.*no gradient"):
        grad(make_step_fn(SimConfig(force_mode=mode, fuse_integrate=True), n, n_real, "cpu"))


class CardScalar(torch.Tensor):
    """A CPU tensor that reports itself on the card: what the step's test
    of a CUDA ``dt`` sees, without a card.  Results of torch ops on it are
    plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl
    is_cuda = property(lambda self: True)


@pytest.mark.parametrize("where", ["cpu", "cuda"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_tensor_dt_without_gradient(rng, monkeypatch, mode, fuse, where):
    """A 0-d CUDA tensor ``dt`` that needs no gradient stays on the device
    through the force route, as the fused kernel would read it on the host
    (a wait for the card); ``fuse_integrate=True`` still fuses, and a CPU
    tensor, which the host reads for free, fuses either way.  The same
    bits on every route."""
    pm, vel, _ = random_state(rng, 256, 230)
    calls, step = spied_step(monkeypatch, SimConfig(force_mode=mode, fuse_integrate=fuse), 256, 230)
    dt = torch.tensor(DT)
    dt = dt.as_subclass(CardScalar) if where == "cuda" else dt
    s = SimState(torch.from_numpy(pm.copy()), torch.from_numpy(vel.copy()), torch.zeros((256, 4)), 0)
    for _ in range(2):
        s = step(s, dt, G)
    composed = where == "cuda" and not fuse
    assert calls == ({FORCE[mode]: 2, "make_diff_accel": 2} if composed else {FUSED[mode]: 2})
    for x, w in zip((s.pos_mass, s.vel, s.accel), composed_steps(mode, pm, vel, 230)):
        assert type(x) is torch.Tensor and torch.equal(x, w)
