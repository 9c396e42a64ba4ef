"""The package root's step API against the JAX package's on the CPU:
``verlet_step``/``euler_step`` on a ``SimState`` (``ops/integrate.py``)
bit for bit against ``nbody3d_tpu.ops.integrate`` on the cases of
``tests/test_integrate.py`` (the closed form, the mass lane, the zero first
kick, Euler, the padding mask) and on a random padded state, with
``accel_direct`` as the force; and the names both top levels export."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu as jax_pkg  # noqa: E402
import nbody3d_tpu.ops.integrate as jint  # noqa: E402
import nbody3d_tpu_torch as pkg  # noqa: E402
from nbody3d_tpu.state import init_state as jax_init_state  # noqa: E402
from nbody3d_tpu_torch.ops import integrate  # noqa: E402


def _random(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(0.5, 2.0, (n, 1))], axis=1)
    vel = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], axis=1)
    acc = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], axis=1)
    return dict(pos=pos, vel=vel, accel=acc, n_pad=n + 5, a_new=None, dt=3e-3, n_real=n)


# tests/test_integrate.py:20-75, then a random state whose force is accel_direct
CASES = {
    "verlet_closed_form": ("verlet", dict(pos=[[1.0, 2.0, 3.0, 7.0]], vel=[[0.5, -0.5, 1.0, 0.0]],
                                          accel=[[0.2, 0.0, -0.1, 0.0]], a_new=[[0.4, 0.1, 0.3, 0.0]], dt=0.1)),
    "mass_invariant": ("verlet", dict(pos=[[0, 0, 0, 123.5]], vel=[[1, 2, 3, 0]], a_new=[[9.0, 9.0, 9.0, 0.0]],
                                      dt=0.25)),
    "first_step_zero_accel": ("verlet", dict(pos=[[0, 0, 0, 1.0]], vel=[[0, 0, 0, 0]], a_new=[[1.0, 0, 0, 0]],
                                             dt=0.01)),
    "euler": ("euler", dict(pos=[[0, 0, 0, 1.0]], vel=[[1, 0, 0, 0]], a_new=[[2.0, 0, 0, 0]], dt=0.1)),
    "padding_mask": ("verlet", dict(pos=[[0, 0, 0, 5.0], [1, 1, 1, 5.0]], vel=[[1, 1, 1, 0], [1, 1, 1, 0]],
                                    n_pad=8, a_new=np.ones((8, 4)) * [1, 1, 1, 0], dt=0.5, n_real=2)),
    "random_verlet": ("verlet", _random(61, 0)),
    "random_euler": ("euler", _random(61, 1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_steps_bit_equal_to_jax(name):
    kind, c = CASES[name]
    f32 = {k: None if c.get(k) is None else np.asarray(c[k], np.float32) for k in ("pos", "vel", "accel", "a_new")}
    js = jax_init_state(f32["pos"], f32["vel"], f32["accel"], n_pad=c.get("n_pad"))
    ts = pkg.init_state(f32["pos"], f32["vel"], f32["accel"], n_pad=c.get("n_pad"), device="cpu")
    if f32["a_new"] is None:  # the force of the real rows, padding massless
        a_t = pkg.accel_direct(ts.pos_mass, 1e-3)
        a_j = jnp.asarray(a_t.numpy())
    else:
        a_j, a_t = jnp.asarray(f32["a_new"]), torch.from_numpy(f32["a_new"])
    n_real = c.get("n_real")
    out_j = jint.INTEGRATORS[kind](js, a_j, c["dt"], n_real=n_real)
    out_t = integrate.INTEGRATORS[kind](ts, a_t, c["dt"], n_real=n_real)
    assert out_t.step == int(out_j.step) == 1
    for t, j in zip((out_t.pos_mass, out_t.vel, out_t.accel), (out_j.pos_mass, out_j.vel, out_j.accel)):
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j).view(np.uint32))
    if n_real is not None and n_real < ts.n_pad:
        assert not out_t.pos_mass[n_real:].any() and not out_t.accel[n_real:].any()


def test_root_exports_the_jax_packages_step_api():
    """``from nbody3d_tpu_torch import accel_direct, verlet_step,
    euler_step, diagnostics`` works; the root names every name of the JAX
    package's ``__all__``; the integrator tables have the same keys."""
    assert set(jax_pkg.__all__) <= set(pkg.__all__)
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None
    assert pkg.verlet_step is integrate.verlet_step and pkg.euler_step is integrate.euler_step
    assert pkg.diagnostics.compute is not None and callable(pkg.accel_direct)
    assert sorted(integrate.INTEGRATORS) == sorted(jint.INTEGRATORS)
