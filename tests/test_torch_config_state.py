"""Config JSON interchange and the state helpers, port vs JAX package."""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu import config as jcfg  # noqa: E402
from nbody3d_tpu import state as jstate  # noqa: E402
from nbody3d_tpu_torch import config as tcfg  # noqa: E402
from nbody3d_tpu_torch import state as tstate  # noqa: E402


def test_simconfig_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.SimConfig)]
    assert jf == tf
    jg = [(f.name, f.default) for f in dataclasses.fields(jcfg.GalaxyConfig)]
    tg = [(f.name, f.default) for f in dataclasses.fields(tcfg.GalaxyConfig)]
    assert jg == tg


@pytest.mark.parametrize(
    "kw",
    [{}, {"force_mode": "sym", "morton_every": 64, "dt": 3e-4, "G": 1e-3},
     {"integrator": "yoshida4", "backend": "jnp", "seed": 7}],
)
def test_simconfig_json_round_trips_between_packages(kw):
    j = jcfg.SimConfig(**kw)
    t = tcfg.SimConfig(**kw)
    assert j.to_json() == t.to_json()
    assert tcfg.SimConfig.from_json(j.to_json()) == t
    assert jcfg.SimConfig.from_json(t.to_json()) == j
    d = json.loads(t.to_json())
    d["unknown_field"] = 1
    assert tcfg.SimConfig.from_json(json.dumps(d)) == t


def test_sliders():
    assert tcfg.log_slider_dt(-4) == jcfg.log_slider_dt(-4)
    assert tcfg.log_slider_G(-2.5) == jcfg.log_slider_G(-2.5)


def test_pad_count():
    for n, m in [(1, 8), (40002, 256), (256, 256), (257, 256)]:
        assert tstate.pad_count(n, m) == jstate.pad_count(n, m)
    with pytest.raises(ValueError):
        tstate.pad_count(5, 0)


def _arrays(rng, n):
    pm = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(1, 50, (n, 1))], 1)
    vel = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], 1)
    acc = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], 1)
    return pm, vel, acc


@pytest.mark.parametrize("accel", [False, True])
def test_init_state_matches_jax(rng, accel):
    pm, vel, acc = _arrays(rng, 37)
    a = acc if accel else None
    t = tstate.init_state(pm, vel, a, n_pad=48, step=5, device="cpu")
    j = jstate.init_state(pm, vel, a, n_pad=48, step=5)
    for name in ("pos_mass", "vel", "accel"):
        tt = getattr(t, name)
        assert tt.dtype == torch.float32 and tt.device.type == "cpu"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(getattr(j, name)))
    assert t.step == int(j.step) == 5
    assert t.n_pad == j.n_pad == 48


def test_unpad_matches_jax(rng):
    pm, vel, acc = _arrays(rng, 20)
    t = tstate.init_state(pm, vel, acc, n_pad=32, device="cpu")
    j = jstate.init_state(pm, vel, acc, n_pad=32)
    for a, b in zip(tstate.unpad(t, 20), jstate.unpad(j, 20)):
        np.testing.assert_array_equal(a, b)


def test_state_from_numpy_carries_jax_state(rng):
    pm, vel, acc = _arrays(rng, 30)
    j = jstate.init_state(pm, vel, acc, n_pad=64, step=3)
    real = jstate.unpad(j, 30)
    t = tstate.state_from_numpy(*real, step=3, n_pad=64, device="cpu")
    for name in ("pos_mass", "vel", "accel"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.step == 3


def test_init_state_rejects_bad_shapes(rng):
    pm, vel, _ = _arrays(rng, 10)
    with pytest.raises(ValueError):
        tstate.init_state(pm[:, :3], vel, device="cpu")
    with pytest.raises(ValueError):
        tstate.init_state(pm, vel[:5], device="cpu")
    with pytest.raises(ValueError):
        tstate.init_state(pm, vel, n_pad=4, device="cpu")
    with pytest.raises(TypeError):
        tstate.init_state(pm, vel)  # the device is never implied
