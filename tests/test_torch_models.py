"""The port's presets give the JAX package's arrays bit for bit."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu.models.registry import make_preset as jax_make_preset  # noqa: E402
from nbody3d_tpu_torch.models.registry import PRESETS  # noqa: E402
from nbody3d_tpu_torch.models.registry import make_preset  # noqa: E402

CASES = [
    ("two-galaxy", None, 0),
    ("two-galaxy", 2002, 3),
    ("reference-random", 1000, 1),
    ("collision", 802, 2),
    ("plummer", 3000, 4),
    ("plummer", None, 0),
    ("uniform-sphere", None, 5),
    ("uniform-sphere", 4096, 0),
    ("fibonacci-shell", 777, 6),
    ("uniform-box", 1500, 7),
]


@pytest.mark.parametrize("name,n,seed", CASES)
def test_preset_bit_equal(name, n, seed):
    got = make_preset(name, seed=seed, G=2e-4, n=n)
    want = jax_make_preset(name, seed=seed, G=2e-4, n=n)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_every_ported_preset_is_tested():
    assert {c[0] for c in CASES} == set(PRESETS)


def test_reference_random_settings_bit_equal():
    kw = dict(num_galaxies=3, min_bodies=100, max_bodies=300)
    got = make_preset("reference-random", seed=9, **kw)
    want = jax_make_preset("reference-random", seed=9, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cosmo_names_its_roadmap_item():
    with pytest.raises(KeyError, match="ROADMAP.md"):
        make_preset("cosmo")
    with pytest.raises(KeyError, match="unknown preset"):
        make_preset("no-such-preset")
