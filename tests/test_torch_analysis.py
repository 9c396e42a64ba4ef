"""The analysis layer of the port (``nbody3d_tpu_torch/analysis.py``)
against the JAX package's on the CPU: ``summary`` (rtol 1e-5, atol 1e-6 of
each entry's largest value; one host read), ``power_spectrum`` (mode counts
exact at power-of-two grids, P at rtol 1e-4 and 1e-6 of the largest bin:
float32 FFT roundoff; isolated and periodic, deconvolved or not, padded
rows), ``shot_noise``, friends-of-friends (the C core and its Python twin
give JAX's partition, across the periodic seam too; a failed build
raises), ``quantize_for_fof`` (words bit for bit), the streamed FoF,
``group_catalog``, ``format_report``, and ``cli analyze`` and ``run
--analyze-every`` against JAX's CLI.

Inputs: Plummer spheres, uniform and clustered boxes from numpy seeds, with
integer masses where an order statistic (a Lagrangian radius) would
otherwise turn on the last bit of a cumulative sum."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.overrides import TorchFunctionMode  # noqa: E402

from nbody3d_tpu import analysis as janalysis  # noqa: E402
from nbody3d_tpu import cli as jax_cli  # noqa: E402
from nbody3d_tpu import native  # noqa: E402
from nbody3d_tpu.models.plummer import plummer_sphere  # noqa: E402
from nbody3d_tpu_torch import _build, analysis, cli  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402

G = 1e-4


class HostReads(TorchFunctionMode):
    """Counts the tensor methods that bring values to the host."""

    NAMES = {"item", "tolist", "cpu", "numpy", "__float__", "__int__", "__bool__", "__index__"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.count += getattr(func, "__name__", "") in self.NAMES
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def plummer():
    """4,000 Plummer bodies of mass 250 (the JAX tests' M/N), padded with 48
    mass-0 rows."""
    pm, vel, _ = plummer_sphere(4000, G=G, total_mass=1.0e6, scale_radius=1.0, max_radius_factor=50.0,
                                rng=np.random.default_rng(42))
    pad = np.zeros((48, 4), np.float32)
    pad[:, :3] = 7.0
    return np.concatenate([pm, pad]).astype(np.float32), np.concatenate([vel, np.ones_like(pad)]).astype(np.float32)


def _close(got, want, what: str, rtol: float = 1e-5) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("potential", [True, False])
def test_summary_matches_jax_in_one_host_read(plummer, potential):
    pm, vel = plummer
    reads = HostReads()
    with reads:
        got = analysis.summary(torch.from_numpy(pm), torch.from_numpy(vel), G, nbins=16, potential=potential,
                               pe_chunk=1012)
    want = janalysis.summary(pm, vel, G, nbins=16, potential=potential, pe_chunk=1012)
    assert reads.count == 1
    assert got.keys() == want.keys() and got["n_massive"] == want["n_massive"] == 4000
    for key in want:
        if isinstance(want[key], dict):
            assert got[key].keys() == want[key].keys()
            for sub in want[key]:
                _close(got[key][sub], want[key][sub], f"{key}.{sub}")
        elif key != "n_massive":
            _close(got[key], want[key], key)
    assert analysis.format_report(got).splitlines()[0] == janalysis.format_report(want).splitlines()[0]
    json.dumps(got)


def test_format_report_matches_jax(plummer):
    pm, vel = plummer
    s = janalysis.summary(pm, vel, G, nbins=8, pe_chunk=1012)
    assert analysis.format_report(s) == janalysis.format_report(s)
    s.pop("potential")
    assert analysis.format_report(s) == janalysis.format_report(s)


@pytest.mark.parametrize("fn", ["lagrangian_radii", "density_profile", "velocity_dispersion_profile",
                                "kinetic_energy_com", "virial_ratio", "com_frame"])
def test_statistics_match_jax(plummer, fn):
    pm, vel = plummer
    t = torch.from_numpy(pm), torch.from_numpy(vel)
    args = {"lagrangian_radii": ((pm,), (t[0],)), "density_profile": ((pm, 12, 3.0), (t[0], 12, 3.0)),
            "velocity_dispersion_profile": ((pm, vel, 12), (*t, 12)), "kinetic_energy_com": ((pm, vel), t),
            "virial_ratio": ((pm, vel, G), (*t, G)), "com_frame": ((pm, vel), t)}[fn]
    kw = {"chunk": 1012} if fn == "virial_ratio" else {}
    want = getattr(janalysis, fn)(*args[0], **kw)
    got = getattr(analysis, fn)(*args[1], **kw)
    for g, w in zip(*((x,) if not isinstance(x, tuple) else x for x in (got, want))):
        _close(g.numpy(), w, fn)


def _spectrum_scene(kind: str):
    rng = np.random.default_rng(7)
    if kind == "plane-wave":  # tests/test_analysis.py's closed form: an exact lattice deposit
        g, box = 16, 1.0
        ax = (np.arange(g) + 0.5) / g
        pos = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
        m = 1.0 + 0.1 * np.cos(2.0 * np.pi * 4 * pos[:, 0])
        return np.concatenate([pos, m[:, None]], 1).astype(np.float32), box
    if kind == "clustered":  # clumps in a box, bodies across the seams
        c = rng.uniform(0, 2.0, (6, 3))
        pos = np.concatenate([cc + rng.normal(0, 0.05, (300, 3)) for cc in c] + [rng.uniform(-0.2, 2.2, (800, 3))])
        m = rng.integers(1, 5, (len(pos), 1))
        pm = np.concatenate([pos, m], 1).astype(np.float32)
        return np.concatenate([pm, np.zeros((40, 4), np.float32)]), 2.0
    pos = rng.normal(0.0, 1.0, (3000, 3))
    pm = np.concatenate([pos[np.abs(pos).max(1) < 3.0], np.ones((len(pos), 1))[: (np.abs(pos).max(1) < 3.0).sum()]],
                        1).astype(np.float32)
    return np.concatenate([pm, np.zeros((24, 4), np.float32)]), None


@pytest.mark.parametrize(
    "kind,grid,kw",
    [("plane-wave", 16, dict(nbins=8, deconvolve=False)), ("clustered", 16, {}), ("clustered", 32, dict(nbins=11)),
     ("blob", 16, {}), ("blob", 32, dict(deconvolve=False))],
)
def test_power_spectrum_matches_jax(kind, grid, kw):
    """Mode counts per bin equal JAX's exactly at these power-of-two grids
    (the box and ``|k|`` built in the compiled reference's float32 steps:
    a mode on a shell edge goes by the last bit), P within rtol 1e-4 and
    1e-6 of the largest bin (pocketfft against XLA's FFT in float32), the
    bin centres within 1e-6; the scenes carry mass-0 padding rows."""
    pm, box = _spectrum_scene(kind)
    got = analysis.power_spectrum(torch.from_numpy(pm), grid, box_size=box, **kw)
    want = janalysis.power_spectrum(pm, grid, box_size=box, **kw)
    k, p, cnt = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[2].numpy(), cnt)
    assert cnt.sum() > 0 and (cnt[1:] > 0).all()
    np.testing.assert_allclose(got[0].numpy(), k, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), p, rtol=1e-4, atol=1e-6 * p.max())
    if box is not None:
        _close(analysis.shot_noise(torch.from_numpy(pm), box**3).numpy(), janalysis.shot_noise(pm, box**3), "shot")


# ------------------------------------------------------- friends-of-friends


def _partition(labels):
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(v) for v in groups.values())


def _fof_scene(kind: str):
    rng = np.random.default_rng(5)
    if kind == "seam":  # tests/test_analysis.py::test_fof_periodic_seam's clump across x = 0
        x = rng.normal(0.0, 0.02, (800, 3))
        x[:, 1:] += 1.0
        pm = np.concatenate([x % 2.0, np.ones((800, 1))], 1).astype(np.float32)
        back = rng.uniform(0, 2, (200, 4)).astype(np.float32)
        back[100:, 3] = 0.0  # mass-0 rows: labelled -1
        return np.concatenate([pm, back]), 0.05, 2.0
    c = rng.uniform(-4, 4, (6, 3))
    pts = np.concatenate([cc + rng.normal(scale=0.02, size=(50, 3)) for cc in c] + [rng.uniform(-6, 6, (400, 3))])
    pm = np.concatenate([pts, rng.uniform(1, 50, (len(pts), 1))], 1).astype(np.float32)
    return pm, (0.08 if kind == "clumps" else None), (None if kind != "clumps-periodic" else 12.0)


@pytest.mark.parametrize("kind", ["clumps", "clumps-auto", "clumps-periodic", "seam"])
def test_fof_matches_jax(kind):
    """The C core's labels are JAX's (the same union-find: equal labels, not
    only the same partition), its Python twin's partition too, and the
    same linking length."""
    pm, ll, box = _fof_scene(kind)
    got, got_ll = analysis.fof_groups(torch.from_numpy(pm), ll, box_size=box)
    want, want_ll = janalysis.fof_groups(pm, ll, box_size=box)
    assert got_ll == want_ll
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 2 and (got[pm[:, 3] == 0] == -1).all()
    sel = pm[:, 3] > 0
    pos = pm[sel, :3].astype(np.float32)
    if box:
        pos = pos - box * np.floor(pos / box)
        n_cell = max(int(box / got_ll), 1)
        cell, dims = np.minimum((pos / (box / n_cell)).astype(np.int32), n_cell - 1), (n_cell,) * 3
    else:
        cell = ((pos - pos.min(0)) / np.float32(got_ll)).astype(np.int32)
        dims = tuple(int(d) + 1 for d in cell.max(0))
    twin = analysis._fof_python(pos, cell, dims, got_ll * got_ll, float(box or 0.0))
    assert _partition(twin) == _partition(want[sel])


def test_fof_failed_build_raises(monkeypatch, tmp_path):
    """No fallback to the Python loop: a compiler that fails raises with its
    output."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CC", "false")
    _build.load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed to build _fof.c"):
            analysis.fof_groups(np.ones((8, 4), np.float32), 0.5)
    finally:
        _build.load_host_library.cache_clear()


@pytest.mark.parametrize("box", [None, 12.0])
def test_quantize_for_fof_bit_equal(box):
    pm, _, _ = _fof_scene("clumps")
    got = analysis.quantize_for_fof(torch.from_numpy(pm), box_size=box)
    want = [np.asarray(x) for x in janalysis.quantize_for_fof(pm, box_size=box)]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w)
        assert g.numpy().max() <= np.iinfo(w.dtype).max
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    words = analysis._fetch_words(*got)
    for g, w in zip(words, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("box", [None, 2.0])
def test_fof_streamed_and_catalog_match_jax(box):
    """tests/test_analysis.py::test_fof_streamed_matches_exact on the port:
    the streamed labels, linking length and dequantized rows equal JAX's,
    the partition that of the direct FoF; the catalogs (direct with
    velocities, streamed without) equal JAX's."""
    pm, ll, _ = _fof_scene("clumps") if box is None else _fof_scene("seam")
    pm = pm[pm[:, 3] > 0]
    vel = np.random.default_rng(1).normal(size=pm.shape).astype(np.float32)
    labels, got_ll, pm_q = analysis.fof_groups_streamed(torch.from_numpy(pm), ll, box_size=box)
    jlabels, jll, jpm_q = janalysis.fof_groups_streamed(pm, ll, box_size=box)
    assert got_ll == jll
    np.testing.assert_array_equal(pm_q, jpm_q)
    np.testing.assert_array_equal(labels, jlabels)
    direct, _ = analysis.fof_groups(pm, ll, box_size=box)
    assert _partition(direct) == _partition(labels)
    for args in ((pm, vel, direct), (pm_q, None, labels)):
        got = analysis.group_catalog(*args, min_size=20, box_size=box)
        want = janalysis.group_catalog(*args, min_size=20, box_size=box)
        assert got == want and len(got) >= 1
    assert "vcom" not in got[0]


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A two-galaxy run's final.npz (1,026 bodies, 2 steps, the port's CLI)."""
    out = tmp_path_factory.mktemp("run")
    assert cli.main(["run", "--preset", "two-galaxy", "--n", "1026", "--steps", "2", "--log-every", "2",
                     "--device", "cpu", "--outdir", str(out)]) == 0
    return out / "final.npz"


@pytest.mark.parametrize("extra", [["--fof", "--fof-min-size", "50", "--power-spectrum", "16", "--ps-out", "PS"],
                                   ["--fof", "--fof-stream", "always", "--fof-min-size", "5", "--pe", "skip"]])
def test_cli_analyze_matches_jax(checkpoint, tmp_path, capsys, extra):
    """``analyze --json`` of one checkpoint through both CLIs: the same keys
    and values (summary rtol 1e-5, the FoF catalog equal, P(k) counts equal
    and P at rtol 1e-4), the same P(k) CSV header and rows; the text report
    names the groups."""
    extra = [str(tmp_path / "ps.csv") if e == "PS" else e for e in extra]
    args = ["analyze", str(checkpoint), "--json", "--bins", "8"] + extra
    reset_launch_counts()
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    csv = (tmp_path / "ps.csv").read_text().splitlines() if "--ps-out" in extra else None
    assert jax_cli.main(args + ["--backend", "jnp"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(c == 0 for c in launch_counts().values())
    assert got.keys() == want.keys() and got["step"] == want["step"] == 2
    assert got["fof"] == want["fof"] and want["fof"]["n_groups"] >= 1
    assert ("virial_ratio" in got) == ("--pe" not in extra)
    for key in ("total_mass", "kinetic", "kinetic_com") + (("potential", "virial_ratio") if "virial_ratio" in want
                                                           else ()):
        _close(got[key], want[key], key)
    if "power_spectrum" in want:
        ps, jps = got["power_spectrum"], want["power_spectrum"]
        assert ps["n_modes"] == jps["n_modes"]
        _close(ps["P"], jps["P"], "P", rtol=1e-4)
        _close(ps["k"] + [ps["shot_noise"]], jps["k"] + [jps["shot_noise"]], "k")
        jcsv = (tmp_path / "ps.csv").read_text().splitlines()
        assert csv[0] == jcsv[0] == "k,P,n_modes" and len(csv) == len(jcsv) == 9
    assert cli.main(["analyze", str(checkpoint), "--bins", "8", "--fof", "--fof-min-size", "50", "--device",
                     "cpu"]) == 0
    assert "fof groups" in capsys.readouterr().out


def test_cli_analyze_profile_and_ps_out_needs_spectrum(checkpoint, tmp_path, capsys):
    csv = tmp_path / "profile.csv"
    assert cli.main(["analyze", str(checkpoint), "--bins", "8", "--profile", str(csv), "--device", "cpu"]) == 0
    lines = csv.read_text().splitlines()
    assert lines[0].startswith("r_lo,") and len(lines) == 9
    assert cli.main(["analyze", str(checkpoint), "--ps-out", str(tmp_path / "x.csv"), "--device", "cpu"]) == 2


def test_cli_run_analyze_every_matches_jax(tmp_path, capsys):
    """tests/test_analysis.py::test_cli_run_analyze_every through both CLIs:
    records at steps 2 and 4, the same keys, values at rtol 1e-5."""
    args = ["run", "--preset", "plummer", "--n", "256", "--steps", "4", "--log-every", "2", "--analyze-every",
            "2"]
    assert cli.main(args + ["--device", "cpu", "--outdir", str(tmp_path / "t")]) == 0
    assert "r50=" in capsys.readouterr().out
    assert jax_cli.main(args + ["--backend", "jnp", "--block-target", "32", "--block-source", "32", "--outdir",
                                str(tmp_path / "j")]) == 0
    recs, jrecs = ([json.loads(line) for line in (tmp_path / d / "analysis.jsonl").read_text().splitlines()]
                   for d in ("t", "j"))
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == [2, 4]
    for r, jr in zip(recs, jrecs):
        assert r.keys() == jr.keys() and "potential" not in r
        for key in ("total_mass", "kinetic", "com", "velocity_dispersion"):
            _close(r[key], jr[key], key, rtol=1e-4)
        _close(list(r["lagrangian_radii"].values()), list(jr["lagrangian_radii"].values()), "lagrangian", 1e-4)


def test_native_core_is_the_ports_own():
    """The JAX package's native module is not what the port loads: the port
    builds its own copy into its _build directory."""
    lib = _build.load_host_library("_fof")
    assert str(_build.BUILD_ROOT) in lib._name and "nbody3d_tpu/native" not in lib._name
    assert native.fof is not None  # the JAX side's core, for the reference values
