"""The port's checkpoint directory (``utils/checkpoint.py::save_dir``,
``load_dir``, ``peek_config``) against the JAX package's orbax directory,
on the CPU.

The two packages cannot read each other's directories (the port writes
them with ``torch.distributed.checkpoint`` and cannot import orbax), so the
directory is held to what orbax stores for the same state: the arrays bit
for bit, the step, dt and G equal, and the ``config_json``/``camera_json``
strings equal to those the JAX package stored.  The ``.npz`` file is the
bridge between the two, and the test carries a state across it both ways
bit for bit.  Also: a failed save leaves the old checkpoint whole, the
orbax directory and broken paths raise ``ValueError``s that name the path,
the CLI's resume semantics through a directory, and a 2-rank gloo mesh
that saves one directory and loads it on one device and on the mesh."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)
ocp = pytest.importorskip("orbax.checkpoint")

import torch.distributed.checkpoint as dcp  # noqa: E402
from torch.distributed.checkpoint.api import CheckpointException  # noqa: E402

from nbody3d_tpu import cli as jax_cli  # noqa: E402
from nbody3d_tpu.config import SimConfig as JaxConfig  # noqa: E402
from nbody3d_tpu.engine import Simulation as JaxSimulation  # noqa: E402
from nbody3d_tpu_torch import SimConfig, Simulation, cli  # noqa: E402
from nbody3d_tpu_torch.parallel import rank_checks  # noqa: E402
from nbody3d_tpu_torch.parallel.launch import spawn  # noqa: E402
from nbody3d_tpu_torch.render.image import read_png  # noqa: E402
from nbody3d_tpu_torch.utils import checkpoint  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402

N = 512  # two galaxies of 255 disk bodies and a centre each
STRINGS = ("config_json", "camera_json")


@pytest.fixture(scope="module")
def sims():
    """A JAX and a port Simulation on one two-galaxy state after 2 steps
    (non-zero lagged accel), with runtime dt/G changed from the config."""
    js = JaxSimulation.from_preset("two-galaxy", JaxConfig(backend="jnp", G=3e-4), n=N, platform="cpu")
    js.run(2, chunk=2)
    js.dt, js.G = 2e-4, 5e-4
    pm, vel, acc = js.arrays()
    ts = Simulation(SimConfig(backend="jnp", G=3e-4), pm, vel, acc, step=js.step_count, device="cpu",
                    camera_target=js.camera_target)
    ts.dt, ts.G = 2e-4, 5e-4
    return js, ts


def orbax_tree(path) -> dict:
    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(str(path)))


def dir_tree(path) -> dict:
    """The keys of a port directory as numpy arrays and strings."""
    raw = checkpoint._read_dir(str(path), checkpoint._DIR_KEYS)
    return {k: (bytes(v.numpy()).decode() if k in STRINGS else v.numpy()) for k, v in raw.items()}


def assert_same_sim(a, b):
    for x, y in zip(a.arrays(), b.arrays()):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    assert a.step_count == b.step_count and a.n_real == b.n_real
    np.testing.assert_array_equal(a.camera_target, b.camera_target)
    assert a.dt == b.dt and a.G == b.G


def test_directory_holds_what_orbax_holds(sims, tmp_path):
    """The same state saved by both packages: the port's directory holds
    orbax's keys, its arrays and step bit for bit and its JSON strings
    byte for byte; each package's load gives the same Simulation."""
    js, ts = sims
    js.save(str(tmp_path / "j"))
    ts.save(str(tmp_path / "t"))
    j, t = orbax_tree(tmp_path / "j"), dir_tree(tmp_path / "t")
    assert sorted(t) == sorted(j)
    for k in ("pos_mass", "vel", "accel"):
        assert t[k].dtype == np.float32 and t[k].shape == (N, 4)
        np.testing.assert_array_equal(t[k].view(np.uint32), np.asarray(j[k]).view(np.uint32))
    assert t["step"].dtype == np.int64 and t["step"].shape == () and int(t["step"]) == int(j["step"]) == 2
    for k in STRINGS:
        assert t[k] == str(j[k])
    back, jback = Simulation.load(str(tmp_path / "t"), device="cpu"), JaxSimulation.load(str(tmp_path / "j"))
    assert_same_sim(back, ts)
    assert_same_sim(back, jback)
    assert back.config.to_json() == jback.config.to_json() == ts.config.replace(dt=2e-4, G=5e-4).to_json()
    assert back.loaded_camera.to_dict() == jback.loaded_camera.to_dict() == Camera(target=ts.camera_target).to_dict()


def test_peek_config_reads_the_config_alone(sims, tmp_path, monkeypatch):
    """``peek_config`` of the port's directory is the config the JAX
    package restores from its orbax directory, and it asks DCP for
    ``config_json`` alone.  (The JAX ``peek_config``'s partial restore
    raises under orbax 0.11 -- "If providing `transforms`, must provide
    `restore_args`" -- so the JAX side is its full restore, ``load_orbax``
    with ``config=None``, which takes the saved config.)"""
    js, ts = sims
    js.save(str(tmp_path / "j"))
    ts.save(str(tmp_path / "t"))
    asked, load = [], dcp.load
    monkeypatch.setattr(dcp, "load", lambda state, **kw: (asked.append(sorted(state)), load(state, **kw))[1])
    got = checkpoint.peek_config(str(tmp_path / "t"))
    assert asked == [["config_json"]]
    assert got.to_json() == JaxSimulation.load(str(tmp_path / "j")).config.to_json()
    assert (got.dt, got.G) == (2e-4, 5e-4)


def test_failed_save_leaves_the_old_checkpoint(sims, tmp_path, monkeypatch):
    """A save that fails after DCP wrote the arrays (before its metadata)
    leaves the earlier checkpoint loadable and no temporary directory; a
    save that completes replaces it; a directory that is no checkpoint is
    not replaced."""
    _, ts = sims
    path = tmp_path / "ckpt"
    ts.save(str(path))
    other = Simulation(SimConfig(backend="jnp"), *(2 * a for a in ts.arrays()), step=7, device="cpu")

    def fail(self, *a, **kw):
        assert any(name.endswith(".distcp") for name in os.listdir(self.path))  # the arrays are written
        raise OSError("disk full")

    with monkeypatch.context() as m:
        m.setattr(dcp.FileSystemWriter, "finish", fail)
        with pytest.raises(CheckpointException, match="disk full"):  # DCP's wrapper of the OSError
            other.save(str(path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert_same_sim(Simulation.load(str(path), device="cpu"), ts)

    other.save(str(path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    back = Simulation.load(str(path), device="cpu")
    assert back.step_count == 7
    np.testing.assert_array_equal(back.arrays()[0], 2 * ts.arrays()[0])

    keep = tmp_path / "notes"
    keep.mkdir()
    (keep / "a.txt").write_text("mine")
    (tmp_path / "file").write_text("mine")
    for target in (keep, tmp_path / "file"):
        with pytest.raises(ValueError, match=str(target)):
            ts.save(str(target))
    assert (keep / "a.txt").read_text() == "mine" and (tmp_path / "file").read_text() == "mine"
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "file", "notes"]


def test_orbax_directory_and_broken_paths_raise(sims, tmp_path):
    """The JAX package's orbax directory (told to go through ``.npz``), a
    missing path, a file with neither suffix and a directory without DCP's
    metadata: each a ``ValueError`` naming the path, from ``load`` and
    ``peek_config``."""
    js, _ = sims
    js.save(str(tmp_path / "orbax"))
    (tmp_path / "plain").write_text("x")
    (tmp_path / "empty").mkdir()
    cases = {"orbax": "orbax directory.*convert it to '.npz'", "missing": "not a checkpoint directory",
             "plain": "not a checkpoint directory", "empty": "without DCP's '.metadata'"}
    for name, what in cases.items():
        p = str(tmp_path / name)
        for fn in (lambda: Simulation.load(p, device="cpu"), lambda: checkpoint.peek_config(p)):
            with pytest.raises(ValueError, match=what) as err:
                fn()
            assert p in str(err.value)


class _Calls:
    """Unpickles to a call of ``os.makedirs(marker)``."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.makedirs, (self.marker,)


def _rewrite_metadata(path, how, marker):
    """Replace the ``.metadata`` of the checkpoint directory ``path`` by a
    crafted one."""
    from torch.distributed.checkpoint.metadata import BytesStorageMetadata

    meta_path = path / ".metadata"
    with open(meta_path, "rb") as f:
        md = pickle.load(f)
    if how == "calls":
        raw = pickle.dumps(_Calls(str(marker)))
    elif how == "not_metadata":
        raw = pickle.dumps({"pos_mass": [1.0]})
    elif how == "bytes_entry":  # DCP would torch.load its value with weights_only=False
        md.state_dict_metadata["config_json"] = BytesStorageMetadata()
        raw = pickle.dumps(md)
    elif how == "outside_file":
        md.storage_data = {k: dataclasses.replace(v, relative_path="../" + v.relative_path)
                           for k, v in md.storage_data.items()}
        raw = pickle.dumps(md)
    else:  # truncated
        raw = meta_path.read_bytes()[:40]
    meta_path.write_bytes(raw)


@pytest.mark.parametrize("how", ["calls", "not_metadata", "bytes_entry", "outside_file", "truncated"])
def test_crafted_metadata_raises(sims, tmp_path, how):
    """DCP's ``.metadata`` is a pickle: a crafted one that would call a
    function, that is no DCP metadata, that holds a value DCP reads with an
    unrestricted ``torch.load``, that points outside the directory or that
    is cut short raises a ``ValueError`` naming the path, from ``load`` and
    ``peek_config``, and runs nothing."""
    _, ts = sims
    path = tmp_path / "ckpt"
    ts.save(str(path))
    marker = tmp_path / "ran"
    _rewrite_metadata(path, how, marker)
    for fn in (lambda: Simulation.load(str(path), device="cpu"), lambda: checkpoint.peek_config(str(path))):
        with pytest.raises(ValueError, match="'.metadata'") as err:
            fn()
        assert str(path) in str(err.value)
    assert not marker.exists()


def test_wrong_dtype_raises(tmp_path):
    """A DCP directory whose keys have other dtypes or ranks than the
    checkpoint's raises a ``ValueError`` naming the path and the key."""
    path = tmp_path / "ckpt"
    state = {"pos_mass": torch.zeros(4, 4, dtype=torch.float64), "vel": torch.zeros(4, 4),
             "accel": torch.zeros(4, 4), "step": torch.tensor(0), "config_json": checkpoint._text("{}"),
             "camera_json": checkpoint._text("{}")}
    with checkpoint._one_process():
        dcp.save(state, checkpoint_id=str(path), no_dist=True)
    with pytest.raises(ValueError, match="pos_mass is torch.float64") as err:
        Simulation.load(str(path), device="cpu")
    assert str(path) in str(err.value)


def _renames_into(monkeypatch, path, fail_after=0):
    """Make ``os.rename`` onto ``path`` raise after ``fail_after`` such
    renames (DCP's own renames inside the temporary go through)."""
    real, seen = os.rename, []

    def rename(src, dst, *a, **kw):
        if os.fspath(dst) == str(path):
            seen.append(src)
            if len(seen) > fail_after:
                raise OSError("rename into place refused")
        return real(src, dst, *a, **kw)

    monkeypatch.setattr(os, "rename", rename)


def test_replace_is_one_exchange(sims, tmp_path, monkeypatch):
    """Replacing a checkpoint swaps the new directory and the old in one
    ``renameat2`` exchange: no rename onto the path is made, so no moment
    leaves the path without a checkpoint."""
    _, ts = sims
    path = tmp_path / "ckpt"
    ts.save(str(path))
    other = Simulation(SimConfig(backend="jnp"), *(2 * a for a in ts.arrays()), step=7, device="cpu")
    with monkeypatch.context() as m:
        _renames_into(m, path)
        other.save(str(path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    assert Simulation.load(str(path), device="cpu").step_count == 7


def test_interrupted_replace_keeps_the_old_checkpoint(sims, tmp_path, monkeypatch):
    """Without the exchange the replace is two renames.  If the second, and
    the rename back, fail, the old checkpoint is kept under a hidden
    sibling, and loading the path names it."""
    _, ts = sims
    path = tmp_path / "ckpt"
    ts.save(str(path))
    other = Simulation(SimConfig(backend="jnp"), *(2 * a for a in ts.arrays()), step=7, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(checkpoint, "_exchange", lambda a, b: False)
        _renames_into(m, path)
        with pytest.raises(OSError, match="refused"):
            other.save(str(path))
    with pytest.raises(ValueError, match="an interrupted save left the earlier checkpoint at") as err:
        Simulation.load(str(path), device="cpu")
    left = err.value.args[0].rsplit(" at ", 1)[1].strip("'")
    assert os.path.dirname(os.path.dirname(left)) == str(tmp_path) and os.path.basename(left) == "ckpt"
    assert_same_sim(Simulation.load(left, device="cpu"), ts)
    with monkeypatch.context() as m:
        m.setattr(checkpoint, "_exchange", lambda a, b: False)
        other.save(str(path))  # the path is free: a plain rename
    assert Simulation.load(str(path), device="cpu").step_count == 7


def test_npz_bridge_both_ways(sims, tmp_path):
    """JAX orbax -> (the JAX package's load and save) .npz -> (port
    convert) port directory -> (port convert) .npz -> JAX load: the JAX
    state bit for bit, its config, step and camera.  The JAX side is its
    ``convert``'s two calls: its CLI first peeks at the config, which
    raises under orbax 0.11 (``test_peek_config_reads_the_config_alone``);
    its ``convert`` of an ``.npz`` runs, and closes the loop."""
    js, _ = sims
    js.save(str(tmp_path / "orbax"))
    JaxSimulation.load(str(tmp_path / "orbax")).save(str(tmp_path / "a.npz"))
    assert cli.main(["convert", str(tmp_path / "a.npz"), str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert cli.main(["convert", str(tmp_path / "port"), str(tmp_path / "b.npz"), "--device", "cpu"]) == 0
    back = JaxSimulation.load(str(tmp_path / "b.npz"))
    assert_same_sim(back, js)
    assert back.config.to_json() == js.config.replace(dt=js.dt, G=js.G).to_json()
    assert back.loaded_camera.to_dict() == Camera(target=js.camera_target).to_dict()
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert jax_cli.main(["convert", str(tmp_path / "b.npz"), str(tmp_path / "c.json"), "--platform", "cpu"]) == 0
    assert_same_sim(Simulation.load(str(tmp_path / "c.json"), device="cpu"), JaxSimulation.load(str(tmp_path / "c.json")))


def test_cli_resume_and_read_a_directory(tmp_path, capsys):
    """``run --checkpoint DIR`` keeps the directory's config except for the
    flags given (as ``test_torch_checkpoint.py::test_cli_resume_semantics``
    for ``.npz``); ``render``, ``analyze`` and ``animate`` of a directory
    give what they give for the same state's ``.npz``."""
    first = tmp_path / "a"
    assert cli.main(["run", "--device", "cpu", "--preset", "uniform-sphere", "--n", "128", "--steps", "2",
                     "--log-every", "2", "--outdir", str(first), "--dt", "2e-4", "--G", "3e-4",
                     "--integrator", "euler", "--seed", "5"]) == 0
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["convert", str(first / "final.npz"), ckpt, "--device", "cpu"]) == 0
    second = tmp_path / "b"
    assert cli.main(["run", "--device", "cpu", "--checkpoint", ckpt, "--steps", "2", "--log-every", "2",
                     "--outdir", str(second), "--log-G", "-3"]) == 0
    cfg = checkpoint.peek_config(str(second / "final.npz"))
    assert (cfg.dt, cfg.G, cfg.integrator, cfg.seed) == (2e-4, 1e-3, "euler", 5)
    with np.load(second / "final.npz") as z:
        assert int(z["step"]) == 4
    third = tmp_path / "c"
    assert cli.main(["run", "--device", "cpu", "--checkpoint", str(first / "final.npz"), "--steps", "2",
                     "--log-every", "2", "--outdir", str(third), "--log-G", "-3"]) == 0
    with np.load(second / "final.npz") as a, np.load(third / "final.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    size = ["--width", "64", "--height", "48", "--device", "cpu"]
    for src, png in ((ckpt, "d.png"), (str(first / "final.npz"), "n.png")):
        assert cli.main(["render", src, "-o", str(tmp_path / png), *size]) == 0
    np.testing.assert_array_equal(read_png(str(tmp_path / "d.png")), read_png(str(tmp_path / "n.png")))
    capsys.readouterr()
    reports = []
    for src in (ckpt, str(first / "final.npz")):
        assert cli.main(["analyze", src, "--bins", "4", "--json", "--device", "cpu"]) == 0
        reports.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert reports[0] == reports[1]
    assert cli.main(["animate", ckpt, "--frames", "2", "--outdir", str(tmp_path / "anim"), *size]) == 0
    assert sorted(os.listdir(tmp_path / "anim")) == ["frame_000000.png", "frame_000001.png"]


def test_two_rank_mesh_saves_one_directory(tmp_path):
    """2 gloo ranks: a sharded run saves one directory (rank 0 writes the
    gathered state); it loads into the 2-rank mesh (each rank keeps its
    rows) and into one device with the same arrays, step and config."""
    path = str(tmp_path / "mesh_ckpt")
    case = dict(kind="checkpoint_dir", config=dict(backend="jnp", strategy="ring"), n=300, seed=3, steps=2,
                path=path)
    outs = [r[0] for r in spawn(rank_checks.run_cases, 2, [case], device="cpu", timeout=240)]
    one = Simulation.load(path, device="cpu")
    assert one.step_count == 2 and one.config.strategy == "ring" and one.n_real == 300
    for x, y, z in zip(outs[0]["arrays"], outs[0]["loaded"], one.arrays()):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
        np.testing.assert_array_equal(x.view(np.uint32), z.view(np.uint32))
    full = np.concatenate([o["shard"] for o in outs])
    assert outs[0]["shard"].shape == outs[1]["shard"].shape
    np.testing.assert_array_equal(full[:300], one.arrays()[0])
    assert not full[300:].any()
