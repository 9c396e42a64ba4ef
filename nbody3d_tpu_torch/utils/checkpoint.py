"""Checkpoint / resume: reference-schema JSON, native ``.npz`` and a
checkpoint directory.

The port's counterpart of ``nbody3d_tpu/utils/checkpoint.py``; the JSON and
npz files written by either package load in the other, bit for bit.

- **Reference-schema JSON**, the WebGPU app's export/import
  (``util.js:160-263``): flat float lists ``bodies``/``vel``/``accel``
  (the lagged Verlet makes accel part of the state), an 8-field ``camera``
  dict, and ``G`` as the log10 slider value with 2 decimals
  (``util.js:200``).  The extra keys ``dt``, ``step`` and ``nBodies`` are
  written too, and ``nBodies`` is checked on load.  The three arrays are
  written and read by the C codec ``native/_fastjson.c`` (``%.9g``, which
  gives every float32 back exactly, and ``strtod``), the other keys by
  Python's ``json``: the file is the JAX package's, byte for byte.
- **Native .npz**: the arrays, the step, the full config and the camera.
- **A directory** (any path with neither suffix): the keys of the JAX
  package's orbax checkpoint (``save_orbax``), written by
  ``torch.distributed.checkpoint`` (DCP).  It plays orbax's part: the
  directory is written whole into a temporary sibling and renamed into
  place (an atomic exchange where the kernel has ``renameat2``), so a
  failed save leaves the old checkpoint as it was, and its config is read
  without the arrays (:func:`peek_config`).  Every value is a tensor (the
  JSON strings as ``uint8``, the step a 0-d int64), which DCP reads back
  with ``torch.load(weights_only=True)``.  DCP's own ``.metadata`` file is
  a pickle: it is read by an unpickler that admits only DCP's metadata
  classes, ``torch.Size``, dtypes, layouts and paths, so loading a
  directory made by someone else runs no code of theirs.  The port cannot import orbax,
  so neither package reads the other's directories: the ``.npz`` file is
  the bridge (load a directory and save it as ``.npz`` in one package,
  ``convert`` the ``.npz`` to a directory in the other).
"""

from __future__ import annotations

import contextlib
import ctypes
import errno
import glob
import json
import math
import os
import pickle
import shutil
import sys
import tempfile
import warnings
from collections.abc import Iterable

import numpy as np
import torch

from nbody3d_tpu_torch import native
from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.utils.camera import Camera

_ARRAYS = ("bodies", "vel", "accel")


def check_format(path: str) -> str:
    """``"json"`` or ``"npz"`` from the suffix, ``"dir"`` for any other
    path (as the JAX engine takes it for an orbax directory)."""
    p = str(path)
    if p.endswith(".json"):
        return "json"
    if p.endswith(".npz"):
        return "npz"
    return "dir"


# ------------------------------------------------------------ reference JSON
def save_reference_json(path: str, sim) -> None:
    """Write the reference-schema file of ``sim``: the JAX package's
    ``save_reference_json`` bytes for the same state."""
    pos_mass, vel, accel = sim.arrays()
    if not sim.G > 0:
        raise ValueError(
            f"reference-JSON export stores G as its log10 slider value "
            f"(util.js:200) and quantizes it to 2 decimals, which requires "
            f"G > 0 (got {sim.G!r}); use the lossless .npz format instead"
        )
    meta = {
        "camera": Camera(target=sim.camera_target).to_dict(),
        "G": f"{math.log10(sim.G):.2f}",  # util.js:200 slider-value string
        # Additive fixes for reference gaps (ignored by the WebGPU app):
        "dt": sim.dt,
        "step": sim.step_count,
        "nBodies": sim.n_real,
    }
    arrays = (pos_mass, vel, accel)
    if not all(np.isfinite(a).all() for a in arrays):
        # NaN and inf have json.dump's spellings, as in the JAX package.
        data = {k: [float(v) for v in a.reshape(-1)] for k, a in zip(_ARRAYS, arrays)}
        with open(path, "w") as f:
            json.dump({**data, **meta}, f)
        return
    chunks = [native.dumps_f32(a) for a in arrays]
    with open(path, "wb") as f:
        for i, (k, chunk) in enumerate(zip(_ARRAYS, chunks)):
            f.write((b"{" if i == 0 else b", ") + json.dumps(k).encode() + b": " + chunk)
        for k, v in meta.items():
            f.write(b", " + json.dumps(k).encode() + b": " + json.dumps(v).encode())
        f.write(b"}")


def _parse(raw: bytes) -> tuple[dict, dict]:
    """The three arrays (float32) and the other keys of a reference-schema
    document.  Each array is scanned in place by ``native/_fastjson.c`` and
    the rest, the arrays cut out, parsed by ``json.loads``.  A document the
    scanner rejects is parsed whole by ``json.loads``, as the JAX package
    does (``_parse_fast``); a malformed one raises there."""
    arrays, spans = {}, []
    for key in _ARRAYS:
        kpos = raw.find(b'"%s"' % key.encode())
        start = raw.find(b"[", kpos) if kpos >= 0 else -1
        got = native.scan_f32(raw, start) if start >= 0 else None
        if got is None:
            break
        arrays[key] = got[0]
        spans.append((start, got[1]))
    else:
        spans.sort()
        parts, prev = [], 0
        for s, e in spans:
            parts.append(raw[prev:s] + b"[]")
            prev = e
        parts.append(raw[prev:])
        try:
            return arrays, json.loads(b"".join(parts))
        except ValueError:
            pass
    data = json.loads(raw)
    return {k: np.asarray(data[k], dtype=np.float32) for k in _ARRAYS}, data


def load_reference_json(path: str, config: SimConfig | None = None, *, device=None, mesh=None):
    """A Simulation from a reference-schema file; its G and dt, where it
    has them, replace ``config``'s.  With a mesh every rank reads the file
    and keeps its rows."""
    from nbody3d_tpu_torch.engine import Simulation

    with open(path, "rb") as f:
        arrays, data = _parse(f.read())
    bodies, vel, accel = (arrays[k].reshape(-1, 4) for k in _ARRAYS)
    n = bodies.shape[0]
    if vel.shape[0] != n or accel.shape[0] != n:
        raise ValueError(
            f"checkpoint arrays disagree on N: bodies={n}, vel={vel.shape[0]}, "
            f"accel={accel.shape[0]}"
        )
    declared = data.get("nBodies")
    if declared is not None and int(declared) != n:
        raise ValueError(f"checkpoint declares nBodies={declared} but has {n} bodies")
    G = 10.0 ** float(data["G"]) if "G" in data else None  # util.js:261
    camera = Camera.from_dict(data["camera"]) if "camera" in data else None
    dt = float(data["dt"]) if "dt" in data else None
    step = int(data.get("step", 0))
    config = config or SimConfig()
    if G is not None:
        config = config.replace(G=G)
    if dt is not None:
        config = config.replace(dt=dt)
    sim = Simulation(
        config, bodies, vel, accel, step=step, device=device,
        camera_target=camera.target if camera is not None else None, mesh=mesh,
    )
    sim.loaded_camera = camera
    return sim


# ------------------------------------------------------------------ native npz
def save_npz(path: str, sim) -> None:
    pos_mass, vel, accel = sim.arrays()
    config = sim.config.replace(dt=sim.dt, G=sim.G)
    np.savez_compressed(
        path,
        pos_mass=pos_mass,
        vel=vel,
        accel=accel,
        step=np.int64(sim.step_count),
        config_json=np.bytes_(config.to_json().encode()),
        camera_json=np.bytes_(json.dumps(Camera(target=sim.camera_target).to_dict()).encode()),
    )


def load_npz(path: str, config: SimConfig | None = None, *, device=None, mesh=None):
    """A Simulation from a native file; ``config=None`` takes the saved one.
    With a mesh every rank reads the file and keeps its rows."""
    from nbody3d_tpu_torch.engine import Simulation

    with np.load(path) as z:
        pos_mass, vel, accel, step = z["pos_mass"], z["vel"], z["accel"], int(z["step"])
        saved_config = SimConfig.from_json(bytes(z["config_json"]).decode())
        camera = Camera.from_dict(json.loads(bytes(z["camera_json"]).decode()))
    config = saved_config if config is None else config
    sim = Simulation(
        config, pos_mass, vel, accel, step=step, device=device, camera_target=camera.target, mesh=mesh,
    )
    sim.dt = config.dt
    sim.G = config.G
    sim.loaded_camera = camera
    return sim


# ------------------------------------------------------------------ directory
# each key's dtype and number of dimensions
_DIR_KEYS = {
    "pos_mass": (torch.float32, 2),
    "vel": (torch.float32, 2),
    "accel": (torch.float32, 2),
    "step": (torch.int64, 0),
    "config_json": (torch.uint8, 1),
    "camera_json": (torch.uint8, 1),
}

_PATHS = {"PosixPath", "PurePosixPath", "WindowsPath", "PureWindowsPath"}
# the globals a ``.metadata`` written by ``dcp.save`` of tensors refers to
_METADATA_GLOBALS = {
    "torch.distributed.checkpoint.metadata": {
        "Metadata", "MetadataIndex", "StorageMeta", "TensorProperties",
        "TensorStorageMetadata", "ChunkStorageMetadata", "_MEM_FORMAT_ENCODING",
    },
    "torch.distributed.checkpoint.filesystem": {"_StorageInfo"},
    "torch.serialization": {"_get_layout"},
    "torch": {"Size"},
    "pathlib": _PATHS,
    "pathlib._local": _PATHS,
}


class _MetadataUnpickler(pickle.Unpickler):
    """Unpickles DCP's ``.metadata`` and refuses every other global, so a
    crafted file can call nothing (``BytesStorageMetadata``, whose values
    DCP reads with an unrestricted ``torch.load``, is refused too)."""

    def find_class(self, module: str, name: str):
        if name in _METADATA_GLOBALS.get(module, ()) or (
            module == "torch" and isinstance(getattr(torch, name, None), torch.dtype)
        ):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not part of DCP's tensor metadata")


def _text(s: str) -> torch.Tensor:
    """A string as a ``uint8`` tensor of its UTF-8 bytes."""
    return torch.frombuffer(bytearray(s.encode()), dtype=torch.uint8)


def _untext(t: torch.Tensor) -> str:
    return bytes(t.numpy()).decode()


@contextlib.contextmanager
def _one_process():
    """DCP warns on every ``no_dist`` call that it assumes one process:
    that is the intent here (one rank writes, each rank reads alone)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled", category=UserWarning)
        yield


def _is_checkpoint_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, ".metadata"))


_AT_FDCWD, _RENAME_EXCHANGE = -100, 2


def _exchange(a: str, b: str) -> bool:
    """Swap the paths ``a`` and ``b`` in one step (Linux ``renameat2`` with
    ``RENAME_EXCHANGE``); False where the C library or the file system
    lacks it."""
    if not sys.platform.startswith("linux"):
        return False
    fn = getattr(ctypes.CDLL(None, use_errno=True), "renameat2", None)
    if fn is None:
        return False
    fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_uint]
    if fn(_AT_FDCWD, os.fsencode(a), _AT_FDCWD, os.fsencode(b), _RENAME_EXCHANGE) == 0:
        return True
    err = ctypes.get_errno()
    if err in (errno.ENOSYS, errno.EINVAL, errno.EOPNOTSUPP):
        return False
    raise OSError(err, os.strerror(err), b)


def save_dir(path: str, sim) -> None:
    """Write ``sim`` as a checkpoint directory: the keys and JSON strings of
    the JAX package's ``save_orbax``, through ``dcp.save(no_dist=True)``
    (no collective, so rank 0 of a mesh writes alone) into a temporary
    sibling that replaces ``path`` once it is complete, by an atomic
    exchange where the system has one.  An existing checkpoint directory
    (or an empty one) at ``path`` is replaced; anything else there raises."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(str(path))
    if os.path.lexists(path) and not (
        os.path.isdir(path) and not os.path.islink(path) and (_is_checkpoint_dir(path) or not os.listdir(path))
    ):
        raise ValueError(f"checkpoint {path!r}: exists and is not a checkpoint directory; not replaced")
    pos_mass, vel, accel = sim.arrays()
    config = sim.config.replace(dt=sim.dt, G=sim.G)
    state = {
        "pos_mass": torch.from_numpy(pos_mass),
        "vel": torch.from_numpy(vel),
        "accel": torch.from_numpy(accel),
        "step": torch.tensor(sim.step_count, dtype=torch.int64),
        "config_json": _text(config.to_json()),
        "camera_json": _text(json.dumps(Camera(target=sim.camera_target).to_dict())),
    }
    parent, name = os.path.split(path)
    tmp = tempfile.mkdtemp(prefix=f".{name}.", suffix=".partial", dir=parent)
    old = None
    try:
        with _one_process():
            dcp.save(state, checkpoint_id=tmp, no_dist=True)
        if not os.path.lexists(path):
            os.rename(tmp, path)
        elif not _exchange(tmp, path):  # else tmp now holds the old one
            # two renames: an interrupted save leaves the old checkpoint
            # under ``.NAME.*.old/ckpt``, which loading ``path`` names
            old = tempfile.mkdtemp(prefix=f".{name}.", suffix=".old", dir=parent)
            os.rename(path, os.path.join(old, "ckpt"))
            try:
                os.rename(tmp, path)
            except BaseException:
                os.rename(os.path.join(old, "ckpt"), path)
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if old is not None and os.path.lexists(path):  # else it holds the only checkpoint
            shutil.rmtree(old, ignore_errors=True)


def _read_metadata(path: str):
    """DCP's metadata of the checkpoint directory ``path``, unpickled by
    :class:`_MetadataUnpickler` and checked to hold tensors only, each
    stored in a file of the directory."""
    from torch.distributed.checkpoint.filesystem import _StorageInfo
    from torch.distributed.checkpoint.metadata import Metadata, StorageMeta, TensorStorageMetadata

    try:
        with open(os.path.join(path, ".metadata"), "rb") as f:
            md = _MetadataUnpickler(f).load()
    except Exception as e:  # pickle raises many kinds on a malformed file
        raise ValueError(f"checkpoint {path!r}: its '.metadata' is not DCP's metadata of tensors: {e}") from e
    if not (
        isinstance(md, Metadata)
        and isinstance(md.state_dict_metadata, dict)
        and all(isinstance(v, TensorStorageMetadata) for v in md.state_dict_metadata.values())
        and isinstance(md.storage_data, dict)
        and all(
            isinstance(v, _StorageInfo) and os.path.basename(str(v.relative_path)) == v.relative_path
            for v in md.storage_data.values()
        )
    ):
        raise ValueError(f"checkpoint {path!r}: its '.metadata' is not DCP's metadata of tensors in the directory")
    if getattr(md, "storage_meta", None) is None:
        md.storage_meta = StorageMeta()
    return md


def _read_dir(path: str, keys: Iterable[str]) -> dict[str, torch.Tensor]:
    """``keys`` of a checkpoint directory, each read alone into a CPU tensor
    of the shape and dtype DCP's metadata gives."""
    import torch.distributed.checkpoint as dcp

    p = str(path)
    if not os.path.isdir(p):
        parent, name = os.path.split(os.path.abspath(p))
        left = sorted(glob.glob(os.path.join(glob.escape(parent), glob.escape(f".{name}.") + "*.old", "ckpt")))
        hint = f"; an interrupted save left the earlier checkpoint at {left[-1]!r}" if left else ""
        raise ValueError(f"checkpoint {p!r}: neither '.json' nor '.npz', and not a checkpoint directory{hint}")
    if os.path.exists(os.path.join(p, "_CHECKPOINT_METADATA")):
        raise ValueError(
            f"checkpoint {p!r} is the JAX package's orbax directory, which the port cannot read: "
            "convert it to '.npz' with the JAX package: nbody3d_tpu.engine.Simulation.load(DIR).save('out.npz')"
        )
    if not _is_checkpoint_dir(p):
        raise ValueError(f"checkpoint {p!r}: a directory without DCP's '.metadata': not a checkpoint directory")
    md = _read_metadata(p)
    meta = md.state_dict_metadata
    missing = [k for k in keys if k not in meta]
    if missing:
        raise ValueError(f"checkpoint {p!r}: no {missing} in the directory")
    for k in keys:
        dtype, ndim = _DIR_KEYS[k]
        if meta[k].properties.dtype != dtype or len(meta[k].size) != ndim:
            raise ValueError(
                f"checkpoint {p!r}: {k} is {meta[k].properties.dtype} of shape {tuple(meta[k].size)}, "
                f"not {dtype} with {ndim} dimensions"
            )

    class Reader(dcp.FileSystemReader):
        def read_metadata(self, *args, **kwargs):
            md.storage_meta.load_id = getattr(self, "load_id", None)
            return md

    out = {k: torch.empty(meta[k].size, dtype=meta[k].properties.dtype) for k in keys}
    with _one_process():
        dcp.load(out, storage_reader=Reader(p), no_dist=True)
    return out


def load_dir(path: str, config: SimConfig | None = None, *, device=None, mesh=None):
    """A Simulation from a checkpoint directory; ``config=None`` takes the
    saved one.  With a mesh every rank reads the directory and keeps its
    rows."""
    from nbody3d_tpu_torch.engine import Simulation

    tree = _read_dir(path, _DIR_KEYS)
    saved_config = SimConfig.from_json(_untext(tree["config_json"]))
    camera = Camera.from_dict(json.loads(_untext(tree["camera_json"])))
    config = saved_config if config is None else config
    sim = Simulation(
        config, *(tree[k].numpy() for k in ("pos_mass", "vel", "accel")), step=int(tree["step"]),
        device=device, camera_target=camera.target, mesh=mesh,
    )
    sim.dt = config.dt
    sim.G = config.G
    sim.loaded_camera = camera
    return sim


def peek_config(path: str) -> SimConfig | None:
    """The saved :class:`SimConfig` of a checkpoint, or None for
    reference-JSON files (which carry no config beyond G/dt).  A directory's
    is read alone, without its arrays."""
    fmt = check_format(path)
    if fmt == "json":
        return None
    if fmt == "dir":
        return SimConfig.from_json(_untext(_read_dir(path, ("config_json",))["config_json"]))
    with np.load(str(path)) as z:
        return SimConfig.from_json(bytes(z["config_json"]).decode())
