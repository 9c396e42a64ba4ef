"""Checkpoint / resume: reference-schema JSON and native ``.npz``.

The port's counterpart of ``nbody3d_tpu/utils/checkpoint.py``; files
written by either package load in the other, bit for bit.

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

The JAX package's third format, an orbax directory, is JAX-only and not
ported: a path with neither suffix raises.
"""

from __future__ import annotations

import json
import math

import numpy as np

from nbody3d_tpu_torch import native
from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.utils.camera import Camera

FORMATS = "'.json' (reference schema) or '.npz' (native)"
_ARRAYS = ("bodies", "vel", "accel")


def check_format(path: str) -> str:
    """``"json"`` or ``"npz"`` from the suffix; raises for anything else."""
    p = str(path)
    if p.endswith(".json"):
        return "json"
    if p.endswith(".npz"):
        return "npz"
    raise ValueError(
        f"checkpoint {p!r}: the port reads and writes {FORMATS}; the JAX package's "
        "orbax directories (no suffix) are not supported"
    )


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


def peek_config(path: str) -> SimConfig | None:
    """The saved :class:`SimConfig` of a checkpoint, or None for
    reference-JSON files (which carry no config beyond G/dt)."""
    if check_format(path) == "json":
        return None
    with np.load(str(path)) as z:
        return SimConfig.from_json(bytes(z["config_json"]).decode())
