"""The force VJP's two ordered-pair kernels and their variants on one card:
``vjp_sym_diag`` at the sym gradient's shape (uniform-sphere N = 262,144,
Morton order, tile 256) and the exact gradient's (two-galaxy n_pad 40,192,
nt = 157), ``vjp_full`` at the same two (S from ``exact_split``).

Each kernel is built alone with ``_build.NVCC_FLAGS`` in these forms: the
parent commit's (the first design), this tree's (``csrc/``), and this
tree's with one build-time knob set (``-D``, defaults in the ``.cu``): the
ordered loop at tile 256 in place of the Newton-3 one
(``NB_VJP_DIAG_N3=0``), the Newton-3 loop's unroll, ``vjp_full``'s unroll
and launch bound, and its tile loop with x̄ factored through row sums
(``NB_VJP_FULL_FACTORED``, ``studies/vjp_full_factored.cuh``).  The
guarded ``rsqrtf`` beside the ftz one is ``chip_smoke.py``'s
(``vjp_guarded_rsqrt``).  Each is timed in turns (the list, then the list
reversed; CUDA events), and ``vjp_full`` at every S at two-galaxy.
Outputs: the forms of the first design's order and arithmetic bit for bit
against the parent's (``vjp_full`` at S = 1), the others against the plain
twins (< 1e-5 of each column's scale) and against f64 on 256 rows with the
two-galaxy centres among them (median x̄ <= 1e-4), on random cotangents
and on a smooth one (A = x), the factored form also on
``pair_checks.vjp_heavy`` and grad_bench's gate.  Each form's pair loop is
counted in its SASS (``chip_smoke.pair_loops``).

    python3 studies/vjp_variants.py [PARENT_CHECKOUT]   # default _chipcheck/parent
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nbody3d_tpu_torch import _build, pair_checks  # noqa: E402
from nbody3d_tpu_torch.models.registry import make_preset  # noqa: E402
from nbody3d_tpu_torch.ops import force_vjp as fv  # noqa: E402
from nbody3d_tpu_torch.ops.launch import exact_split, sm_count  # noqa: E402
from nbody3d_tpu_torch.ops.morton import morton_reorder  # noqa: E402
from nbody3d_tpu_torch.state import init_state  # noqa: E402

ROOT = pathlib.Path("_chipcheck/studies/vjp")
SRC = pathlib.Path("nbody3d_tpu_torch/csrc")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
DIAG_SIG = [P, P, P, I, I, F, P]
FULL_SIG = [P, P, P, P, I, F, F, I, P]
PARENT_FULL_SIG = [P, P, P, P, I, F, F, P]
# Each form's -D flags.
DIAG = {
    "cur": (),
    "ordered": ("-DNB_VJP_DIAG_N3=0",),
    "n3_unroll6": ("-DNB_VJP_DIAG_N3_UNROLL=6",),
    "n3_unroll7": ("-DNB_VJP_DIAG_N3_UNROLL=7",),
}
FULL = {
    "cur": (),
    "unroll8": ("-DNB_VJP_FULL_UNROLL=8",),
    **{f"bound{k}": (f"-DNB_VJP_FULL_MIN_BLOCKS={k}",) for k in (5, 6)},
    "factored": ("-DNB_VJP_FULL_FACTORED", "-Istudies"),
}


def _compile(tag: str, src: pathlib.Path, defines=()) -> subprocess.Popen:
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(ROOT / f"{tag}.so"),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(parent: str) -> dict:
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    procs = {}
    for kind, variants, name in (("diag", DIAG, "vjp_sym_diag.cu"), ("full", FULL, "vjp_full.cu")):
        for tag, defines in variants.items():
            procs[f"{kind}_{tag}"] = _compile(f"{kind}_{tag}", SRC / name, defines)
        procs[f"{kind}_parent"] = _compile(f"{kind}_parent", pathlib.Path(parent) / SRC / name)
    libs = {}
    for t, p in procs.items():
        log = p.communicate()[0]
        regs = re.findall(r"Function properties for (\S+)[\s\S]*?Used (\d+) registers[^\n]*", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {t}: rc {p.returncode}, registers {[(n[-40:], r) for n, r in regs]}, spill stores {spills}",
              flush=True)
        if p.returncode:
            print(log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(ROOT / f"{t}.so"))
        if t.startswith("diag"):
            lib.nb_vjp_sym_diag.argtypes = DIAG_SIG
        else:
            lib.nb_vjp_full.argtypes = PARENT_FULL_SIG if t == "full_parent" else FULL_SIG
        libs[t] = lib
        for name, listing in cs.sass_listing(ROOT / f"{t}.so").items():
            for raw in cs.pair_loops(listing):
                ops = cs._op_counts(raw)
                n, pairs = sum(ops.values()), ops.get("MUFU", 0)
                fp32 = sum(ops.get(o, 0) for o in cs.FP32_OPS)
                print(f"  [sass] {t} {name[-48:]}: pair loop {n} instructions, {pairs} MUFU ({n / max(pairs, 1):.2f} "
                      f"a MUFU, FP32 {fp32 / max(pairs, 1):.2f}): "
                      + ", ".join(f"{o} {c}" for o, c in sorted(ops.items(), key=lambda kv: -kv[1])), flush=True)
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ok(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA error {rc} at launch")


def diag_call(lib, pm, abar, out, b: int, eps2: float):
    return lambda: _ok(lib.nb_vjp_sym_diag(pm.data_ptr(), abar.data_ptr(), out.data_ptr(), pm.shape[0] // b, b, eps2,
                                           _stream()))


def full_call(tag: str, lib, pm, abar, out, eps2: float, split: int):
    pm_bar, gbar = out
    args = [pm.data_ptr(), abar.data_ptr(), pm_bar.data_ptr(), gbar.data_ptr(), pm.shape[0], cs.G, eps2]
    if tag != "full_parent":
        args.append(split)
    return lambda: (gbar.zero_(), _ok(lib.nb_vjp_full(*args, _stream())))


def in_turns(label: str, calls: dict, reps: int) -> None:
    tags = list(calls)
    first = {t: cs.cuda_ms(calls[t], reps=reps) for t in tags}
    second = {t: cs.cuda_ms(calls[t], reps=reps) for t in reversed(tags)}
    for t in tags:
        print(f"  {label} {t:16s} {(first[t] + second[t]) / 2:.4f} ms (in turns {first[t]:.4f} / {second[t]:.4f})",
              flush=True)


def f64_gate(tag: str, pm, abar, pm_bar, rows) -> None:
    xbar_o, mbar_o, _ = cs._vjp_oracle_f64(pm.cpu().numpy(), abar.cpu().numpy(), rows)
    med, p99, med_m = cs._oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
    print(f"  {tag} vs f64 on {len(rows)} rows: x̄ median rel err {med:.3e} (p99 {p99:.3e}), m̄ median {med_m:.3e}: "
          f"{'passes' if med <= 1e-4 and med_m <= 1e-4 else 'FAILS'} the 1e-4 gate", flush=True)


def shapes(dev):
    n = 262144
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=cs.G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    sphere = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)[0]
    st, n_real = cs._two_galaxy(dev)
    galaxy = st.pos_mass
    return {
        f"sphere N={n}": (sphere, cs._cotangent(np.random.default_rng(5), n, n, dev), n),
        f"two-galaxy N={galaxy.shape[0]}": (galaxy, cs._cotangent(np.random.default_rng(8), galaxy.shape[0], n_real,
                                                                   dev), n_real),
    }


def diag_study(libs: dict, data: dict, b: int = 256) -> None:
    tags = [t for t in libs if t.startswith("diag")]
    for label, (pm, abar, n_real) in data.items():
        outs = {t: torch.empty((pm.shape[0], 8), dtype=torch.float32, device=pm.device) for t in tags}
        for eps2 in (cs.EPS2, 1e-40) if n_real == pm.shape[0] else (cs.EPS2,):
            for t in tags:
                diag_call(libs[t], pm, abar, outs[t], b, eps2)()
            torch.cuda.synchronize()
            twin = fv.vjp_sym_diag_plain(pm, abar, eps2, b)
            for t in tags:
                e = max(cs.rel_err(outs[t][:, c], twin[:, c]) for c in range(4))
                e_phi = abs(float(outs[t][:, 4].double().sum() - twin[:, 4].double().sum())) / float(
                    twin[:, 4].double().abs().sum())
                same = torch.equal(outs[t], outs["diag_parent"])
                print(f"  vjp_sym_diag {label} eps2 {eps2:g} {t}: bit-equal to the parent {same}, worst of x̄, m̄ "
                      f"max-abs/scale against the twin {e:.3e}, φ column sum {e_phi:.3e}", flush=True)
        in_turns(f"vjp_sym_diag {label}", {t: diag_call(libs[t], pm, abar, outs[t], b, cs.EPS2) for t in tags}, 20)
    pm, abar, n_real = data[next(k for k in data if k.startswith("two-galaxy"))]
    for label, a in (("random cotangent", abar), ("smooth cotangent A = x", _smooth(pm, n_real))):
        acc = torch.empty((pm.shape[0], 8), dtype=torch.float32, device=pm.device)
        diag_call(libs["diag_cur"], pm, a, acc, b, cs.EPS2)()
        pm_bar = fv.vjp_combine(acc, fv.vjp_sym_hops(pm, a, cs.EPS2, b), cs.G)[0]
        f64_gate(f"two-galaxy sym VJP with this tree's diagonal, {label}", pm, a, pm_bar, _rows(pm, n_real))
    pm_h, abar_h = (torch.from_numpy(a).to(pm.device) for a in pair_checks.vjp_heavy())
    got = torch.empty((pm_h.shape[0], 8), dtype=torch.float32, device=pm.device)
    diag_call(libs["diag_cur"], pm_h, abar_h, got, b, cs.EPS2)()
    twin = fv.vjp_sym_diag_plain(pm_h, abar_h, cs.EPS2, b)
    torch.cuda.synchronize()
    e = max(cs.rel_err(got[:, c], twin[:, c]) for c in range(5))
    print(f"  vjp_sym_diag (this tree's) on pair_checks.vjp_heavy: worst column against the twin {e:.3e}", flush=True)


def _smooth(pm, n_real: int):
    """A smooth cotangent, A_k = x_k (the gradient of sum |x|^2 / 2 through
    a step, roughly): neighbours' A nearly equal, so g = m_k A_j - m_j A_k
    cancels pair by pair."""
    a = torch.zeros_like(pm)
    a[:n_real, :3] = pm[:n_real, :3]
    return a


def _rows(pm, n_real: int) -> np.ndarray:
    heavy = torch.topk(pm[:, 3], 2).indices.cpu().numpy()
    rng = np.random.default_rng(9)
    return np.union1d(heavy, rng.choice(np.setdiff1d(np.arange(n_real), heavy), 254, replace=False))


def full_study(libs: dict, data: dict) -> None:
    tags = [t for t in libs if t.startswith("full")]
    for label, (pm, abar, n_real) in data.items():
        n = pm.shape[0]
        split = exact_split(n, n, sm_count(pm.device.index))
        outs = {t: (torch.empty_like(pm), torch.zeros(1, dtype=torch.float64, device=pm.device)) for t in tags}
        for t in tags:
            full_call(t, libs[t], pm, abar, outs[t], cs.EPS2, 1)()
        torch.cuda.synchronize()
        for t in tags:
            print(f"  vjp_full {label} S = 1 {t}: pm_bar bit-equal to the parent "
                  f"{torch.equal(outs[t][0], outs['full_parent'][0])}", flush=True)
        if n_real < n:  # two-galaxy: the twin and f64 with the centres among the rows
            twin = fv.vjp_full_plain(pm, cs.G, abar, cs.EPS2)
            for t in tags:
                full_call(t, libs[t], pm, abar, outs[t], cs.EPS2, split)()
                torch.cuda.synchronize()
                print(f"  vjp_full {label} S = {split} {t}: x̄, m̄, Ḡ against the twin "
                      + ", ".join(f"{e:.3e}" for e in cs._parts_err(outs[t], twin)), flush=True)
            smooth = _smooth(pm, n_real)
            twin_s = fv.vjp_full_plain(pm, cs.G, smooth, cs.EPS2)
            for t in ("full_cur", "full_factored"):
                f64_gate(f"vjp_full {label} {t}", pm, abar, outs[t][0], _rows(pm, n_real))
                out = (torch.empty_like(pm), torch.zeros(1, dtype=torch.float64, device=pm.device))
                full_call(t, libs[t], pm, smooth, out, cs.EPS2, split)()
                torch.cuda.synchronize()
                print(f"  vjp_full {label} {t}, smooth cotangent A = x: x̄, m̄, Ḡ against the twin "
                      + ", ".join(f"{e:.3e}" for e in cs._parts_err(out, twin_s)), flush=True)
                f64_gate(f"vjp_full {label} {t}, smooth cotangent A = x", pm, smooth, out[0], _rows(pm, n_real))
            sweep = {s_: cs.cuda_ms(full_call("full_cur", libs["full_cur"], pm, abar, outs["full_cur"], cs.EPS2, s_),
                                    reps=5) for s_ in range(1, 9)}
            print(f"  vjp_full {label} this tree's by S (exact_split gives {split}): "
                  + ", ".join(f"S={k} {v:.4f} ms" for k, v in sweep.items()), flush=True)
        in_turns(f"vjp_full {label} S = {split}",
                 {t: full_call(t, libs[t], pm, abar, outs[t], cs.EPS2, split) for t in tags}, 5 if n < 100000 else 2)
    if "full_factored" in libs:
        dev = next(iter(data.values()))[0].device
        pm_h, abar_h = (torch.from_numpy(a).to(dev) for a in pair_checks.vjp_heavy())
        out = (torch.empty_like(pm_h), torch.zeros(1, dtype=torch.float64, device=dev))
        full_call("full_factored", libs["full_factored"], pm_h, abar_h, out, cs.EPS2, 1)()
        twin = fv.vjp_full_plain(pm_h, cs.G, abar_h, cs.EPS2)
        torch.cuda.synchronize()
        print("  vjp_full factored on pair_checks.vjp_heavy: x̄, m̄, Ḡ against the twin "
              + ", ".join(f"{e:.3e}" for e in cs._parts_err(out, twin)), flush=True)
        f64_gate("vjp_full factored on pair_checks.vjp_heavy", pm_h, abar_h, out[0],
                 np.arange(int((pm_h[:, 3] != 0).sum())))
        n = 4096
        pm_np, _, _ = make_preset("uniform-sphere", seed=0, G=cs.G, n=n)
        pm_u = torch.from_numpy(np.asarray(pm_np, np.float32)).to(dev)
        abar_u = cs._cotangent(np.random.default_rng(3), n, n, dev)
        out = (torch.empty_like(pm_u), torch.zeros(1, dtype=torch.float64, device=dev))
        full_call("full_factored", libs["full_factored"], pm_u, abar_u, out, cs.EPS2, exact_split(n, n))()
        f64_gate(f"vjp_full factored, grad_bench's gate (uniform-sphere N={n})", pm_u, abar_u, out[0], np.arange(n))
        full_call("full_factored", libs["full_factored"], pm_u, _smooth(pm_u, n), out, cs.EPS2, exact_split(n, n))()
        f64_gate(f"vjp_full factored, uniform-sphere N={n}, smooth cotangent A = x", pm_u, _smooth(pm_u, n), out[0],
                 np.arange(n))


def main():
    parent = sys.argv[1] if len(sys.argv) > 1 else "_chipcheck/parent"
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    libs = build(parent)
    dev = torch.device("cuda", 0)
    data = shapes(dev)
    diag_study(libs, data)
    full_study(libs, data)
    print(cs.nvidia_smi("name,power.limit,clocks.sm,power.draw"), flush=True)


if __name__ == "__main__":
    main()
