"""Empirical check of the DESIGN.md section-9 scaling model on the
8-virtual-device CPU mesh.

Two measurements, both CPU-only:

1. ``--timing``: per-iteration wall time of the flagship (nmf gram) and
   one convolutive solver (cnmf) at 1/2/4/8 virtual devices.  The
   virtual devices SHARE one host's cores, so this cannot show real
   speedup — what it validates is that sharded lowering adds no
   pathological overhead (time stays roughly flat as D grows while
   per-device shapes shrink) and that the programs execute real
   collectives.

2. ``--hlo [solver]``: runs one sharded solver step on a 2x4
   (feature x sample) mesh with ``--xla_dump_to`` and inventories the
   collective instructions XLA emitted (all-reduce, collective-permute,
   all-gather, reduce-scatter, all-to-all) across every compiled module
   of that run, to compare against the section-9 predictions:
   psum'd k x k Grams for the MU family, collective-permute halos for
   the convolutive shifts, all-gather/all-to-all-shaped traffic for the
   Gram-split family's one-time V'V.

``--all`` drives both and writes benchmarks/SCALING_cpu8.json.
Each --hlo run executes in a subprocess for clean per-solver dumps.
"""
import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "SCALING_cpu8.json"

SOLVERS = ["nmf", "nmf-weighted", "cnmf", "nmfsc", "cnmfsc", "cmfwisa",
           "chnmf", "chcnmf", "convexnmf", "lnmf", "seminmf",
           "constrainednmf", "nmf-multiseed",
           "nmf-encode", "cnmf-encode", "cmfwisa-encode", "nmf2d"]

COLLECTIVES = ("all-reduce", "collective-permute", "all-gather",
               "reduce-scatter", "all-to-all")


def _setup_cpu8():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def _run_solver(name, mesh):
    """One sharded solver step on the mesh — mirrors __graft_entry__."""
    import numpy as np
    import nmf_toolbox_tpu as nt
    rng = np.random.default_rng(0)
    m, n, k = 17, 67, 4
    V = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    Hn = (H0 / np.sqrt((H0**2).sum(1, keepdims=True))).astype(np.float32)
    kw = dict(maxiter=1, tolerance=1e-12, mesh=mesh)
    if name == "nmf":
        return nt.nmf(V, k, W_init=W0, H_init=H0, **kw)
    if name == "nmf-weighted":
        Mw = (rng.uniform(size=(m, n)) < 0.8).astype(np.float32)
        return nt.nmf(V, k, W_init=W0, H_init=H0, weights=Mw,
                      divergence="kl", **kw)
    if name == "cnmf":
        W0c = rng.uniform(0.1, 1.0, (m, k, 3)).astype(np.float32)
        return nt.cnmf(V, k, 3, W_init=W0c, H_init=H0, **kw)
    if name == "nmfsc":
        return nt.nmfsc(V, k, W_init=W0, H_init=Hn, H_sparsity=0.5, **kw)
    if name == "cnmfsc":
        W0c = rng.uniform(0.1, 1.0, (m, k, 3)).astype(np.float32)
        return nt.cnmfsc(V, k, 3, W_init=W0c, H_init=Hn, H_sparsity=0.5, **kw)
    if name == "cmfwisa":
        Vc = (V * np.exp(1j * rng.uniform(size=(m, n)))).astype(np.complex64)
        return nt.cmfwisa(Vc, k, W_init=W0, H_init=H0, **kw)
    if name == "chnmf":
        S = V[:, rng.choice(n, 7, replace=False)].copy()
        return nt.chnmf(V, k, S_init=S,
                        G_init=rng.uniform(size=(7, k)).astype(np.float32),
                        H_init=H0, **kw)
    if name == "chcnmf":
        S = V[:, rng.choice(n, 7, replace=False)].copy()
        return nt.chcnmf(V, k, 2, S_init=S,
                         G_init=rng.uniform(size=(7, k, 2)).astype(np.float32),
                         H_init=H0, **kw)
    if name == "convexnmf":
        return nt.convexnmf(V - 0.5, k,
                            G_init=rng.uniform(size=(n, k)).astype(np.float32),
                            H_init=H0, **kw)
    if name == "lnmf":
        return nt.lnmf(V, k, W_init=W0, H_init=H0, **kw)
    if name == "seminmf":
        return nt.seminmf(V - 0.5, k,
                          W_init=rng.uniform(-1, 1, (m, k)).astype(np.float32),
                          H_init=H0, **kw)
    if name == "nmf-multiseed":
        # restarts shard over the sample axis; expected collectives are
        # the same psum family as nmf (W row-reductions over m_ax)
        return nt.nmf_multiseed(V, k, 8, maxiter=1, mesh=mesh)
    if name in ("nmf-encode", "cnmf-encode", "cmfwisa-encode"):
        # problems shard over the mesh's sample axis (B = 8 divides the
        # 2x4 mesh's 4); expected collectives: NONE in the hot scan (the
        # dictionary is replicated, every problem is device-local) —
        # only reshard/ingest programs may move data
        Vb = rng.uniform(0.1, 1.0, (8, m, 11)).astype(np.float32)
        if name == "nmf-encode":
            return nt.nmf_encode(Vb, W0, maxiter=1, mesh=mesh, seed=2)
        if name == "cnmf-encode":
            W0c = rng.uniform(0.1, 1.0, (m, k, 3)).astype(np.float32)
            return nt.cnmf_encode(Vb, W0c, maxiter=1, mesh=mesh, seed=2)
        Vcb = (Vb * np.exp(1j * rng.uniform(size=Vb.shape))
               ).astype(np.complex64)
        return nt.cmfwisa_encode(Vcb, W0, maxiter=1, mesh=mesh, seed=2)
    if name == "nmf2d":
        # sample-axis sharding only: expected collectives are cnmf's
        # (psum'd reductions + time-halo permutes); the pitch shifts are
        # device-local (feature axis replicated)
        W0c = rng.uniform(0.1, 1.0, (m, k, 3)).astype(np.float32)
        Hp = rng.uniform(size=(k, n, 2)).astype(np.float32)
        return nt.nmf2d(V, k, 3, 2, W_init=W0c, H_init=Hp, **kw)
    if name == "constrainednmf":
        labels = np.full(n, -1)
        labels[rng.choice(n, n // 3, replace=False)] = rng.integers(0, 3, n // 3)
        nu = int(np.sum(labels == -1))
        return nt.constrainednmf(
            V, labels, k, W_init=W0,
            Z_init=rng.uniform(size=(k, nu + 3)).astype(np.float32), **kw)
    raise ValueError(name)


def hlo_one(name):
    dump = tempfile.mkdtemp(prefix=f"hlo_{name}_")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_dump_to={dump}")
    _setup_cpu8()
    from nmf_toolbox_tpu.parallel import make_mesh
    mesh = make_mesh(shape=(2, 4))
    _run_solver(name, mesh)
    counts = {c: 0 for c in COLLECTIVES}
    pat = {c: re.compile(rf"=\s+\S+\s+{c}(?:-start)?\(") for c in COLLECTIVES}
    for f in pathlib.Path(dump).glob("*after_optimizations*.txt"):
        text = f.read_text()
        for c in COLLECTIVES:
            counts[c] += len(pat[c].findall(text))
    print(json.dumps({"solver": name, **counts}))


def timing():
    jax = _setup_cpu8()
    import numpy as np
    import nmf_toolbox_tpu as nt
    from nmf_toolbox_tpu.parallel import make_mesh
    rng = np.random.default_rng(1)
    rows = []
    m, n, k, iters = 512, 65536, 32, 12
    V = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    W0 = rng.uniform(size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    T = 4
    W0c = rng.uniform(0.1, 1.0, (m, k, T)).astype(np.float32)
    nc = 16384
    for dev in (1, 2, 4, 8):
        mesh = make_mesh(dev) if dev > 1 else None
        B = 64  # batch for the serving engine: divisible by every dev
        Vb = rng.uniform(0.1, 1.0, (B, 257, 400)).astype(np.float32)
        for label, fn in (
            ("nmf", lambda: nt.nmf(V, k, W_init=W0, H_init=H0,
                                   maxiter=iters, tolerance=1e-30,
                                   mesh=mesh)),
            ("cnmf", lambda: nt.cnmf(V[:, :nc], k, T, W_init=W0c,
                                     H_init=H0[:, :nc], maxiter=iters,
                                     tolerance=1e-30, mesh=mesh)),
            ("nmf_encode", lambda: nt.nmf_encode(
                Vb, W0[:257], maxiter=iters, seed=2, mesh=mesh,
                device_output=True)),
        ):
            fn()  # compile warm-up
            t0 = time.perf_counter()
            r = fn()
            wall = time.perf_counter() - t0
            rows.append({"solver": label, "devices": dev,
                         "iters": iters, "wall_s": round(wall, 3),
                         "ms_per_iter": round(1000 * wall / iters, 2)})
            print(rows[-1], flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--hlo", default=None)
    ap.add_argument("--all", action="store_true")
    a = ap.parse_args()
    if a.hlo:
        hlo_one(a.hlo)
        return
    data = {}
    if a.timing or a.all:
        data["timing"] = timing()
        data["timing_note"] = (
            "8 virtual devices share one host's cores: validates sharded "
            "lowering overhead, not real speedup (see DESIGN.md section 9 "
            "addendum)")
    if a.all:
        inv = {}
        for s in SOLVERS:
            p = subprocess.run(
                [sys.executable, "-u", __file__, "--hlo", s],
                capture_output=True, text=True, timeout=600,
                cwd=str(HERE.parent))
            line = [ln for ln in p.stdout.splitlines()
                    if ln.startswith("{")][-1]
            inv[s] = json.loads(line)
            print(s, inv[s], flush=True)
        data["collectives_2x4_mesh"] = inv
        data["collectives_note"] = (
            "instruction counts over ALL XLA modules compiled by one "
            "sharded 1-iteration run on the 2x4 (feature x sample) mesh, "
            "including init/reshard programs")
    OUT.write_text(json.dumps(data, indent=1))
    print("wrote", OUT)


if __name__ == "__main__":
    main()
