"""Checkpoint-stall comparison: npz backend vs orbax backend.

What a long sharded run cares about is how long the solver loop is
STALLED per checkpoint.  The npz backend gathers every factor to host
numpy and writes one file synchronously; the orbax backend snapshots the
device buffers and (with wait=False) serializes in the background, so
the loop stall is only the snapshot.  Measured here on the 8-virtual-
device CPU mesh (the same rig the sharding suite uses) — across hosts
the gap widens further because the npz gather crosses the network
while orbax writes per-host shards.

Usage: python benchmarks/checkpoint_bench.py [--quick]
Writes benchmarks/CHECKPOINT_cpu8.json (full run only).
"""
import argparse
import json
import os
import pathlib
import shutil
import statistics
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "CHECKPOINT_cpu8.json"

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(quick: bool):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from nmf_toolbox_tpu.parallel import make_mesh, apply_placements
    from nmf_toolbox_tpu.utils.checkpoint import save_factors
    from nmf_toolbox_tpu.utils.checkpoint_orbax import (
        save_factors_orbax, wait_for_saves)

    m = n = 4096 if quick else 32768
    k = 64 if quick else 512
    mesh = make_mesh(8)
    kw_, kh_ = jax.random.split(jax.random.PRNGKey(0))
    W = jax.random.uniform(kw_, (m, k), jnp.float32)
    H = jax.random.uniform(kh_, (k, n), jnp.float32)
    W, H = apply_placements(mesh, "nmf", W=W, H=H)[0:2]
    jax.block_until_ready((W, H))
    state = {"W": W, "H": H}
    mb = (W.nbytes + H.nbytes) / 2**20
    print(f"factors: W {W.shape} + H {H.shape} = {mb:.0f} MiB, "
          f"sharded over {mesh.devices.size} devices", flush=True)

    tmp = tempfile.mkdtemp(prefix="ckbench_")
    reps = 3
    rows = {}

    def med(xs):
        return statistics.median(xs)

    # npz: gather + synchronous single-file write
    ts = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        save_factors(f"{tmp}/f{i}.npz", state)
        ts.append(time.perf_counter() - t0)
    rows["npz_save_s"] = round(med(ts[1:]), 3)

    # orbax, wait=True: full commit
    ts = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        save_factors_orbax(f"{tmp}/ob{i}", state, wait=True)
        ts.append(time.perf_counter() - t0)
    rows["orbax_save_s"] = round(med(ts[1:]), 3)

    # orbax, wait=False: loop stall only (background write continues)
    stalls, commits = [], []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        save_factors_orbax(f"{tmp}/oba{i}", state, wait=False)
        stalls.append(time.perf_counter() - t0)
        wait_for_saves()
        commits.append(time.perf_counter() - t0)
    rows["orbax_async_stall_s"] = round(med(stalls[1:]), 3)
    rows["orbax_async_commit_s"] = round(med(commits[1:]), 3)

    shutil.rmtree(tmp, ignore_errors=True)
    data = {"shape": f"W ({m},{k}) + H ({k},{n}) f32", "mib": round(mb),
            "devices": 8, "platform": "cpu-virtual-mesh", **rows}
    print(json.dumps(data, indent=1), flush=True)
    if not quick:
        OUT.write_text(json.dumps(data, indent=1) + "\n")
        print("wrote", OUT, flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    main(ap.parse_args().quick)
