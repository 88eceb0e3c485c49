"""Mesh-shape generality sweep.

The driver's dryrun pins n_devices=8 (a 2x4 mesh) and the distributed
artifact pins 2 processes x 4 devices; this sweep shows the mesh /
padding / placement layer generalizes beyond those two shapes:

* ``dryrun_multichip`` (the FULL ~20-solver sharded sweep, deliberately
  non-divisible shapes) at n_devices = 2 (minimal 1-D), 5 (odd -> 1-D
  mesh, maximally awkward padding), and 16 (2x8 — wider than any shape
  previously executed), each in its own subprocess on virtual CPU
  devices.
* a 4-process x 2-device ``jax.distributed`` run (distributed_multiproc
  .py 4 2) with the same bit-exactness + single-process-parity + orbax
  resume assertions as the canonical 2x4 artifact.

Writes benchmarks/MULTICHIP_SHAPES_cpu.json.

Usage: python benchmarks/multichip_shapes.py [--quick]  (quick: n=2 only)
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).parent
REPO = HERE.parent
OUT = HERE / "MULTICHIP_SHAPES_cpu.json"


def run_dryrun(n, timeout=1200):
    env = dict(os.environ)
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   env.get("XLA_FLAGS", "")).strip()
    env["XLA_FLAGS"] = (flags +
                        f" --xla_force_host_platform_device_count={n}").strip()
    pp = env.get("PYTHONPATH", "")
    if str(REPO) not in pp.split(os.pathsep):
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), pp) if p)
    src = ("import jax; jax.config.update('jax_platforms','cpu'); "
           f"import __graft_entry__ as g; g.dryrun_multichip({n})")
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", src], env=env, cwd=str(REPO),
                       capture_output=True, text=True, timeout=timeout)
    entry = {"ok": p.returncode == 0,
             "wall_s": round(time.monotonic() - t0, 1)}
    if p.returncode == 0:
        tail = [l for l in p.stdout.splitlines() if "OK — mesh axes" in l]
        entry["mesh"] = tail[-1].split("OK — ")[-1] if tail else "?"
    else:
        entry["error"] = (p.stderr or p.stdout)[-1500:]
    return entry


def main(argv):
    quick = "--quick" in argv
    report = {"dryrun": {}, "distributed_4x2": None}
    for n in ((2,) if quick else (2, 5, 16)):
        print(f"dryrun n={n} ...", file=sys.stderr, flush=True)
        report["dryrun"][str(n)] = run_dryrun(n)
        print(f"  -> {report['dryrun'][str(n)]}", file=sys.stderr)

    if not quick:
        print("distributed 4proc x 2dev ...", file=sys.stderr, flush=True)
        p = subprocess.run(
            [sys.executable, str(HERE / "distributed_multiproc.py"), "4", "2"],
            capture_output=True, text=True, timeout=1800, cwd=str(REPO))
        try:
            child = json.loads(p.stdout[p.stdout.index("{"):])
        except ValueError:
            child = {"ok": False,
                     "error": (p.stderr or p.stdout)[-1500:]}
        report["distributed_4x2"] = {
            "ok": bool(child.get("ok")),
            "solvers": {k: v.get("ok") for k, v in
                        child.get("solvers", {}).items()},
            "orbax_ckpt_ok": child.get("orbax_multiproc_ckpt", {}).get("ok"),
            "artifact": "DISTRIBUTED_cpu_multiproc_4x2.json"}
        if "error" in child:
            report["distributed_4x2"]["error"] = child["error"]

    report["ok"] = bool(
        all(e["ok"] for e in report["dryrun"].values())
        and (quick or report["distributed_4x2"]["ok"]))
    print(json.dumps(report), flush=True)
    if not quick:
        OUT.write_text(json.dumps(report, indent=1) + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
