"""On-chip fault-injection soak: crash a checkpointed flagship run
mid-way, resume it, and assert BIT-EXACT continuation (the CPU
case is proven in tests/test_checkpoint*.py — this captures
the same guarantee on the real device).

Three child processes:

  full   — uninterrupted run_checkpointed(nt.nmf, ...) in chunks,
           final factors saved to an npz.
  crash  — same run, but the solver wrapper calls os._exit(137) when
           the SECOND chunk starts, i.e. immediately AFTER checkpoint 1
           was committed and BETWEEN device dispatches.  (The fault
           is injected at the host-side chunk boundary: exactly where a real
           preemption is survivable.)
  resume — re-runs the same run_checkpointed call against the crashed
           checkpoint; it must complete the remaining chunks.

The parent asserts resume's final W/H/cost are bit-identical
(np.array_equal) to full's, and prints one JSON line.

Reference behavior being protected: every solver accepts W_init/H_init
so resume == re-call with the last factors (SURVEY.md section 5); the
memoryless MU chunk sequence is bit-deterministic, so any deviation is
a checkpoint-layer bug (or a device numerics red flag).

Usage: python benchmarks/checkpoint_soak.py [--small] [--cpu]
Writes benchmarks/CKPT_SOAK.json (full GPU runs only).
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).parent
sys.path.insert(0, str(HERE.parent))
OUT = HERE / "CKPT_SOAK.json"

TOTAL_ITERS = 60
CHUNK = 20


def _dims(small):
    return (512, 256, 16) if small else (8192, 2048, 64)


def child(mode, ckpt, outnpz, small, cpu):
    import numpy as np
    if cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import nmf_toolbox_tpu as nt
    from nmf_toolbox_tpu.utils.checkpoint import run_checkpointed

    m, n, k = _dims(small)
    rng = np.random.default_rng(0)
    V = (rng.gamma(2.0, 1.0, (m, 8)) @ rng.gamma(0.5, 1.0, (8, n))
         + 0.01).astype(np.float32)

    calls = {"n": 0}

    def solver(Vv, kk, **cfg):
        calls["n"] += 1
        if mode == "crash" and calls["n"] == 2:
            # checkpoint 1 is on disk; we are between device dispatches
            sys.stderr.write("soak: injecting crash at chunk 2 start\n")
            sys.stderr.flush()
            os._exit(137)
        return nt.nmf(Vv, kk, **cfg)

    t0 = time.monotonic()
    res = run_checkpointed(solver, V, k, total_iters=TOTAL_ITERS,
                           chunk=CHUNK, path=ckpt, backend="npz",
                           seed=7, tolerance=0.0)
    wall = time.monotonic() - t0
    np.savez(outnpz, W=np.asarray(res.W), H=np.asarray(res.H),
             cost=np.asarray(res.cost), wall=np.asarray(wall))
    print(json.dumps({"mode": mode, "wall_s": round(wall, 2),
                      "n_iters": int(res.n_iters)}))
    return 0


def main(argv):
    small = "--small" in argv
    cpu = "--cpu" in argv
    if "--child" in argv:
        i = argv.index("--child")
        return child(argv[i + 1], argv[i + 2], argv[i + 3], small, cpu)

    if not cpu:
        import jax
        if jax.devices()[0].platform != "gpu":
            print("no GPU (use --cpu to smoke on host)", file=sys.stderr)
            return 1

    import numpy as np
    tmp = tempfile.mkdtemp(prefix="nmf_soak_")
    me = str(HERE / "checkpoint_soak.py")
    passthru = [a for a in argv if a in ("--small", "--cpu")]

    def run(mode, ckpt, outnpz, expect_rc=0):
        p = subprocess.run(
            [sys.executable, me, *passthru, "--child", mode, ckpt, outnpz],
            capture_output=True, text=True, timeout=1500)
        if p.returncode != expect_rc:
            print(f"{mode} child rc={p.returncode}\n{p.stderr[-2000:]}",
                  file=sys.stderr)
            raise SystemExit(1)
        return p

    full_npz = os.path.join(tmp, "full_out.npz")
    res_npz = os.path.join(tmp, "resume_out.npz")
    run("full", os.path.join(tmp, "full.npz"), full_npz)
    crash_ckpt = os.path.join(tmp, "crash.npz")
    run("crash", crash_ckpt, os.path.join(tmp, "unused.npz"),
        expect_rc=137)
    assert os.path.exists(crash_ckpt), "crash child left no checkpoint"
    run("resume", crash_ckpt, res_npz)

    a, b = np.load(full_npz), np.load(res_npz)
    bitexact = (np.array_equal(a["W"], b["W"])
                and np.array_equal(a["H"], b["H"]))
    cost_match = np.array_equal(a["cost"], b["cost"])
    m, n, k = _dims(small)
    row = {"soak": "crash-at-chunk-2 + resume vs uninterrupted",
           "shape": f"{m}x{n} r{k}",
           "total_iters": TOTAL_ITERS, "chunk": CHUNK,
           "device": "cpu" if cpu else "gpu",
           "bitexact_factors": bool(bitexact),
           "cost_trace_identical": bool(cost_match),
           "full_wall_s": float(a["wall"]),
           "resume_wall_s": float(b["wall"])}
    print(json.dumps(row), flush=True)
    if not (small or cpu):
        OUT.write_text(json.dumps(row, indent=1) + "\n")
    return 0 if bitexact else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
