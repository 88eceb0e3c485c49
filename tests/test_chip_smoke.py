"""chip_smoke.py on the CPU: its golden table, its plain references, its
refusal of a non-GPU platform, its last line and its ``--four``
selection.  The GPU run itself is ``python chip_smoke.py`` on a card.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax

import nmf_toolbox_tpu as nt

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


GOLDEN_NAMES = ("nmf_kl", "nmf_weighted_kl", "cnmf_euclid", "lnmf", "seminmf",
                "convexnmf", "chnmf", "chcnmf", "nmfsc_sparse",
                "cnmfsc_sparse", "cmfwisa", "constrainednmf_kl", "nmf2d_kl",
                "symnmf")


def test_golden_table_covers_every_family():
    assert tuple(cs.golden_cases(nt)) == GOLDEN_NAMES


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_case_within_threshold_on_cpu(name):
    """Each golden case in plain float32 on the CPU stays within a third
    of the threshold the GPU run is held to."""
    run, thresh = cs.golden_cases(nt)[name]
    dev = cs.golden_deviation(run)
    assert np.isfinite(dev) and dev <= thresh / 3, (name, dev, thresh)


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_golden_case_within_threshold_with_tf32_operands(name):
    """The thresholds hold under the card's default float32 matmul error
    model (TF32 operands), emulated on the CPU."""
    from nmf_toolbox_tpu.utils.debug import emulate_tf32_matmul_numerics
    run, thresh = cs.golden_cases(nt)[name]
    with emulate_tf32_matmul_numerics():
        dev = cs.golden_deviation(run)
    assert np.isfinite(dev) and dev <= thresh, (name, dev, thresh)


@pytest.mark.parametrize("name", list(cs.sharded_steps(nt)))
def test_sharded_step_on_one_device_matches_unsharded(name):
    from nmf_toolbox_tpu.parallel import make_mesh
    mesh = make_mesh(1, devices=jax.devices()[:1])
    fn = cs.sharded_steps(nt)[name]
    assert cs.sharded_deviation(fn, mesh) <= cs.SAME_MATH_COST


def _f32_problem(m, n, k, seed=0):
    V, W, H = cs._problem(seed, m, n, k, dtype=np.float32)
    return V, W, H


def test_euclid_reference_matches_program():
    V, W0, H0 = _f32_problem(60, 40, 5)
    Wr, Hr, cr = cs.euclid_reference(V, W0, H0, 8)
    r = nt.nmf(V, 5, W_init=W0, H_init=H0, maxiter=8, tolerance=1e-30)
    assert cs.rel_trace(r.cost, cr) < 1e-4
    assert cs.rel_max(r.W, Wr) < 1e-4 and cs.rel_max(r.H, Hr) < 1e-4
    # the reference's trace is the direct objective of its own factors
    assert abs(float(cs.euclid_cost(V, Wr, Hr)) - cr[-1]) <= 1e-5 * cr[-1]


def test_kl_reference_matches_program():
    V, W0, H0 = _f32_problem(50, 45, 4, seed=1)
    Wr, Hr, cr = cs.kl_reference(V, W0, H0, 8)
    r = nt.nmf(V, 4, W_init=W0, H_init=H0, divergence="kl", maxiter=8,
               tolerance=1e-30)
    assert cs.rel_trace(r.cost, cr) < 1e-4
    assert cs.rel_max(r.W, Wr) < 1e-4 and cs.rel_max(r.H, Hr) < 1e-4


def test_encode_phase_passes_at_tiny_size(capsys):
    assert cs.phase_encode(B=3, m=20, n=30, k=3, iters=10)
    out = capsys.readouterr().out
    assert "encode.cost" in out and "encode.H" in out and "FAIL" not in out


def test_objective_oracle_matches_program_in_float64():
    """The float64 oracle and the program in float64 agree far inside
    the 1e-5 gate (the gate then only measures float32 rounding)."""
    rng = np.random.default_rng(5)
    V = rng.uniform(0.05, 1.0, (40, 30))
    W0, H0 = rng.uniform(size=(40, 4)), rng.uniform(size=(4, 30))
    Wo, Ho = cs.objective_oracle(V, W0.copy(), H0.copy(), 30)
    r = nt.nmf(V, 4, W_init=W0, H_init=H0, maxiter=30, tolerance=1e-30,
               dtype=np.float64)
    c_o = 0.5 * np.sum((V - Wo @ Ho) ** 2)
    c_p = 0.5 * np.sum((V - r.W @ r.H) ** 2)
    assert abs(c_p - c_o) / c_o < 1e-12


def test_check_reports_and_rejects_nan(capsys):
    assert cs.check("x", 1e-6, 1e-5)
    assert not cs.check("y", 2e-5, 1e-5)
    assert not cs.check("z", float("nan"), 1.0)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[-1] for ln in lines] == ["OK", "FAIL", "FAIL"]
    assert "dev=1.000e-06" in lines[0] and "tol=1.0e-05" in lines[0]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_platform(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(ROOT / script)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_last_line_shape():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"
    line = cs.final_line([Dev()])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')


def test_default_phases_and_four_selects_only_the_mesh_phase():
    devices = jax.devices()
    assert [n for n, _ in cs.select_phases(False, devices)] == [
        "flagship", "kl", "objective", "encode", "goldens"]
    assert [n for n, _ in cs.select_phases(True, devices)] == ["four"]


def test_four_phase_on_four_virtual_cpu_devices(capsys):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    ok = cs.phase_four(devices, flagship=dict(m=64, n=48, k=4, iters=4),
                       conv=dict(m=17, n=40, k=3, T=3, iters=4))
    out = capsys.readouterr().out
    assert ok, out
    for name in ("nmf", "cnmf"):
        for mesh in ("1x4", "2x2"):
            assert f"four.{name}.{mesh}.cost" in out


def test_run_phases_reports_a_raising_phase_as_failed(capsys):
    def boom():
        raise RuntimeError("boom")
    assert not cs.run_phases([("a", lambda: True), ("b", boom)])
    out = capsys.readouterr().out
    assert "phase a: passed" in out and "phase b: FAILED" in out
