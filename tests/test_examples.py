"""Smoke-run every script in examples/ (the demo surface must not rot
with API changes).

Each example is a self-contained ``main()`` with its own quality
asserts (SDR thresholds, recovery errors, label accuracy), so running
it in-process under the CPU test config both exercises the public API
end-to-end and checks the example still demonstrates what it claims.
"""
import importlib.util
import pathlib
import sys

import pytest

EXAMPLES = sorted((pathlib.Path(__file__).parent.parent / "examples").glob("*.py"))
assert len(EXAMPLES) >= 7, [p.name for p in EXAMPLES]


def _load(path):
    spec = importlib.util.spec_from_file_location(f"example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs(path, capsys):
    mod = _load(path)
    mod.main()           # internal asserts are the quality gate
    out = capsys.readouterr().out
    assert out.strip(), f"{path.name} produced no output"
    assert "nan" not in out.lower(), f"{path.name} printed a NaN:\n{out}"
