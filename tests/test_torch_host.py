"""The port's copy of the host layer vs ``qbot_tpu``'s, on every example
program: the dense interpreter's readouts, the lowered circuit, the
compiled plans, and the error a bad program raises.

Tolerance: none.  Both packages run the same numpy code on the host, so
printed output, lowered matrices, plans and error messages must be
identical (plans and circuits compared field by field).
"""
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest

import qbot_tpu.errors as jerr
from _torch_parity import assert_same
from qbot_tpu.frontend.interpreter import executeTxt as jax_execute
from qbot_tpu.frontend.lowering import lower_program as jax_lower
from qbot_tpu.ops.measurement import MeasurementResult
from qbot_tpu.tpu.compiler import compile_circuit as jax_compile
from qbot_tpu_torch import backend, compile_circuit, executeTxt, lower_program
from qbot_tpu_torch.errors import QbotScriptError
from qbot_tpu_torch.ops.measurement import \
    MeasurementResult as TorchMeasurementResult
from qbot_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.qb"))


def _run(fn, src, error_cls):
    """(result or None, stdout, (error class name, message) or None)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            return fn(src), buf.getvalue(), None
        except error_cls as e:
            return None, buf.getvalue(), (type(e).__name__, str(e))


def _both(torch_fn, jax_fn, src):
    got = _run(torch_fn, src, QbotScriptError)
    want = _run(jax_fn, src, jerr.QbotScriptError)
    assert got[1] == want[1]
    assert got[2] == want[2]
    return got[0], want[0]


def _source(name):
    return (ROOT / "examples" / name).read_text()


@pytest.mark.parametrize("name", EXAMPLES)
def test_execute_txt_same_readout(name):
    got, want = _both(executeTxt, jax_execute, _source(name))
    if want is None:
        return
    results = {k: v.probs for k, v in want.items()
               if isinstance(v, MeasurementResult)}
    assert results
    assert {k: v.probs for k, v in got.items()
            if isinstance(v, TorchMeasurementResult)} == results
    np.testing.assert_array_equal(got["state"], want["state"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_lower_program_same_circuit(name):
    got, want = _both(lower_program, jax_lower, _source(name))
    if want is None:
        return
    assert_same(got.circuit, want.circuit, "circuit")
    assert_same(got.initial_kets, want.initial_kets, "initial_kets")
    assert (got.measure_targets, got.measure_name, got.resume_line) == \
        (want.measure_targets, want.measure_name, want.resume_line)
    assert got.has_epilogue == want.has_epilogue


@pytest.mark.parametrize("name", EXAMPLES)
def test_mid_measure_lowering_same_events(name):
    """``lower_program(..., mid_measure=True)``: the same circuit and the
    same measurement and discard events, in order."""
    got, want = _both(lambda s: lower_program(s, mid_measure=True),
                      lambda s: jax_lower(s, mid_measure=True), _source(name))
    if want is None:
        return
    assert_same(got.circuit, want.circuit, "circuit")
    assert [(type(e).__name__, e.targets, e.at_op)
            for e in got.mid_measurements] == \
        [(type(e).__name__, e.targets, e.at_op)
         for e in want.mid_measurements]


def test_line_profile_reports_every_executed_line():
    with profiling.profiling_enabled():
        executeTxt(_source("grover.qb"))
        report = profiling.line_profile_report().splitlines()
    assert report[0].split() == ["line", "op", "hits", "total(s)", "mean(s)"]
    rows = {int(r.split()[0]): r.split()[1:3] for r in report[1:]}
    assert rows[2] == ["qset", "1"]
    assert ["gate", "3"] in rows.values()
    assert not profiling.is_enabled()


def test_backend_is_numpy_only():
    with pytest.raises(ValueError, match="imports no jax"):
        backend.set_backend("jax")
    backend.set_backend("numpy")
    assert backend.xp() is np


@pytest.mark.parametrize("pair", [True, False], ids=["paired", "unpaired"])
@pytest.mark.parametrize("window", [7, 2])
@pytest.mark.parametrize("name", EXAMPLES)
def test_compilers_same_plan(name, window, pair):
    got, want = _both(lower_program, jax_lower, _source(name))
    if want is None:
        return
    assert_same(compile_circuit(got.circuit, window, pair),
                jax_compile(want.circuit, window, pair))


def _broken(src, kind):
    """``src`` with an unknown operation first, or a gate on a qubit past
    the register right after its first ``qset``."""
    lines = src.splitlines()
    if kind == "unknown_op":
        return "\n".join(["frob 1"] + lines)
    at = next(i for i, line in enumerate(lines) if line.startswith("qset"))
    return "\n".join(lines[:at + 1] + ["gate hadamardGate ; 7"]
                     + lines[at + 1:])


@pytest.mark.parametrize("kind", ["unknown_op", "bad_target"])
@pytest.mark.parametrize("name", EXAMPLES)
def test_bad_program_same_error(name, kind):
    src = _broken(_source(name), kind)
    for torch_fn, jax_fn in ((executeTxt, jax_execute),
                             (lower_program, jax_lower)):
        got = _run(torch_fn, src, QbotScriptError)
        want = _run(jax_fn, src, jerr.QbotScriptError)
        assert want[2] is not None
        assert got[1:] == want[1:]
