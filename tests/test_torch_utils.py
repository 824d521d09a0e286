"""The port's utilities against ``qbot_tpu``'s: the numeric guards
(:mod:`qbot_tpu_torch.utils.guards`) raise, or pass, on the same arrays
with the same messages, on numpy arrays and CPU tensors alike; ``checked``
keeps the reference's ``(error, value)`` convention; ``device_trace``
writes a Chrome trace, and a ``named_scope`` range shows in it.

Tolerance: none (the same verdicts and the same message text).
"""
import glob
import json

import numpy as np
import pytest
import torch

from qbot_tpu.utils import guards as jg
from qbot_tpu_torch.utils import guards as tg
from qbot_tpu_torch.utils.profiling import device_trace, named_scope

torch.set_num_threads(1)


def _basis(n, dtype=complex):
    psi = np.zeros(2**n, dtype=dtype)
    psi[0] = 1
    return psi


def _planar(psi):
    return np.stack([psi.real, psi.imag]).astype(np.float32)


ARRAYS = {
    "ones": np.ones(3),
    "nan": np.array([1.0, np.nan]),
    "inf": np.array([np.inf, 1.0, -np.inf]),
    "complex_nan": np.array([1.0 + 0j, np.nan + 1j]),
    "planar_nan": _planar(np.array([np.nan, 1.0 + 1j])),
    "float32": np.arange(6, dtype=np.float32).reshape(2, 3),
}

STATES = {
    "basis": (_basis(3), {}),
    "planar": (_planar(_basis(3)), {}),
    "doubled": (2 * _basis(2), {}),
    "planar_doubled": (_planar(2 * _basis(2)), {}),
    "slightly_off": (1.0004 * _basis(2), {}),
    "slightly_off_tight": (1.0004 * _basis(2), {"atol": 1e-4}),
    "named": (0.5 * _basis(2), {"name": "psi"}),
    "uniform": (np.full(8, 8 ** -0.5, dtype=complex), {}),
}


def _verdict(fn, *args, **kwargs):
    """None when ``fn`` passes, else the (class name, message) it raised."""
    try:
        fn(*args, **kwargs)
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("name", list(ARRAYS))
def test_assert_finite_as_reference(name, as_tensor):
    arr = ARRAYS[name]
    x = torch.as_tensor(arr) if as_tensor else arr
    want = _verdict(jg.assert_finite, arr, "amps")
    assert _verdict(tg.assert_finite, x, "amps") == want
    if want is None:
        assert tg.assert_finite(x) is x


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("name", list(STATES))
def test_check_norm_as_reference(name, as_tensor):
    state, kwargs = STATES[name]
    x = torch.as_tensor(state) if as_tensor else state
    want = _verdict(jg.check_norm, state, **kwargs)
    assert _verdict(tg.check_norm, x, **kwargs) == want
    if want is None:
        assert tg.check_norm(x, **kwargs) is x


@pytest.mark.parametrize("case", ["finite", "nan", "inf", "tuple"])
def test_checked_as_reference(case):
    import jax.numpy as jnp

    fns = {"finite": lambda x: x * 2, "nan": lambda x: x * np.nan,
           "inf": lambda x: x / 0.0, "tuple": lambda x: (x, {"y": x / 0.0})}
    err_j, _ = jg.checked(fns[case])(jnp.ones(3))
    err_t, out = tg.checked(fns[case])(torch.ones(3))
    if err_j.get() is None:
        assert err_t.get() is None
        err_t.throw()
        assert torch.equal(out, torch.full((3,), 2.0))
        return
    assert err_t.get() in err_j.get()
    with pytest.raises(tg.NumericError, match="non-finite value"):
        err_t.throw()


def test_checked_catches_a_nan_in_an_executor_run():
    from qbot_tpu_torch.tpu.circuit import Circuit
    from qbot_tpu_torch.tpu.compiler import compile_circuit
    from qbot_tpu_torch.tpu.planar import apply_plan_planar, zero_state_planar

    c = Circuit(3)
    for q in range(3):
        c.h(q)
    plan = compile_circuit(c)
    run = tg.checked(lambda psi: apply_plan_planar(psi, plan))
    err, out = run(zero_state_planar(3, "cpu"))
    err.throw()
    tg.check_norm(out)
    bad = zero_state_planar(3, "cpu")
    bad[0, 5] = float("nan")
    err, _ = run(bad)
    with pytest.raises(tg.NumericError):
        err.throw()


def test_device_trace_writes_a_trace_with_named_scopes(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        with named_scope("qbot_window_step"):
            x = torch.ones(4096) * 3.0
        assert float(x.sum()) == 3.0 * 4096
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "qbot_window_step" for e in events)
    assert "qbot_window_step" in {e.key for e in prof.key_averages()}
