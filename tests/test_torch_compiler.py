"""The port's JAX-free compiler vs ``qbot_tpu``'s ``compile_circuit(circ,
window, pair=False)``: plans equal step for step, field for field.

Tolerance: none.  Both fold window matrices with the same numpy code, so
every matrix and reflection factor must be bit-identical.
"""
import dataclasses

import numpy as np
import pytest

from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu.circuit import Circuit, qft_circuit, random_circuit
from qbot_tpu_torch.tpu.compiler import compile_circuit


def grover_body(n, marked):
    c = Circuit(n)
    c.phase_flip(marked)
    for q in range(n):
        c.h(q)
    c.phase_flip(0)
    for q in range(n):
        c.h(q)
    return c


def brickwork(n, layers, seed=0):
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    for layer in range(layers):
        for q in range(n):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())), [q])
        for q in range(layer % 2, n - 1, 2):
            c.gate(X, [q + 1], controls=[q])
    return c


CIRCUITS = {
    "grover_body": lambda: grover_body(11, 1234),
    "brickwork": lambda: brickwork(12, 4),
    "random": lambda: random_circuit(10, 3, seed=5),
    "qft": lambda: qft_circuit(9),
}


def assert_same(a, b, where="plan"):
    assert type(a) is type(b), f"{where}: {type(a)} != {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), f"{where}: {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.mark.parametrize("window", [4, 5, 7])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_plan_equals_unpaired_jax_plan(name, window):
    circ = CIRCUITS[name]()
    got = compile_circuit(circ, window=window)
    want = jc.compile_circuit(circ, window=window, pair=False)
    assert_same(got, want)
    assert got.num_passes == want.num_passes


def test_grover_body_is_one_reflection():
    plan = compile_circuit(grover_body(11, 1234))
    assert [type(s) for s in plan.steps] == [jc.ReflectStep]
    assert plan.steps[0].pre_flips == (1234,)


def test_never_pairs():
    circ = brickwork(12, 2)
    assert any(isinstance(s, jc.PairStep)
               for s in jc.compile_circuit(circ).steps)
    assert not any(isinstance(s, jc.PairStep)
                   for s in compile_circuit(circ).steps)


@pytest.mark.parametrize("window", ["auto", 7.0])
def test_rejects_non_integer_window(window):
    with pytest.raises(ValueError, match="integer"):
        compile_circuit(random_circuit(4, 1), window=window)
