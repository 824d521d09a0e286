"""The port's JAX-free compiler vs ``qbot_tpu``'s ``compile_circuit(circ,
window, pair)``: plans equal step for step, field for field, paired (the
default of both) and unpaired.

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
    got = compile_circuit(circ, window=window, pair=False)
    want = jc.compile_circuit(circ, window=window, pair=False)
    assert_same(got, want)
    assert got.num_passes == want.num_passes


@pytest.mark.parametrize("window", [4, 5, 7])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_plan_equals_paired_jax_plan(name, window):
    circ = CIRCUITS[name]()
    got = compile_circuit(circ, window=window, pair=True)
    want = jc.compile_circuit(circ, window=window, pair=True)
    assert_same(got, want)
    assert got.num_passes == want.num_passes


@pytest.mark.parametrize("window", [2, 7])
def test_default_plan_equals_jax_default(window):
    circ = brickwork(9, 4)
    assert_same(compile_circuit(circ, window),
                jc.compile_circuit(circ, window))


def test_grover_body_is_one_reflection():
    plan = compile_circuit(grover_body(11, 1234))
    assert [type(s) for s in plan.steps] == [jc.ReflectStep]
    assert plan.steps[0].pre_flips == (1234,)


def test_never_pairs():
    """The default pairs where ``qbot_tpu``'s does; ``pair=False`` never
    pairs."""
    circ = brickwork(12, 2)
    pairs = [s for s in compile_circuit(circ).steps
             if isinstance(s, jc.PairStep)]
    assert pairs
    assert_same(pairs, [s for s in jc.compile_circuit(circ).steps
                        if isinstance(s, jc.PairStep)])
    assert not any(isinstance(s, jc.PairStep)
                   for s in compile_circuit(circ, pair=False).steps)


def test_headline_plans_pass_counts():
    """The 26-qubit brickwork of 16 layers makes 34 passes paired (9
    trailing and 8 middle pairs, 17 windows) and 51 unpaired; Grover's
    Hadamard init makes one pair of each kind."""
    circ = brickwork(26, 16)
    plan = compile_circuit(circ)
    assert plan.num_passes == 34
    assert compile_circuit(circ, pair=False).num_passes == 51
    geoms = {(s.first.start, s.first.width, s.second.start, s.second.width)
             for s in plan.steps if isinstance(s, jc.PairStep)}
    assert geoms == {(0, 5, 5, 7), (12, 7, 19, 7)}
    init = Circuit(26)
    for q in range(26):
        init.h(q)
    assert [type(s) for s in compile_circuit(init).steps] == [jc.PairStep] * 2


@pytest.mark.parametrize("window", ["auto", 7.0])
def test_rejects_non_integer_window(window):
    with pytest.raises(ValueError, match="integer"):
        compile_circuit(random_circuit(4, 1), window=window)
