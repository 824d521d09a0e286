"""The port's JAX-free compiler vs ``qbot_tpu``'s ``compile_circuit(circ,
window, pair)``: plans equal step for step, field for field, paired (the
default of both) and unpaired.

Tolerance: none.  Both fold window matrices with the same numpy code, so
every matrix and reflection factor must be bit-identical.
"""
import pytest

from _torch_parity import assert_same, both, brickwork, grover_body
from qbot_tpu.tpu import compiler as jc
from qbot_tpu_torch.tpu import circuit as tcirc
from qbot_tpu_torch.tpu import compiler as tc
from qbot_tpu_torch.tpu.circuit import Circuit, random_circuit
from qbot_tpu_torch.tpu.compiler import compile_circuit

CIRCUITS = {
    "grover_body": lambda m: grover_body(m, 11, 1234),
    "brickwork": lambda m: brickwork(m, 12, 4),
    "random": lambda m: m.random_circuit(10, 3, seed=5),
    "qft": lambda m: m.qft_circuit(9),
}


@pytest.mark.parametrize("window", [4, 5, 7])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_plan_equals_unpaired_jax_plan(name, window):
    circ, jcirc = both(CIRCUITS[name])
    got = compile_circuit(circ, window=window, pair=False)
    want = jc.compile_circuit(jcirc, window=window, pair=False)
    assert_same(got, want)
    assert got.num_passes == want.num_passes


@pytest.mark.parametrize("window", [4, 5, 7])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_plan_equals_paired_jax_plan(name, window):
    circ, jcirc = both(CIRCUITS[name])
    got = compile_circuit(circ, window=window, pair=True)
    want = jc.compile_circuit(jcirc, window=window, pair=True)
    assert_same(got, want)
    assert got.num_passes == want.num_passes


@pytest.mark.parametrize("window", [2, 7])
def test_default_plan_equals_jax_default(window):
    circ, jcirc = both(lambda m: brickwork(m, 9, 4))
    assert_same(compile_circuit(circ, window),
                jc.compile_circuit(jcirc, window))


def test_grover_body_is_one_reflection():
    plan = compile_circuit(grover_body(tcirc, 11, 1234))
    assert [type(s) for s in plan.steps] == [tc.ReflectStep]
    assert plan.steps[0].pre_flips == (1234,)


def test_never_pairs():
    """The default pairs where ``qbot_tpu``'s does; ``pair=False`` never
    pairs."""
    circ, jcirc = both(lambda m: brickwork(m, 12, 2))
    pairs = [s for s in compile_circuit(circ).steps
             if isinstance(s, tc.PairStep)]
    assert pairs
    assert_same(pairs, [s for s in jc.compile_circuit(jcirc).steps
                        if isinstance(s, jc.PairStep)])
    assert not any(isinstance(s, tc.PairStep)
                   for s in compile_circuit(circ, pair=False).steps)


def test_headline_plans_pass_counts():
    """The 26-qubit brickwork of 16 layers makes 34 passes paired (9
    trailing and 8 middle pairs, 17 windows) and 51 unpaired; Grover's
    Hadamard init makes one pair of each kind."""
    circ = brickwork(tcirc, 26, 16)
    plan = compile_circuit(circ)
    assert plan.num_passes == 34
    assert compile_circuit(circ, pair=False).num_passes == 51
    geoms = {(s.first.start, s.first.width, s.second.start, s.second.width)
             for s in plan.steps if isinstance(s, tc.PairStep)}
    assert geoms == {(0, 5, 5, 7), (12, 7, 19, 7)}
    init = Circuit(26)
    for q in range(26):
        init.h(q)
    assert [type(s) for s in compile_circuit(init).steps] == [tc.PairStep] * 2


# window="auto" ranks widths now (tests/test_torch_auto.py); the case of
# that id holds the reference's internal "auto_pallas", which the port
# does not take
@pytest.mark.parametrize("window", [pytest.param("auto_pallas", id="auto"),
                                    7.0])
def test_rejects_non_integer_window(window):
    with pytest.raises(ValueError, match="integer"):
        compile_circuit(random_circuit(4, 1), window=window)
