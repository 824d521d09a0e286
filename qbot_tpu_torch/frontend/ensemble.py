"""Probabilistic control flow: the ensemble program runner.

The reference *designed* probabilistic branching of the interpreter itself —
ProbVal-conditioned ``cjmp``/``halt`` forking execution and merging
namespaces — but shipped it disabled (commented machinery at reference
interpreter.py:8-66,148-215, operators.py:196-232; ``qjmp`` raises
NotImplementedError).  SURVEY.md §1/§7 re-founds that abandoned capability
as a particle ensemble; this module is the host-side exact version (the
device-side scalable twin is :mod:`qbot_tpu_torch.frontend.device_ensemble`
on :mod:`qbot_tpu_torch.inference`).  Copy of
``qbot_tpu/frontend/ensemble.py``, numpy only.

Semantics: a program runs as a set of weighted particles (probability,
namespace, program counter).  A ``cjmp`` whose condition evaluates to
``ProbVal<bool>`` splits the current particle into a jump branch and a
fall-through branch weighted by the condition's truth probability;
``halt``/``retr`` with ProbVal conditions split likewise.  Particles run to
completion independently; the final namespaces merge:

* quantum variables (``__is_q_*``) mix as Σ pᵢ ρᵢ (branch-weighted density);
* classical variables combine into ProbVals over per-branch values (missing
  keys contribute ``None`` branches, matching the reference's intended
  ``collapseNamespaces`` behaviour, interpreter.py:39-45);
* branches whose value distributions agree collapse automatically through
  ProbVal normalisation.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

import qbot_tpu_torch.errors as err
from qbot_tpu_torch.frontend import operations as ops
from qbot_tpu_torch.frontend.evaluation import evaluate_expr
from qbot_tpu_torch.frontend.interpreter import record_marks, tokenize_line
from qbot_tpu_torch.ops.core import empty_state, mix_densities
from qbot_tpu_torch.probval import ProbVal

__all__ = ["execute_lines_ensemble", "executeTxtEnsemble", "EnsembleResult",
           "MAX_PARTICLES"]

MAX_PARTICLES = 256


@dataclass
class _Particle:
    prob: float
    ns: dict
    line: int                      # next line to execute
    done: bool = False


@dataclass
class EnsembleResult:
    """Merged namespace plus the raw branch particles.

    ``lost_mass`` is the cumulative probability mass dropped by branch
    pruning (device ensemble runner) — an exact total-variation error bound
    on reported distributions.  The host runner is exact, so it stays 0.0.
    """
    namespace: dict
    branch_probs: list[float] = field(default_factory=list)
    branch_namespaces: list[dict] = field(default_factory=list)
    lost_mass: float = 0.0


def _truth_probability(pv: ProbVal, lines, line_num):
    """(P(true), P(false)) of a ProbVal<bool>."""
    if not isinstance(pv.instance(), bool):
        raise err.type_error(lines, line_num, ["bool", "ProbVal<bool>"],
                             pv.type_string())
    p_true = sum(p for p, v in zip(pv.probs, pv.values) if v)
    return p_true, 1.0 - p_true


def _clone_ns(ns: dict) -> dict:
    out = {}
    for k, v in ns.items():
        if isinstance(v, dict):
            out[k] = dict(v)
        elif isinstance(v, (list, set)):
            out[k] = copy.deepcopy(v)
        else:
            out[k] = v
    return out


def _step_particle(particle: _Particle, lines, max_particles: int
                   ) -> list[_Particle]:
    """Execute lines until the particle halts, splits, or runs off the end.

    Returns the list of particles replacing this one (itself, or two
    children after a probabilistic split).
    """
    ns = particle.ns
    line_num = particle.line - 1
    end_line = len(lines)
    while line_num < end_line - 1:
        line_num += 1
        tokens = tokenize_line(lines[line_num])
        if not tokens:
            continue
        op_name = tokens[0]
        if op_name in ("note", "mark"):
            continue
        try:
            op, min_args, max_args = ops.OPERATIONS[op_name]
        except KeyError:
            raise err.unknown_operation(lines, line_num, op_name) from None
        num_args = len(tokens) - 1
        if num_args < min_args or num_args > max_args:
            raise err.num_arguments_error(lines, line_num, op_name, num_args,
                                          min_args, max_args)

        # control-flow ops are handled inline (evaluating the condition
        # exactly once) so ProbVal<bool> conditions can split the particle
        if op_name in ("cjmp", "halt", "retr"):
            has_cond = num_args >= (2 if op_name == "cjmp" else 1)
            cond = True
            if has_cond:
                cond_token = tokens[2] if op_name == "cjmp" else tokens[1]
                cond = evaluate_expr(lines, line_num, cond_token, ns)
            if isinstance(cond, ProbVal):
                p_true, p_false = _truth_probability(cond, lines, line_num)
                children = []

                def _spawn(prob, target_line, clone, done=False,
                           prev_jump=None):
                    child_ns = _clone_ns(ns) if clone else ns
                    if prev_jump is not None:
                        child_ns["__prev_jump"] = prev_jump
                    children.append(_Particle(particle.prob * prob, child_ns,
                                              target_line, done))

                if op_name == "cjmp":
                    taken = ops._mark_line(ns, lines, line_num, tokens[1])
                    if p_true > 0:
                        _spawn(p_true, taken, clone=p_false > 0,
                               prev_jump=line_num)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                elif op_name == "halt":
                    if p_true > 0:
                        _spawn(p_true, line_num + 1, clone=p_false > 0,
                               done=True)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                else:  # retr
                    if p_true > 0:
                        _spawn(p_true, ns["__prev_jump"] + 1,
                               clone=p_false > 0)
                    if p_false > 0:
                        _spawn(p_false, line_num + 1, clone=False)
                return children
            if not isinstance(cond, bool):
                got = type(cond).__name__
                raise err.type_error(lines, line_num, ["bool"], got)
            if op_name == "cjmp":
                target = ops._mark_line(ns, lines, line_num, tokens[1])
                if cond:
                    ns["__prev_jump"] = line_num
                    line_num = target - 1
                continue
            if op_name == "halt":
                if cond:
                    break
                continue
            # retr
            if cond:
                line_num = ns["__prev_jump"]
            continue

        result = op(ns, lines, line_num, tokens)
        if result is None:
            continue
        if result.halt:
            break
        if result.jump_line is not None:
            line_num = result.jump_line - 1

    particle.done = True
    return [particle]


def _merge_particles(particles: list[_Particle]) -> dict:
    total = sum(p.prob for p in particles)
    weights = [p.prob / total for p in particles]
    merged: dict = {}
    keys: list[str] = []
    for p in particles:
        for k in p.ns:
            if k not in keys:
                keys.append(k)
    for key in keys:
        if key.startswith("__"):
            merged[key] = particles[0].ns.get(key)
            continue
        is_quantum = any(p.ns.get(f"__is_q_{key}") for p in particles)
        values = [p.ns.get(key) for p in particles]
        if is_quantum and all(v is not None for v in values):
            shapes = {np.asarray(v).shape for v in values}
            if len(shapes) == 1:
                merged[key] = mix_densities(weights, values)
                merged[f"__is_q_{key}"] = True
                continue
            # branch registers of different sizes stay branch-valued
        merged[key] = ProbVal.from_unzipped(list(weights), values)
        merged[f"__is_q_{key}"] = False
    return merged


def execute_lines_ensemble(lines: list[str],
                           max_particles: int = MAX_PARTICLES
                           ) -> EnsembleResult:
    ns = {
        "state": empty_state(),
        "__updated_state": False,
        "__marks": {},
        "__prev_jump": -1,
    }
    record_marks(ns, lines)

    live = [_Particle(1.0, ns, 0)]
    finished: list[_Particle] = []
    while live:
        particle = live.pop()
        children = _step_particle(particle, lines, max_particles)
        for c in children:
            (finished if c.done else live).append(c)
        if len(live) + len(finished) > max_particles:
            raise RuntimeError(
                f"probabilistic branching exceeded {max_particles} particles; "
                f"raise max_particles or use the SMC ensemble runner")

    merged = _merge_particles(finished)
    return EnsembleResult(
        merged,
        [p.prob for p in finished],
        [p.ns for p in finished],
    )


def executeTxtEnsemble(text: str,
                       max_particles: int = MAX_PARTICLES) -> dict:
    """Execute .qb source with probabilistic control flow enabled.

    Returns the merged namespace (same observable contract as
    ``executeTxt``); the full branch structure is available via
    :func:`execute_lines_ensemble`.
    """
    return execute_lines_ensemble(text.splitlines(), max_particles).namespace
