"""``options={"matmul_precision": ...}`` (ROADMAP A6g(i)) and the delta
rules' float32 pin on the CPU: every name the JAX package accepts is
accepted and mapped onto ``torch.set_float32_matmul_precision`` for the
call, the caller's setting comes back after it (after an exception too),
an unknown name raises, a program without the option computes what it
computed before, and ``rulefallback`` still raises."""

import numpy as np
import pytest
import torch

import rxinfer_tpu_torch as trx
from rxinfer_tpu_torch.engine import compile as tcompile
from rxinfer_tpu_torch.models import zoo
from rxinfer_tpu_torch.rules import delta as tdelta

CPU = torch.device("cpu")

# the JAX package's names (jax.default_matmul_precision) and torch's
MAPPING = {"highest": "highest", "float32": "highest", "high": "high",
           "tensorfloat32": "high", "bfloat16": "medium"}


@pytest.fixture(autouse=True)
def _restore_precision():
    prev = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(prev)


def lgssm_data(b=2, t_len=12, d=2, seed=0):
    rng = np.random.default_rng(seed)
    a = np.eye(d, dtype=np.float32)
    q = 0.1 * np.eye(d, dtype=np.float32)
    h = np.eye(d, dtype=np.float32)
    r = 0.5 * np.eye(d, dtype=np.float32)
    y = rng.standard_normal((b, t_len, d)).astype(np.float32)
    return zoo.lgssm(a, q, h, r, np.zeros(d, np.float32),
                     10.0 * np.eye(d, dtype=np.float32)), {"y": y}


@pytest.mark.parametrize("name", sorted(MAPPING) + ["default"])
def test_scope_maps_the_jax_names_and_restores(name):
    torch.set_float32_matmul_precision("highest")
    seen = []
    scope = tcompile.matmul_precision_scope(name)
    with scope:
        seen.append(torch.get_float32_matmul_precision())
    assert seen == [MAPPING.get(name, "highest")]
    assert torch.get_float32_matmul_precision() == "highest"
    torch.set_float32_matmul_precision("medium")
    with pytest.raises(KeyError):
        with scope:
            raise KeyError("inside")
    assert torch.get_float32_matmul_precision() == "medium"


def test_unknown_name_raises():
    model, data = lgssm_data()
    with pytest.raises(ValueError, match="matmul_precision"):
        trx.batched_program(model, data, device=CPU,
                            options={"matmul_precision": "float64"})


@pytest.mark.parametrize("name", sorted(MAPPING))
@pytest.mark.parametrize("entry", ["batched", "infer"])
def test_program_runs_under_the_option(name, entry, monkeypatch):
    """The setting holds during the program's sweeps, on both entry
    points, and the caller's setting is back afterwards, also when a sweep
    raises."""
    torch.set_float32_matmul_precision("highest")
    model, data = lgssm_data()
    seen = []
    sweep = tcompile.CompiledModel._sweep_once

    def spy(self, *args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        return sweep(self, *args, **kwargs)

    monkeypatch.setattr(tcompile.CompiledModel, "_sweep_once", spy)
    opts = {"matmul_precision": name, "fused_kernels": False}
    if entry == "batched":
        trx.infer_batched(model, data, iterations=2, device=CPU,
                          options=opts)
    else:
        trx.infer(model=model, data={"y": data["y"][0]}, iterations=2,
                  options=opts, device=CPU)
    assert seen and set(seen) == {MAPPING[name]}
    assert torch.get_float32_matmul_precision() == "highest"

    def failing(self, *args, **kwargs):
        raise FloatingPointError("sweep")

    monkeypatch.setattr(tcompile.CompiledModel, "_sweep_once", failing)
    with pytest.raises(FloatingPointError):
        trx.infer_batched(model, data, iterations=2, device=CPU,
                          options=opts)
    assert torch.get_float32_matmul_precision() == "highest"


def test_without_the_option_nothing_changes():
    """No option, None and "default" give the same program (unwrapped) and
    the same numbers, bit for bit; "highest" on the CPU too, where the
    float32 matmuls are full precision anyway."""
    model, data = lgssm_data(seed=3)
    outs = []
    for options in (None, {"matmul_precision": None},
                    {"matmul_precision": "default"},
                    {"matmul_precision": "highest"}):
        compiled, prog = trx.batched_program(model, data, iterations=3,
                                             free_energy=True, device=CPU,
                                             options=options)
        if options is None or options["matmul_precision"] in (None,
                                                              "default"):
            assert compiled.matmul_precision.setting is None
        outs.append(prog(data))
    for state, fe, _ in outs[1:]:
        assert torch.equal(state["x"].mean(), outs[0][0]["x"].mean())
        assert torch.equal(state["x"].cov(), outs[0][0]["x"].cov())
        assert torch.equal(fe, outs[0][1])


def test_rulefallback_still_raises():
    """``rulefallback`` runs since ROADMAP A6g with a
    ``NodeFunctionRuleFallback`` (tests/test_torch_constraints.py); anything
    else raises."""
    model, data = lgssm_data()
    with pytest.raises(TypeError, match="rulefallback"):
        trx.batched_program(model, data, device=CPU,
                            options={"rulefallback": object()})


def test_delta_rules_pin_full_precision_and_restore():
    """A delta rule runs its matmuls at "highest" and gives the caller's
    setting back, also when its function raises."""
    torch.set_float32_matmul_precision("medium")
    seen = []

    def fn(x):
        seen.append(torch.get_float32_matmul_precision())
        return torch.sin(x)

    q = {"in0": trx.NormalMeanVariance(torch.tensor([0.1, 0.2]),
                                       torch.tensor([1.0, 2.0])),
         "_meta": {"fn": fn, "method": tdelta.Linearization()}}
    tdelta.DeltaNode.message_to_out(q)
    assert seen and set(seen) == {"highest"}
    assert torch.get_float32_matmul_precision() == "medium"

    def bad(x):
        raise ArithmeticError("fn")

    q["_meta"]["fn"] = bad
    with pytest.raises(ArithmeticError):
        tdelta.DeltaNode.message_to_out(q)
    assert torch.get_float32_matmul_precision() == "medium"
