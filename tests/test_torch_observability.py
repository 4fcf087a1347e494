"""Sessions, telemetry, checkpoints, the callbacks' tables and exports,
early stopping, ``profile_trace`` and ``trace_messages`` (ROADMAP A6h)
through both packages on the CPU: the session, checkpoint, TensorBoard,
``benchmark_table``, early-stopping and ``trace_messages`` cases of
tests/inference/test_observability.py, each held against the JAX package.
Inputs come from numpy seeds; the port runs with ``device="cpu"``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu.utils.callbacks import (
    StopEarlyIterationStrategy as JStopEarly,
)
from rxinfer_tpu.utils.checkpoint import (
    load_checkpoint as jload,
    save_checkpoint as jsave,
)
from rxinfer_tpu.utils.session import get_default_session as jdefault
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.utils import telemetry
from rxinfer_tpu_torch.utils.session import get_default_session as tdefault

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dev(rx):
    return {} if rx is jrx else {"device": CPU}


def _tau0(rx):
    return (jd.GammaShapeRate(1.0, 1.0) if rx is jrx
            else td.GammaShapeRate(torch.tensor(1.0), torch.tensor(1.0)))


def _gauss_y():
    rng = np.random.default_rng(0)
    return (2.0 + 0.7 * rng.standard_normal(100)).astype(np.float32)


def _gauss(rx, **kw):
    zoo = jzoo if rx is jrx else tzoo
    return rx.infer(model=zoo.gaussian_unknown_mean_precision(),
                    data={"y": _gauss_y()}, returnvars=rx.KeepLast(),
                    initialization={"tau": _tau0(rx)}, **kw, **_dev(rx))


def _coin(rx):
    @rx.model
    def coin(y):
        theta = rx.Beta(1.0, 1.0)
        for i in rx.plate(len(y)):
            y[i] = rx.Bernoulli(theta)
        return {"theta": theta}

    return coin


COIN_Y = np.array([1.0, 0.0, 1.0], np.float32)


# -- sessions and telemetry -----------------------------------------------------------

def test_sessions_log_as_in_jax(tmp_path):
    counts = {}
    for rx, default in ((jrx, jdefault), (trx, tdefault)):
        before = default().get_session_stats("inference").total
        _gauss(rx, iterations=1)
        counts[rx] = default().get_session_stats("inference").total - before
        assert "inference" in rx.summarize_session()
        assert rx.summarize_session_table()
    assert counts[jrx] == counts[trx] == 1

    # a session of one's own, none, and a failed call
    own = trx.create_session()
    _gauss(trx, iterations=1, session=own)
    before = tdefault().get_session_stats("inference").total
    _gauss(trx, iterations=1, session=None)
    assert tdefault().get_session_stats("inference").total == before
    res = trx.infer(model=_coin(trx), data={"y": COIN_Y}, iterations=2,
                    initialization={"nope": _tau0(trx)}, session=own,
                    catch_exception=True, device=CPU)
    assert not trx.issuccess(res)
    stats = own.get_session_stats("inference")
    assert (stats.total, stats.failed) == (2, 1)
    last = stats.invokes[-1].to_dict()
    assert last["status"] == "failure" and "nope" in last["error"]
    assert own.summarize()["inference"]["failed"] == 1
    assert "inference" in trx.summarize_session_table(own)

    # session data and usage records to local files only
    shared = telemetry.share_session_data(own, str(tmp_path / "s.json"))
    with open(shared) as f:
        payload = json.load(f)
    assert [i["status"] for i in payload["stats"]["inference"]] == [
        "success", "failure"]
    endpoint = tmp_path / "usage.jsonl"
    telemetry.set_telemetry_endpoint(str(endpoint))
    try:
        telemetry.enable_telemetry(False)
        telemetry.log_using("import")
        assert not endpoint.exists()
        telemetry.enable_telemetry(True)
        telemetry.log_using("infer", {"model": "coin"})
    finally:
        telemetry.enable_telemetry(False)
        telemetry.set_telemetry_endpoint(None)
    lines = endpoint.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["model"] == "coin"


# -- checkpoints ----------------------------------------------------------------------

def test_checkpoint_roundtrip_matches_jax(tmp_path):
    res = {rx: _gauss(rx, iterations=5) for rx in (jrx, trx)}
    jsave(str(tmp_path / "j.pkl"), res[jrx].posteriors)
    jr = jload(str(tmp_path / "j.pkl"))
    trx.save_checkpoint(str(tmp_path / "t.pkl"), res[trx].posteriors)
    tr = trx.load_checkpoint(str(tmp_path / "t.pkl"))
    for k in ("mu", "tau"):
        np.testing.assert_allclose(_np(tr[k].mean()), _np(jr[k].mean()),
                                   **TOL)
        assert type(tr[k]) is type(res[trx].posteriors[k])
        assert torch.equal(tr[k].mean(), res[trx].posteriors[k].mean())
    assert float(tr["tau"].a) == float(res[trx].posteriors["tau"].a)


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_checkpoint_keeps_structure_dtypes_and_device(tmp_path, backend):
    """Dicts, lists, tuples, distributions, annotated posteriors and non-
    float tensors round-trip exactly; a directory (``"orbax"``) restores by
    its saved structure or by ``like=``."""
    state = {
        "x": td.MvNormalMeanCovariance(torch.randn(3, 2),
                                       torch.eye(2).expand(3, 2, 2) * 2.0),
        "args": [torch.arange(4), (torch.ones(2, dtype=torch.bfloat16),
                                   "tag", 7)],
        "m": trx.Marginal(td.Beta(torch.tensor(2.0), torch.tensor(3.0)),
                          {"log_scale": torch.tensor(-1.5)}),
    }
    path = str(tmp_path / ("ckpt" if backend == "orbax" else "ckpt.pkl"))
    trx.save_checkpoint(path, state, backend=backend)
    loads = [trx.load_checkpoint(path, device="cpu")]
    if backend == "orbax":
        assert os.path.isdir(path)
        loads.append(trx.load_checkpoint(path, like=state))
    for got in loads:
        assert torch.equal(got["x"].mu, state["x"].mu)
        assert torch.equal(got["x"].sigma, state["x"].sigma)
        assert got["args"][0].dtype == torch.int64
        assert torch.equal(got["args"][0], state["args"][0])
        assert got["args"][1][0].dtype == torch.bfloat16
        assert got["args"][1][1:] == ("tag", 7)
        assert isinstance(got["m"], trx.Marginal)
        assert float(trx.getlogscale(got["m"])) == -1.5
        assert float(got["m"].dist.b) == 3.0


# -- the callbacks' table, TensorBoard export and early stopping ----------------------

def test_benchmark_table_and_session_table():
    res = trx.infer(model=_coin(trx), data={"y": COIN_Y}, iterations=3,
                    returnvars=trx.KeepLast(), benchmark=True, device=CPU)
    table = trx.benchmark_table(res.benchmark)
    assert "stage" in table and "median ms" in table and "inference" in table
    assert trx.benchmark_table(trx.BenchmarkCallbacks()).startswith("(no")
    assert trx.summarize_session_table()


def _tensorboard_scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(logdir)
    acc.Reload()
    return [e.value for e in acc.Scalars("rxinfer/free_energy")]


def test_convert_to_tensorboard_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("tensorboard")
    if "tensorflow" not in sys.modules:
        # tensorboard takes its own stand-in for TensorFlow when TensorFlow
        # is not installed, as with most PyTorch installations; importing
        # TensorFlow itself takes tens of seconds here
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    scalars = {}
    for rx in (jrx, trx):
        res = rx.infer(model=_coin(rx), data={"y": COIN_Y}, iterations=3,
                       returnvars=rx.KeepLast(), trace=True, free_energy=True,
                       **_dev(rx))
        logdir = str(tmp_path / rx.__name__)
        rx.convert_to_tensorboard(res.trace, logdir)
        assert any("tfevents" in f for f in os.listdir(logdir))
        scalars[rx] = _tensorboard_scalars(logdir)
    assert len(scalars[trx]) == 3
    np.testing.assert_allclose(scalars[trx], scalars[jrx], **TOL)


def test_convert_to_tensorboard_names_the_missing_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="`tensorboard` package"):
        trx.convert_to_tensorboard(trx.TraceCallbacks(), "unused")


def test_early_stopping_stops_where_jax_stops():
    out = {}
    for rx, stop in ((jrx, JStopEarly), (trx, trx.StopEarlyIterationStrategy)):
        stopper = stop(atol=1e-4)
        count = []
        res = _gauss(rx, iterations=50, free_energy=True, callbacks={
            "after_iteration": lambda ev: (count.append(1), stopper(ev))[-1]})
        assert len(_np(res.free_energy)) == len(count)
        out[rx] = res
    assert len(out[trx].free_energy) == len(out[jrx].free_energy) < 25
    np.testing.assert_allclose(_np(out[trx].free_energy),
                               _np(out[jrx].free_energy), **TOL)
    np.testing.assert_allclose(_np(out[trx].posteriors["mu"].mean()),
                               _np(out[jrx].posteriors["mu"].mean()), **TOL)


# -- message tracing and the profiler -------------------------------------------------

@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_trace_messages_records_as_in_jax(iterations):
    """One record per rule dispatch in dispatch order.  The JAX package
    records while it traces a program: its first sweep and its scan body
    (one sweep for every later one), so from three sweeps on its list is
    the port's first two sweeps; the port records every sweep it runs."""
    recs = {}
    for rx in (jrx, trx):
        with rx.trace_messages() as mt:
            rx.infer(model=_coin(rx), data={"y": COIN_Y},
                     iterations=iterations, **_dev(rx))
        assert rx.trace_messages._active.get() is None
        recs[rx] = mt.records
    sweep = [{"node": "Beta", "interface": "out", "mean_field": False},
             {"node": "Bernoulli", "interface": "p", "mean_field": False}]
    assert recs[trx] == sweep * iterations
    assert recs[jrx] == sweep * min(iterations, 2)


def test_trace_messages_chain_records_and_nesting_match_jax():
    rng = np.random.default_rng(3)
    eye = np.eye(2, dtype=np.float32)
    y = rng.standard_normal((10, 2)).astype(np.float32)
    recs = {}
    for rx, zoo in ((jrx, jzoo), (trx, tzoo)):
        model = zoo.lgssm(eye, eye, eye, eye, np.zeros(2, np.float32), eye)
        with rx.trace_messages() as outer:
            with rx.trace_messages() as inner:
                rx.infer(model=model, data={"y": y}, iterations=2,
                         **_dev(rx))
            assert rx.trace_messages._active.get() is outer
        assert outer.records == []
        recs[rx] = inner.records
    assert recs[trx] == recs[jrx] == [
        {"node": "<chain:GaussianChainBlock>", "interface": "x",
         "mean_field": False}] * 2


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with trx.profile_trace(logdir) as pt:
        _gauss(trx, iterations=2)
    files = pt.trace_files()
    assert files
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert pt.profile.key_averages()
