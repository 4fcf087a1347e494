"""The streaming engine's ``meta=``, ``annotations=``, ``postprocess=``,
``session=`` and ``allow_node_contraction=`` (ROADMAP A4c, A6h) through
both packages on the CPU: the cases of
tests/inference/test_streaming_kwargs.py, the per-stream log-scale of a
batched engine against the closed-form log predictive, the fused stream
plan giving way to the generic tick under annotations, and a checkpointed
engine resumed bit for bit.  Inputs come from numpy seeds; the port runs
with ``device="cpu"``."""

import numpy as np
import pytest
import torch
from scipy.special import betaln

import chip_smoke as cs
import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu import dists as jd
from rxinfer_tpu.utils.session import get_default_session as jdefault
from rxinfer_tpu_torch import dists as td
from rxinfer_tpu_torch.models import zoo as tzoo
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


def _coin_step(rx):
    @rx.model
    def step(y, pa, pb):
        theta = rx.Beta(pa, pb)
        y.observe(rx.Bernoulli(theta))
        return {"theta": theta}

    return step


def _coin_au(rx, batch=None):
    ones = 1.0 if batch is None else np.ones(batch, np.float32)
    return rx.autoupdates(initial={"pa": ones, "pb": ones},
                          pa=lambda q: q["theta"].a,
                          pb=lambda q: q["theta"].b)


def _log_predictive(a, b, y):
    """log p(y | Beta(a, b) prior) of one Bernoulli draw, float64."""
    return betaln(a + y, b + 1.0 - y) - betaln(a, b)


def test_annotations_and_postprocess_match_jax():
    got = {}
    for rx in (jrx, trx):
        eng = rx.infer(model=_coin_step(rx), autoupdates=_coin_au(rx),
                       datastream=[{"y": np.float32(v)} for v in (1, 0, 1)],
                       free_energy=True,
                       annotations=rx.LogScaleAnnotations(), **_dev(rx))
        post = eng.posteriors["theta"]
        assert isinstance(post, rx.Marginal)
        got[rx] = (float(rx.getlogscale(post)), float(post.a),
                   float(post.b))
        eng2 = rx.infer(model=_coin_step(rx), autoupdates=_coin_au(rx),
                        datastream=[{"y": np.float32(1.0)}],
                        postprocess=lambda d: ("wrapped", d), **_dev(rx))
        tag, inner = eng2.posteriors["theta"]
        assert tag == "wrapped" and float(inner.a) == 2.0
    np.testing.assert_allclose(got[trx], got[jrx], **TOL)
    # the third tick's prior is Beta(2, 2) after (1, 0): log p(y=1) = log 1/2
    assert got[trx][0] == pytest.approx(np.log(0.5), abs=1e-6)


def test_batched_log_scale_is_per_stream_and_the_log_predictive():
    """In lockstep each stream's posterior carries minus its own tick's
    free energy, which for the conjugate coin is the log predictive of the
    tick's observation under the stream's prior."""
    b_n, t_len = 5, 6
    ys = (np.random.default_rng(7).uniform(size=(t_len, b_n)) < 0.4).astype(
        np.float32)
    seen = []
    eng = trx.infer(model=_coin_step(trx), autoupdates=_coin_au(trx, b_n),
                    datastream=[{"y": ys[t]} for t in range(t_len)],
                    batched=True, free_energy=True,
                    annotations=trx.LogScaleAnnotations(),
                    postprocess=lambda m: ("tick", m), device=CPU,
                    callbacks={"on_marginal_update":
                               lambda ev: seen.append(ev.payload)})
    assert len(seen) == t_len
    a = np.ones(b_n)
    b = np.ones(b_n)
    for t in range(t_len):
        tag, m = seen[t]["theta"]
        assert tag == "tick" and isinstance(m, trx.Marginal)
        scale = _np(trx.getlogscale(m))
        assert scale.shape == (b_n,)
        np.testing.assert_allclose(scale, _log_predictive(a, b, ys[t]),
                                   rtol=0, atol=1e-5)
        a, b = a + ys[t], b + 1.0 - ys[t]
    np.testing.assert_allclose(_np(eng.posteriors["theta"][1].a), a,
                               rtol=1e-6)


def test_annotations_turn_off_the_fused_stream_plan():
    """A batched ``run_offline`` with annotations takes the generic tick
    (the fused plan carries no free energy), as the JAX engine does; the
    posteriors are the plan's."""
    th = np.pi / 20
    a = np.float32([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    eye = np.eye(2, dtype=np.float32)
    step, make_au = tzoo.kalman_filter_step(a, 0.5 * eye, eye, eye)
    ys = np.random.default_rng(2).standard_normal((4, 3, 2)).astype(
        np.float32)
    m0 = np.zeros((3, 2), np.float32)
    v0 = np.broadcast_to(4 * eye, (3, 2, 2)).copy()
    out = {}
    for kind, kw in (("plan", {}),
                     ("generic", {"annotations": trx.LogScaleAnnotations()})):
        eng = trx.infer(model=step, autoupdates=make_au(m0, v0),
                        datastream=None, batched=True, device=CPU, **kw)
        posts, _ = eng.run_offline({"y": ys})
        out[kind] = (eng._stream_plan, posts["x"])
    assert out["plan"][0] and out["generic"][0] is None
    np.testing.assert_allclose(_np(out["generic"][1].mean()),
                               _np(out["plan"][1].mean()), rtol=1e-5,
                               atol=1e-5)


def _hgf_engine(rx, y, meta):
    dist = ((lambda m, v: jd.NormalMeanVariance(np.float32(m), np.float32(v)))
            if rx is jrx else
            (lambda m, v: td.NormalMeanVariance(torch.tensor(m),
                                                torch.tensor(v))))
    eng = rx.infer(model=cs.hgfs_model(rx), datastream=None, meta=meta,
                   **_dev(rx), **cs.hgfs_engine_kw(rx, y.shape[1], dist))
    posts, fes = eng.run_offline({"y": y})
    return eng, posts, fes


def test_meta_reaches_the_tick_as_in_jax():
    """``meta=`` reaches the tick's compiled model in both packages.  GCV
    damping blends a chain's evidence messages only: the online HGF's xt is
    a plain group, so the damped and undamped ticks agree in both packages,
    bit for bit in the port."""
    _, _, y = cs.hgfs_data(3, 6)
    meta = {"GCV": {"damping": 0.8}}
    res = {rx: _hgf_engine(rx, y, meta) for rx in (jrx, trx)}
    for rx, (eng, posts, fes) in res.items():
        gcv = [f for f in eng._compiled.graph.factors if f.fform == "GCV"]
        assert gcv and all(f.meta["damping"] == 0.8 for f in gcv)
    (_, jp, jfe), (_, tp, tfe) = res[jrx], res[trx]
    # the online HGF's tolerance (tests/test_torch_hgf_streaming.py): the
    # GCV pair feeds each sweep's float32 rounding to the next
    for n in ("xt", "zt"):
        np.testing.assert_allclose(_np(tp[n].mean()), _np(jp[n].mean()),
                                   rtol=1e-4, atol=1e-5)
    _, plain, plain_fe = _hgf_engine(trx, y, None)
    assert torch.equal(plain["xt"].mean(), tp["xt"].mean())
    assert torch.equal(plain_fe, tfe)


def test_streaming_sessions_log_as_in_jax():
    counts = {}
    for rx, default in ((jrx, jdefault), (trx, tdefault)):
        n0 = default().get_session_stats("streaming_inference").total
        rx.infer(model=_coin_step(rx), autoupdates=_coin_au(rx),
                 datastream=[{"y": np.float32(1.0)}], **_dev(rx))
        counts[rx] = default().get_session_stats(
            "streaming_inference").total - n0
    assert counts[jrx] == counts[trx] == 1
    own = trx.create_session()
    n0 = tdefault().get_session_stats("streaming_inference").total
    trx.infer(model=_coin_step(trx), autoupdates=_coin_au(trx),
              datastream=None, session=own, device=CPU)
    trx.infer(model=_coin_step(trx), autoupdates=_coin_au(trx),
              datastream=None, session=None, device=CPU)
    assert tdefault().get_session_stats("streaming_inference").total == n0
    rec = own.get_session_stats("streaming_inference").invokes[-1].to_dict()
    assert rec["status"] == "created" and rec["data_keys"] == ["pa", "pb"]


def test_streaming_node_contraction_and_mesh_refusal():
    @trx.submodel
    def Beta(a=None, b=None):       # noqa: N802 — a registered node's name
        raise AssertionError("a contracted submodel's body is not traced")

    @trx.model
    def step(y, pa, pb):
        theta = Beta(a=pa, b=pb)
        y.observe(trx.Bernoulli(theta))
        return {"theta": theta}

    eng = trx.infer(model=step, autoupdates=_coin_au(trx), datastream=[
        {"y": np.float32(1.0)}], allow_node_contraction=True, device=CPU)
    assert float(eng.posteriors["theta"].a) == 2.0
    with pytest.raises(NotImplementedError, match="A7b"):
        trx.infer(model=step, autoupdates=_coin_au(trx), datastream=None,
                  mesh=object(), device=CPU)


@pytest.mark.parametrize("batched_plan", [True, False])
def test_checkpointed_engine_resumes_bit_for_bit(tmp_path, batched_plan):
    """Stop after half the ticks, save the autoupdated arguments, load them
    into a fresh engine and run the rest: the same bits as one run."""
    th = np.pi / 20
    a = np.float32([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    eye = np.eye(2, dtype=np.float32)
    step, make_au = tzoo.kalman_filter_step(a, 0.5 * eye, eye, eye)
    ys = np.random.default_rng(4).standard_normal((8, 3, 2)).astype(
        np.float32)
    m0 = np.zeros((3, 2), np.float32)
    v0 = np.broadcast_to(4 * eye, (3, 2, 2)).copy()
    kw = dict(datastream=None, batched=True, device=CPU)
    if not batched_plan:
        kw["returnvars"] = ["x"]          # the generic tick
    whole = trx.infer(model=step, autoupdates=make_au(m0, v0), **kw)
    posts, _ = whole.run_offline({"y": ys})
    first = trx.infer(model=step, autoupdates=make_au(m0, v0), **kw)
    first.run_offline({"y": ys[:4]})
    path = str(tmp_path / "args.pkl")
    trx.save_checkpoint(path, first.args)
    args = trx.load_checkpoint(path, device="cpu")
    au = trx.autoupdates(initial=args, **make_au(m0, v0).mapping)
    second = trx.infer(model=step, autoupdates=au, **kw)
    rest, _ = second.run_offline({"y": ys[4:]})
    assert bool(second._stream_plan) == batched_plan
    assert torch.equal(rest["x"].mean(), posts["x"].mean()[4:])
    assert torch.equal(rest["x"].cov(), posts["x"].cov()[4:])
    for k in whole.args:
        assert torch.equal(second.args[k], whole.args[k])
