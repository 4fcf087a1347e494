"""``rxinfer_tpu_torch.infer`` against ``rxinfer_tpu.infer`` on the CPU: the
single-dataset engine on ``zoo.lgssm`` (BASELINE config 1's shape, d = 2,
T = 1000, which takes the associative-scan smoother, and T = 30, which takes
the sequential one) and ``zoo.hmm(3, 3)``; the reference's ``returnvars`` /
``predictvars`` defaults, a dict ``returnvars``, ``UnfactorizedData``,
``catch_exception``, callbacks, the program cache and the arguments that are
not ported yet; and ``infer_batched(predictvars=)``.  Inputs come from numpy
seeds and cross between the packages as numpy."""

import numpy as np
import pytest
import torch

import rxinfer_tpu as jrx
import rxinfer_tpu_torch as trx
from rxinfer_tpu.models import zoo as jzoo
from rxinfer_tpu_torch.models import zoo as tzoo
from rxinfer_tpu_torch.ops import fused_fb, fused_smoother

# posterior parity of two float32 engines on one algebra
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lgssm_constants(d=2):
    """BASELINE config 1: a slow rotation observed through 1.3 I."""
    th = np.pi / 35
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    a = np.kron(np.eye(d // 2, dtype=np.float32), rot)
    eye = np.eye(d, dtype=np.float32)
    return a, eye, 1.3 * eye, eye, np.zeros(d, np.float32), 25.0 * eye


def lgssm_data(t_len, seed, d=2):
    return np.random.default_rng(seed).standard_normal((t_len, d)).astype(
        np.float32)


def hmm_data(t_len, seed):
    idx = np.random.default_rng(seed).integers(0, 3, t_len)
    return np.eye(3, dtype=np.float32)[idx]


def hmm_init(rx):
    return {"A": rx.DirichletCollection(np.ones((3, 3), np.float32)),
            "B": rx.DirichletCollection(np.float32(np.eye(3) * 5.0 + 1.0))}


def assert_gauss_close(got, want):
    np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()),
                               **TOL)
    np.testing.assert_allclose(got.cov().numpy(), np.asarray(want.cov()),
                               **TOL)


def assert_hmm_close(got, want):
    np.testing.assert_allclose(got["s"].probs().numpy(),
                               np.asarray(want["s"].probs()), **TOL)
    for n in ("A", "B"):
        np.testing.assert_allclose(got[n].alpha.numpy(),
                                   np.asarray(want[n].alpha), **TOL)


# -- the engine against JAX ------------------------------------------------------

@pytest.mark.parametrize("t_len", [30, 1000])
def test_infer_matches_jax_on_lgssm(t_len):
    c = lgssm_constants()
    y = lgssm_data(t_len, seed=t_len)
    before = {**fused_smoother.LAUNCHES, **fused_fb.LAUNCHES}
    jres = jrx.infer(model=jzoo.lgssm(*c), data={"y": y})
    tres = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=CPU)
    assert isinstance(tres, trx.InferenceResult)
    assert tres.free_energy is None and tres.predictions == {}
    tx = tres.posteriors["x"]
    assert type(tx).__name__ == "MvNormalMeanCovariance"
    assert tuple(tx.mean().shape) == (t_len, 2)
    assert_gauss_close(tx, jres.posteriors["x"])
    # the single-dataset path never reaches a fused kernel, plain or not
    assert {**fused_smoother.LAUNCHES, **fused_fb.LAUNCHES} == before
    with pytest.raises(ValueError, match="single-dataset path"):
        tres.model.plan_report()


@pytest.mark.parametrize("parallel", [True, False])
def test_infer_matches_jax_on_hmm(parallel):
    y = hmm_data(60, seed=4)
    opts = {"parallel_scans": parallel}
    jres = jrx.infer(model=jzoo.hmm(3, 3), data={"y": y}, iterations=5,
                     initialization=hmm_init(jrx), options=opts)
    tres = trx.infer(tzoo.hmm(3, 3), data={"y": y}, iterations=5,
                     initialization=hmm_init(trx), options=opts, device=CPU)
    # iterations given: KeepEach, one posterior per iteration
    for name in ("s", "A", "B"):
        assert len(tres.posteriors[name]) == len(jres.posteriors[name]) == 5
    for i in range(5):
        assert_hmm_close({n: tres.posteriors[n][i] for n in ("s", "A", "B")},
                         {n: jres.posteriors[n][i] for n in ("s", "A", "B")})


def test_infer_with_missing_observations_matches_jax():
    """NaN steps carry no evidence; their predictions are derived by
    default (KeepLast: iterations not given)."""
    c = lgssm_constants()
    y = lgssm_data(80, seed=8)
    y[np.random.default_rng(9).random(80) < 0.15] = np.nan
    jres = jrx.infer(model=jzoo.lgssm(*c), data={"y": y})
    tres = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=CPU)
    assert_gauss_close(tres.posteriors["x"], jres.posteriors["x"])
    assert set(tres.predictions) == set(jres.predictions) == {"y"}
    assert_gauss_close(tres.predictions["y"], jres.predictions["y"])


# -- the reference's defaults and options ------------------------------------------

def test_returnvars_and_predictvars_defaults_match_jax():
    c = lgssm_constants()
    y = lgssm_data(20, seed=2)
    y[[3, 11]] = np.nan
    for kwargs in ({}, {"iterations": 3}, {"returnvars": jrx.KeepLast()},
                   {"iterations": 2, "predictvars": {"y": jrx.KeepLast()}}):
        tkw = {k: (getattr(trx, type(v).__name__)() if k == "returnvars"
                   else {n: getattr(trx, type(o).__name__)()
                         for n, o in v.items()} if k == "predictvars" else v)
               for k, v in kwargs.items()}
        jres = jrx.infer(model=jzoo.lgssm(*c), data={"y": y}, **kwargs)
        tres = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=CPU, **tkw)
        for got, want in ((tres.posteriors["x"], jres.posteriors["x"]),
                          (tres.predictions["y"], jres.predictions["y"])):
            assert isinstance(got, list) == isinstance(want, list), kwargs
            if isinstance(want, list):
                assert len(got) == len(want)
                got, want = got[-1], want[-1]
            assert_gauss_close(got, want)


def test_returnvars_dict_selects_and_warns_on_unknown_names():
    y = hmm_data(30, seed=5)
    rv = {"s": "last", "A": "each", "nope": "last"}
    mk = lambda rx: {k: rx.KeepLast() if v == "last" else rx.KeepEach()
                     for k, v in rv.items()}
    with pytest.warns(UserWarning, match="unknown variables"):
        jres = jrx.infer(model=jzoo.hmm(3, 3), data={"y": y}, iterations=3,
                         initialization=hmm_init(jrx), returnvars=mk(jrx))
    with pytest.warns(UserWarning, match="unknown variables"):
        tres = trx.infer(tzoo.hmm(3, 3), data={"y": y}, iterations=3,
                         initialization=hmm_init(trx), returnvars=mk(trx),
                         device=CPU)
    assert set(tres.posteriors) == set(jres.posteriors) == {"s", "A"}
    assert not isinstance(tres.posteriors["s"], list)
    assert len(tres.posteriors["A"]) == len(jres.posteriors["A"]) == 3
    np.testing.assert_allclose(tres.posteriors["A"][1].alpha.numpy(),
                               np.asarray(jres.posteriors["A"][1].alpha),
                               **TOL)


def test_unfactorized_data_takes_the_structured_prediction():
    y = hmm_data(40, seed=6)
    y[[5, 6, 30]] = np.nan
    preds = {}
    for label, rx, zoo, extra in (("jax", jrx, jzoo, {}),
                                  ("torch", trx, tzoo, {"device": CPU})):
        for wrap in (False, True):
            data = {"y": rx.UnfactorizedData(y) if wrap else y}
            res = rx.infer(zoo.hmm(3, 3), data=data, iterations=4,
                           initialization=hmm_init(rx), **extra)
            preds[label, wrap] = res.predictions["y"][-1].probs()
    for wrap in (False, True):
        np.testing.assert_allclose(np.asarray(preds["torch", wrap]),
                                   np.asarray(preds["jax", wrap]), **TOL)
    # the structured message marginalizes the node exactly: it differs from
    # the mean-field one
    assert not np.allclose(np.asarray(preds["torch", True]),
                           np.asarray(preds["torch", False]), atol=1e-3)


def test_catch_exception_matches_jax():
    y = lgssm_data(10, seed=1)
    c = lgssm_constants()
    results = []
    for rx, zoo, extra in ((jrx, jzoo, {}), (trx, tzoo, {"device": CPU})):
        init = {"nope": rx.MvNormalMeanCovariance(np.zeros(2, np.float32),
                                                  np.eye(2, dtype=np.float32))}
        with pytest.raises(ValueError, match="unknown variables"):
            rx.infer(zoo.lgssm(*c), data={"y": y}, initialization=init,
                     **extra)
        res = rx.infer(zoo.lgssm(*c), data={"y": y}, initialization=init,
                       catch_exception=True, **extra)
        results.append(res)
        assert rx.iserror(res) and not rx.issuccess(res)
        assert res.posteriors == {} and res.predictions == {}
        assert "unknown variables" in res.traceback
    assert type(results[0].error) is type(results[1].error)
    ok = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=CPU,
                   catch_exception=True)
    assert trx.issuccess(ok) and not trx.iserror(ok)


def test_callbacks_fire_in_the_reference_order():
    y = lgssm_data(12, seed=3)
    c = lgssm_constants()
    seen = {}
    for label, rx, zoo, extra in (("jax", jrx, jzoo, {}),
                                  ("torch", trx, tzoo, {"device": CPU})):
        names = []
        stop_at_two = lambda ev: setattr(ev, "stop_iteration",
                                         ev.payload["iteration"] == 1)
        res = rx.infer(zoo.lgssm(*c), data={"y": y}, iterations=5,
                       callbacks={"before_iteration": lambda ev: names.append(
                           ev.name), "after_iteration": stop_at_two},
                       benchmark=True, trace=True, **extra)
        seen[label] = (names, [e.name for e in res.trace.traced()],
                       sorted(res.benchmark.stats()), len(res.posteriors["x"]))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][3] == 2     # stopped after the second iteration


def test_showprogress_writes_a_bar(capsys):
    c = lgssm_constants()
    trx.infer(tzoo.lgssm(*c), data={"y": lgssm_data(8, seed=1)},
              iterations=3, showprogress=True, device=CPU)
    assert "3/3" in capsys.readouterr().err


def test_programs_are_cached_by_shape_and_bound_values():
    c = lgssm_constants()
    y = lgssm_data(16, seed=4)
    model = tzoo.lgssm(*c)
    first = trx.infer(model, data={"y": y}, device=CPU).model
    assert trx.infer(model, data={"y": y + 1}, device=CPU).model is first
    other = trx.infer(model, data={"y": lgssm_data(17, seed=4)}, device=CPU)
    assert other.model is not first
    assert trx.getreturnval(first) is not None
    assert set(trx.getreturnval(first)) == {"x"}


@pytest.mark.parametrize("kwargs,item", [
    ({"free_energy": True}, "A2"),
    ({"annotations": object()}, "A2/A4"),
    ({"datastream": object()}, "A5"),
    ({"mesh": object()}, "A7"),
    ({"constraints": object()}, "A6"),
    ({"meta": {"MvNormalMeanCovariance": {}}}, "A6"),
    ({"postprocess": object()}, "A6"),
])
def test_unported_infer_arguments_raise_with_their_roadmap_item(kwargs, item):
    c = lgssm_constants()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        trx.infer(tzoo.lgssm(*c), data={"y": lgssm_data(6, seed=0)},
                  device=CPU, **kwargs)


def test_infer_needs_a_device_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = lgssm_constants()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trx.infer(tzoo.lgssm(*c), data={"y": lgssm_data(6, seed=0)})


# -- infer_batched(predictvars=) ---------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_infer_batched_predictvars_match_jax(fused):
    c = lgssm_constants()
    y = np.random.default_rng(12).standard_normal((3, 25, 2)).astype(
        np.float32)
    y[:, [4, 17]] = np.nan
    opts = {"fused_kernels": fused}
    jres = jrx.infer_batched(jzoo.lgssm(*c), {"y": y}, predictvars=["y"],
                             options=opts)
    tres = trx.infer_batched(tzoo.lgssm(*c), {"y": y}, predictvars=["y"],
                             options=opts, device=CPU)
    got, want = tres.predictions["y"], jres.predictions["y"]
    assert tuple(got.mean().shape) == (3, 25, 2)
    assert_gauss_close(got, want)
    assert_gauss_close(tres.posteriors["x"], jres.posteriors["x"])


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: infer runs its scans on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_infer_on_the_card_equals_infer_on_the_cpu(cuda_device):
    c = lgssm_constants()
    y = lgssm_data(500, seed=21)
    cpu = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=CPU)
    gpu = trx.infer(tzoo.lgssm(*c), data={"y": y}, device=cuda_device)
    np.testing.assert_allclose(gpu.posteriors["x"].mean().cpu().numpy(),
                               cpu.posteriors["x"].mean().numpy(), **TOL)
    np.testing.assert_allclose(gpu.posteriors["x"].cov().cpu().numpy(),
                               cpu.posteriors["x"].cov().numpy(), **TOL)
    yh = hmm_data(200, seed=22)
    kw = dict(data={"y": yh}, initialization=hmm_init(trx),
              returnvars=trx.KeepLast(), iterations=5)
    cpu = trx.infer(tzoo.hmm(3, 3), device=CPU, **kw).posteriors
    gpu = trx.infer(tzoo.hmm(3, 3), device=cuda_device, **kw).posteriors
    np.testing.assert_allclose(gpu["s"].probs().cpu().numpy(),
                               cpu["s"].probs().numpy(), **TOL)
    for n in ("A", "B"):
        np.testing.assert_allclose(gpu[n].alpha.cpu().numpy(),
                                   cpu[n].alpha.numpy(), **TOL)
