"""Prebuilt models (counterpart of ``rxinfer_tpu/models/zoo.py``; the
Beta-Bernoulli model, the linear-Gaussian state-space model, the Gaussian
with unknown mean and precision and the hidden Markov model are
ported)."""

from __future__ import annotations

import numpy as np

from ..graph import dsl as rx


def beta_bernoulli(a: float = 1.0, b: float = 1.0):
    @rx.model
    def beta_bernoulli(y):
        theta = rx.Beta(a, b)
        for i in rx.plate(len(y)):
            y[i] = rx.Bernoulli(theta)
        return {"theta": theta}

    return beta_bernoulli


def lgssm(A, Q, B, R, m0, V0):
    """Linear multivariate Gaussian state-space model (smoothing form)."""
    A, Q, B, R = map(np.asarray, (A, Q, B, R))

    @rx.model
    def lgssm(y):
        T = len(y)
        x = rx.latent(T, name="x")
        x[0] = rx.MvNormal(mean=np.asarray(m0, np.float32),
                           cov=np.asarray(V0, np.float32))
        for t in rx.plate(1, T):
            x[t] = rx.MvNormal(mean=A @ x[t - 1], cov=Q)
        for t in rx.plate(T):
            y[t] = rx.MvNormal(mean=B @ x[t], cov=R)
        return {"x": x}

    return lgssm


def gaussian_unknown_mean_precision(m0=0.0, v0=100.0, a0=0.01, b0=0.01):
    @rx.model
    def gauss(y):
        mu = rx.Normal(mean=m0, var=v0)
        tau = rx.Gamma(shape=a0, rate=b0)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=mu, precision=tau)
        return {"mu": mu, "tau": tau}

    return gauss


def hmm(k: int, m: int):
    """Hidden Markov model with Dirichlet-Categorical transitions/emissions."""

    @rx.model
    def hmm(y):
        T = len(y)
        A = rx.DirichletCollection(np.ones((k, k), dtype=np.float32))
        B = rx.DirichletCollection(np.ones((m, k), dtype=np.float32))
        s = rx.latent(T, name="s")
        s[0] = rx.Categorical(np.ones(k, dtype=np.float32) / k)
        for t in rx.plate(1, T):
            s[t] = rx.Transition(s[t - 1], A)
        for t in rx.plate(T):
            y[t] = rx.Transition(s[t], B)
        return {"A": A, "B": B, "s": s}

    return hmm
