"""Prebuilt models (counterpart of ``rxinfer_tpu/models/zoo.py``; the
Beta-Bernoulli model, the linear-Gaussian state-space model, the one-step
Kalman filter of the streaming engine, the Gaussian with unknown mean and
precision, the Gaussian mixture, the hidden Markov model, the hierarchical
Gaussian filter, the latent autoregressive model and the linear regression
are ported)."""

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


def kalman_filter_step(A, Q, B, R):
    """One-step streaming model and its autoupdates (the filtering form):
    ``step`` observes y under the prior N(pm, pc); ``make_autoupdates(m0,
    V0)`` predicts the next prior, pm = A m, pc = A V A^T + Q.  The
    mappings receive the posteriors as torch tensors on the engine's
    device."""
    import torch

    from ..inference_streaming import autoupdates as _au

    A, Q, B, R = map(np.asarray, (A, Q, B, R))

    @rx.model
    def step(y, pm, pc):
        x = rx.MvNormal(mean=pm, cov=pc)
        y.observe(rx.MvNormal(mean=B @ x, cov=R))
        return {"x": x}

    def make_autoupdates(m0, V0):
        def t(a, like):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=like.device)

        return _au(
            initial={"pm": np.asarray(m0, np.float32),
                     "pc": np.asarray(V0, np.float32)},
            pm=lambda q: q["x"].mean() @ t(A, q["x"].mean()).T,
            pc=lambda q: (t(A, q["x"].cov()) @ q["x"].cov()
                          @ t(A, q["x"].cov()).T + t(Q, q["x"].cov())),
        )

    return step, make_autoupdates


def gaussian_unknown_mean_precision(m0=0.0, v0=100.0, a0=0.01, b0=0.01):
    @rx.model
    def gauss(y):
        mu = rx.Normal(mean=m0, var=v0)
        tau = rx.Gamma(shape=a0, rate=b0)
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=mu, precision=tau)
        return {"mu": mu, "tau": tau}

    return gauss


def gmm(k: int, mean_locs, mean_var: float = 100.0):
    """Univariate Gaussian mixture with k components."""

    @rx.model
    def gmm(y):
        n = len(y)
        pi = rx.Dirichlet(np.ones(k, dtype=np.float32))
        ms, ws = [], []
        for i in range(k):
            ms.append(rx.Normal(mean=float(mean_locs[i]), var=mean_var))
            ws.append(rx.Gamma(shape=0.01, rate=0.01))
        z = rx.latent(n, name="z")
        for i in rx.plate(n):
            z[i] = rx.Categorical(pi)
            y[i] = rx.NormalMixture(z[i], tuple(ms), tuple(ws))
        return {"pi": pi, "z": z,
                **{f"m{i}": ms[i] for i in range(k)},
                **{f"w{i}": ws[i] for i in range(k)}}

    return gmm


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


def hgf(kappa: float = 1.0, omega: float = -2.0, z_var: float = 0.01,
        obs_var: float = 0.01):
    """Two-level hierarchical Gaussian filter."""

    @rx.model
    def hgf(y):
        T = len(y)
        z = rx.latent(T, name="z")
        x = rx.latent(T, name="x")
        z[0] = rx.Normal(mean=0.0, var=1.0)
        x[0] = rx.Normal(mean=0.0, var=1.0)
        for t in rx.plate(1, T):
            z[t] = rx.Normal(mean=z[t - 1], var=z_var)
            x[t] = rx.GCV(x[t - 1], z[t], kappa=kappa, omega=omega)
        for t in rx.plate(T):
            y[t] = rx.Normal(mean=x[t], var=obs_var)
        return {"z": z, "x": x}

    return hgf


def latent_ar(order: int, obs_var: float = 0.09):
    """Latent autoregressive model with unknown coefficients/precision."""
    e1 = np.zeros(order, dtype=np.float32)
    e1[0] = 1.0

    @rx.model
    def latent_ar(y):
        T = len(y)
        theta = rx.MvNormal(mean=np.zeros(order, np.float32),
                            cov=np.float32(np.eye(order)))
        gamma = rx.Gamma(shape=1.0, rate=1.0)
        s = rx.latent(T, name="s")
        s[0] = rx.MvNormal(mean=np.zeros(order, np.float32),
                           cov=10.0 * np.float32(np.eye(order)))
        for t in rx.plate(1, T):
            s[t] = rx.AR(s[t - 1], theta, gamma, order=order)
        for t in rx.plate(T):
            y[t] = rx.Normal(mean=rx.dot(e1, s[t]), var=obs_var)
        return {"theta": theta, "gamma": gamma, "s": s}

    return latent_ar


def linear_regression(d: int, noise_var: float = 1.0,
                      prior_var: float = 100.0):
    @rx.model
    def linreg(phi, y):
        theta = rx.MvNormal(mean=np.zeros(d, np.float32),
                            cov=prior_var * np.eye(d, dtype=np.float32))
        for i in rx.plate(len(y)):
            y[i] = rx.Normal(mean=rx.dot(phi[i], theta), var=noise_var)
        return {"theta": theta}

    return linreg
