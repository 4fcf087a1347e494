"""Bethe free-energy assembly (counterpart of ``rxinfer_tpu/engine/bethe.py``).

    FE = sum_a E_{q_a}[-log f_a]  -  sum_a H[q_a]  +  sum_i (d_i - 1) H[q_i]

* q_a is the factor's local joint: the structured pair marginal of a chain
  transition (the Gaussian cross-covariance Cov(out, in), the discrete pair
  marginals), the product of its marginals otherwise (mean field).
* Observed and constant interfaces are point masses: their infinite
  entropies cancel between factor and variable, so they are left out and
  only finite terms are summed.
* A missing observation (NaN) removes its likelihood copy: the copy's
  average energy is masked, and its entropy terms cancel against the
  variable's degree.
* A deterministic node (Delta, Sum, LinComb) has no average energy: its
  term is -H of the joint belief over its inputs, from the cavity beliefs
  (``bethe_term``).
* An unplated Gaussian factor between two random variables (the four
  Gaussian nodes' (out, mean), the dot-product likelihood's and a
  contracted nonlinear Gaussian's (out, in)) takes its structured pair,
  rebuilt from the stored cavity messages (``gaussian_pair_fe``), and an
  unplated single-step GCV its pair q(out, in) with the cross
  ``attach_gcv_pair_cross`` rebuilds; a factor a factorization
  constraint splits (``mean_field``) takes the mean-field terms.
* On a tree at the BP fixed point FE equals -log Z.

Every term is evaluated over the whole batch at once (batch axis first, as
the blocks' updates are), not per dataset under a ``vmap``: a factor's
``FactorFE`` returns one value per batch element, (B,).

Ported: ``slot_degrees`` (an empty plate contributes no degree; the JAX
version divides by its size and raises ``ZeroDivisionError``),
``gaussian_pair_entropy``, ``discrete_pair_entropy``, ``gaussian_pair_fe``,
``FactorFE`` with the mean-field branch (average energy minus the entropies
of its random interfaces, the missing-data mask, the copy accounting of
plated factors), the structured pair branches above and the
chain-transition branch (Gaussian scalar and vector chains,
``DiscreteTransition``), and ``variable_entropy_term``.

One deliberate difference: a chain transition's local entropy is its pair
entropy plus, per copy, the entropies of its other random interfaces (a
random transition matrix, a random process-noise precision), as the
mean-field branch counts a shared interface.  The JAX version subtracts the
pair entropy alone, so on such a chain (``zoo.hmm``: the matrix A) its free
energy is off by (T - 1) H[q(A)] and can fall below zero on discrete data;
the port's equals the float64 structured-VMP free energy.

A nested-plate factor's energy stands for its whole copy grid, and a
single-axis neighbour's entropy enters once per copy along the grid's
other axes (``slot_degrees`` counts the same).  A user node's lagged
transition left to iterative message passing, whose (out, in) is one
cavity cluster, takes the affine custom-transition pair when its out rule
probes affine Gaussian (``_extract_affine_transition``): the pair joint
from the stored cavities, so that the free energy is -log Z on a tree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dists import PointMass
from ..dists.gaussian import batched_logdet
from ..graph.ir import Const, ModelGraph, Ref, SymIndex
from ..rules.registry import get_average_energy, get_node
from .blocks import (
    BatchContext,
    _coverage,
    _grid,
    build_q,
    in_cavity_cluster,
)

_LOG2PIE = 2.837877066409345  # log(2*pi*e)

# Gaussian factors whose (out, mean) pair is one cluster when both are
# random, with their noise interface
_GAUSS_PAIR_NOISE = {"NormalMeanVariance": "var",
                     "NormalMeanPrecision": "prec",
                     "MvNormalMeanCovariance": "cov",
                     "MvNormalMeanPrecision": "prec"}
# and the (out, in) pair of a dot-product likelihood
_DOT_PAIR = {"GaussianDotCovariance", "GaussianDotPrecision"}
# and of a contracted nonlinear Gaussian, out = fn(in) + noise
_NG_PAIR = {"NonlinearGaussianCovariance", "NonlinearGaussianPrecision"}


def _noise_expectations(q, noise_key: str, d: int):
    """(E[V^-1] as (..., d, d), E[log det V]) of a Gaussian factor's
    noise interface."""
    from ..dists.gaussian import pd_inverse, pd_logdet
    from ..rules.delta import _noise_rank
    from ..rules.expectations import (
        e_inv_scalar,
        e_inverse,
        e_log,
        e_log_precision,
        e_logdet,
        e_precision,
    )

    noise = q[noise_key]
    rank = _noise_rank(q, noise_key, d)
    if noise_key in ("var", "cov"):
        # a point mass, or a random InverseGamma / InverseWishart noise
        if rank == 0:
            return e_inv_scalar(noise)[..., None, None], e_log(noise)
        if isinstance(noise, PointMass):
            return pd_inverse(noise.point), pd_logdet(noise.point)
        return e_inverse(noise), e_logdet(noise)
    w = e_precision(noise)
    if rank == 0:
        elogw = (torch.log(noise.point) if isinstance(noise, PointMass)
                 else e_log_precision(noise))
        return w[..., None, None], -elogw
    elogw = (pd_logdet(noise.point) if isinstance(noise, PointMass)
             else e_logdet(noise))
    return w, -elogw


def _pair_map(f, q: dict, in_key: str, r_in: int, d_o: int, d_i: int,
              like):
    """The pair's observation map out = A in + b (+ noise) as (A (...,
    d_o, d_i), b (..., d_o)): a contracted nonlinear Gaussian's fn
    linearized at the input's mean, a dot-product node's known row, the
    identity for a Gaussian node's (out, mean) (on ``like``'s device and
    dtype)."""
    from ..rules.delta import _moments, _vmap_copies

    dev, dt = like.device, like.dtype
    fn = (f.meta or {}).get("fn")
    if fn is not None:
        m_i, _ = _moments(q[in_key], r_in)
        f0, _, a_mat = _vmap_copies(fn, m_i, [m_i.shape[-1]], [r_in >= 1],
                                    jacobian=True)
        return a_mat, f0 - torch.einsum("...ij,...j->...i", a_mat, m_i)
    if isinstance(q.get("A"), PointMass):
        a_mat = q["A"].point.reshape(q["A"].point.shape[:-1] + (d_o, d_i))
        b = q.get("b")
        b_vec = (b.point[..., None] if isinstance(b, PointMass)
                 else torch.zeros((d_o,), dtype=dt, device=dev))
        return a_mat, b_vec
    return (torch.eye(d_o, dtype=dt, device=dev),
            torch.zeros((d_o,), dtype=dt, device=dev))


def _cat_lead(parts, event_ndim: int, dim: int):
    """``torch.cat`` of tensors whose leading (batch) axes broadcast, their
    ``event_ndim`` trailing axes kept as they are (an out and an in block
    of different sizes)."""
    lead = torch.broadcast_shapes(*[p.shape[:p.ndim - event_ndim]
                                    for p in parts])
    return torch.cat([p.expand(lead + p.shape[p.ndim - event_ndim:])
                      for p in parts], dim=dim)


def gaussian_pair_fe(f, q: dict, state: dict, in_key: str, noise_key: str):
    """AE - H over the local joint q(out, in) of a Gaussian factor out =
    g(in) + noise, rebuilt from the cavity messages (the marginals divided
    by the factor's stored messages) with g affine or linearized at the
    input's mean (``_pair_map``): joint precision [[W_o + W, -W A],
    [-A^T W, W_i + A^T W A]].  Exact for an affine g: on a tree the free
    energy is then -log Z.  The noise's entropy stays mean-field (the
    reference's default constraints)."""
    from ..dists.natural import nat_div
    from ..ops.smallmat import small_inv, small_logdet
    from ..rules.delta import _info_form, _rank

    cav_out = nat_div(q["out"], state[f"_msg:{f.id}:out"])
    cav_in = nat_div(q[in_key], state[f"_msg:{f.id}:{in_key}"])
    r_in = _rank(q, in_key)
    xi_o, w_o = _info_form(cav_out, _rank(q, "out"))
    xi_i, w_i = _info_form(cav_in, r_in)
    d_o, d_i = xi_o.shape[-1], xi_i.shape[-1]
    a_mat, b_vec = _pair_map(f, q, in_key, r_in, d_o, d_i, xi_o)
    wbar, elogv = _noise_expectations(q, noise_key, d_o)
    wa = wbar @ a_mat
    at = a_mat.transpose(-1, -2)
    top = _cat_lead([w_o + wbar, -wa], 2, -1)
    bot = _cat_lead([-(at @ wbar), w_i + at @ wa], 2, -1)
    jmat = _cat_lead([top, bot], 2, -2)
    wb = torch.einsum("...ij,...j->...i", wbar, b_vec)
    xi = _cat_lead([xi_o + wb,
                    xi_i - torch.einsum("...ji,...j->...i", a_mat, wb)],
                   1, -1)
    vmat = small_inv(jmat)
    mu = torch.einsum("...ij,...j->...i", vmat, xi)
    mu_o, mu_i = mu[..., :d_o], mu[..., d_o:]
    v_oo, v_oi = vmat[..., :d_o, :d_o], vmat[..., :d_o, d_o:]
    v_ii = vmat[..., d_o:, d_o:]
    err = mu_o - torch.einsum("...ij,...j->...i", a_mat, mu_i) - b_vec
    cov_err = (v_oo - v_oi @ at - a_mat @ v_oi.transpose(-1, -2)
               + a_mat @ v_ii @ at)
    c2 = cov_err + err[..., :, None] * err[..., None, :]
    ae = 0.5 * (d_o * 1.8378770664093453 + elogv
                + torch.sum(wbar * c2.transpose(-1, -2), dim=(-2, -1)))
    term = ae - (0.5 * (d_o + d_i) * _LOG2PIE - 0.5 * small_logdet(jmat))
    noise = q.get(noise_key)
    v = f.interfaces.get(noise_key)
    if (noise is not None and not isinstance(noise, PointMass)
            and isinstance(v, Ref) and v.var.kind == "random"):
        term = term - noise.entropy()
    return term


def _n_copies(f) -> int:
    """Number of factor copies a (possibly nested-) plated factor stands
    for."""
    plates = getattr(f, "plates", ()) or ((f.plate,) if f.plate else ())
    n = 1
    for p in plates:
        n *= p.size
    return n


def slot_degrees(graph: ModelGraph, var) -> np.ndarray:
    """Static per-slot degree of a random variable: the factor copies that
    touch each slot.  An empty plate (``plate(1, 1)``, the transition of a
    one-step chain) has no copies and adds nothing."""
    n = var.length if var.is_array else 1
    deg = np.zeros(n, dtype=np.int64)
    for f in graph.factors:
        for v in f.all_interfaces().values():
            if not (isinstance(v, Ref) and v.var is var):
                continue
            cov = _coverage(f, v)
            copies = _n_copies(f)
            if cov == "grid":
                deg[0] += 1
            elif cov is None:
                deg[0] += copies
            elif isinstance(cov, int):
                deg[cov] += 1
            else:
                # per slot: the copies over a nested factor's other plate
                # axes all touch it (1 for a single-plate factor)
                size = v.idx.plate.size
                per_slot = (copies // size if size else 0) \
                    if isinstance(v.idx, SymIndex) else 1
                deg[cov[0]:cov[1]] += per_slot
    return deg


def gaussian_pair_entropy(covs_out, covs_in, cross_out_in, scalar: bool):
    """Entropy of the joint Gaussian (out, in) of each pair: covariances
    (..., d_out, d_out) and (..., d_in, d_in) and Cov(out, in)
    (..., d_out, d_in), or (...,) each for a scalar chain."""
    if scalar:
        det = covs_out * covs_in - cross_out_in ** 2
        return _LOG2PIE + 0.5 * torch.log(det)
    d, e = covs_out.shape[-1], covs_in.shape[-1]
    lead = torch.broadcast_shapes(covs_out.shape[:-2], covs_in.shape[:-2],
                                  cross_out_in.shape[:-2])
    joint = covs_out.new_empty(lead + (d + e, d + e))
    joint[..., :d, :d] = covs_out
    joint[..., :d, d:] = cross_out_in
    joint[..., d:, :d] = cross_out_in.transpose(-1, -2)
    joint[..., d:, d:] = covs_in
    return 0.5 * (d + e) * _LOG2PIE + 0.5 * batched_logdet(joint)


def discrete_pair_entropy(xis):
    """Entropy of each pair marginal q(out, in) (..., K, K): -sum xi log xi."""
    return -torch.sum(xis * torch.log(torch.clamp(xis, min=1e-37)),
                      dim=(-2, -1))


def _per_element(x, batch: int):
    """Sum of a term over every axis but the leading batch axis: (B,).  A
    term without the batch axis (computed from constants only) is the same
    for every element."""
    if x.ndim == 0:
        return x.expand(batch)
    return x.reshape(x.shape[0], -1).sum(dim=1)


def _extract_affine_transition(f, event_shape=None):
    """Probe a custom lagged transition's ``message_to_out`` for an affine
    Gaussian conditional out | in ~ N(A in + b, Q), scalar or vector
    state: the rule is called on point masses at fixed points (the zero
    point, the basis vectors and a check point; three points for a scalar
    state), on the CPU, once, when the free-energy plan is built, and the
    mean's affinity and the covariance's independence of the input are
    checked on the host with the JAX package's points and tolerances, so
    that the same user nodes qualify in both packages.  Returns ``(A, b,
    Q)`` (floats for a scalar state, float32 arrays for a vector one) or
    None when the rule is not affine Gaussian (a dimension-changing one
    among them): the factor then keeps the mean-field terms."""
    from ..rules.registry import get_message_rule

    try:
        rule = get_message_rule(f.fform, "out")
        ev = event_shape
        if ev is None:
            ev = getattr(f.interfaces["in"].var, "event_shape", None) or ()
        if len(ev) > 1:
            return None
        vector = len(ev) == 1
        d_i = int(ev[0]) if vector else 1

        def probe(x):
            q = {"in": PointMass(torch.as_tensor(np.asarray(x, np.float32)))}
            for name, v in f.interfaces.items():
                if name != "in" and isinstance(v, Const):
                    q[name] = PointMass(torch.as_tensor(
                        np.asarray(v.value, np.float32)))
            if f.meta is not None:
                q["_meta"] = {**f.meta, "_plated": f.plate is not None}
            with torch.no_grad():
                msg = rule(q)
            if vector:
                return (np.asarray(msg.mean().cpu(), np.float64),
                        np.asarray(msg.cov().cpu(), np.float64))
            return float(msg.mean()), float(msg.var())

        if not vector:
            xs = (0.37, -1.21, 2.05)
            ms, vs = zip(*(probe(np.float32(x)) for x in xs))
            a = (ms[0] - ms[1]) / (np.float32(xs[0]) - np.float32(xs[1]))
            b = ms[0] - a * np.float32(xs[0])
            if not np.isclose(ms[2], a * np.float32(xs[2]) + b, rtol=1e-5,
                              atol=1e-6):
                return None
            if not (np.isclose(vs[0], vs[1], rtol=1e-6)
                    and np.isclose(vs[0], vs[2], rtol=1e-6)):
                return None
            if not vs[0] > 0:
                return None
            return float(a), float(b), float(vs[0])

        b_vec, q0 = probe(np.zeros(d_i, np.float32))
        if b_vec.shape != (d_i,) or q0.shape != (d_i, d_i):
            return None   # a dimension-changing transition
        cols, covs = [], []
        for j in range(d_i):
            e = np.zeros(d_i, np.float32)
            e[j] = 1.0
            mj, vj = probe(e)
            cols.append(mj - b_vec)
            covs.append(vj)
        a_mat = np.stack(cols, axis=1)
        x_t = np.linspace(-1.3, 2.05, d_i).astype(np.float32)
        mt, vt = probe(x_t)
        if not np.allclose(mt, a_mat @ x_t + b_vec, rtol=1e-5, atol=1e-5):
            return None
        for v in covs + [vt]:
            if not np.allclose(v, q0, rtol=1e-6, atol=1e-8):
                return None
        np.linalg.cholesky(q0)   # positive definite, else None
        return (np.asarray(a_mat, np.float32), np.asarray(b_vec, np.float32),
                np.asarray(q0, np.float32))
    except Exception:  # noqa: BLE001 -- any probe failure: mean-field FE
        return None


class FactorFE:
    """One factor's free-energy contribution over the batch, (B,): its
    average energy minus its local entropy.  ``mean_field``: a
    factorization constraint splits the factor, which then takes the
    mean-field terms only.  Built once per compiled model."""

    def __init__(self, factor, is_chain_transition: bool,
                 chain_scalar: bool, mean_field: bool = False,
                 event_shape=None):
        f = self.factor = factor
        self.is_chain_transition = is_chain_transition
        self.chain_scalar = chain_scalar
        self.mean_field = mean_field
        node_cls = get_node(f.fform)
        # a deterministic node has no average energy: its whole term is
        # -H[q_a] of the joint belief over its inputs (``bethe_term`` on the
        # cavities)
        self.bethe_fn = getattr(node_cls, "bethe_term", None)
        self.energy_fn = (None if self.bethe_fn is not None
                          else get_average_energy(f.fform))
        # a user node's lagged transition left to iterative message
        # passing, whose (out, in) is one cavity cluster: when its out rule
        # probes affine Gaussian, the pair joint rebuilt from the stored
        # cavities (``_custom_pair_fe``), so that FE = -log Z on a tree
        self.custom_pair = None
        in_ref = f.interfaces.get("in")
        if (not is_chain_transition and not mean_field
                and f.plate is not None
                and isinstance(in_ref, Ref) and f.out.var.kind == "random"
                and f.out.var is in_ref.var
                and in_cavity_cluster(node_cls, "out")
                and in_cavity_cluster(node_cls, "in")):
            self.custom_pair = _extract_affine_transition(f, event_shape)
        # the structured (out, in) pair of an unplated Gaussian factor
        # between two random variables, once both cavity messages are
        # stored: (in-interface, noise-interface)
        self.pair = None
        structured = (not is_chain_transition and not mean_field
                      and f.plate is None and f.out.var.kind == "random")
        # the structured single-step GCV pair (the reference HGF
        # constraint q(xt, zt, xt_min) = q(xt, xt_min)q(zt))
        self.gcv_pair = structured and f.fform == "GCV"
        if not structured:
            return

        def random(key):
            v = f.interfaces.get(key)
            return isinstance(v, Ref) and v.var.kind == "random"

        if f.fform in _GAUSS_PAIR_NOISE and random("mean"):
            self.pair = ("mean", _GAUSS_PAIR_NOISE[f.fform])
        elif f.fform in _DOT_PAIR and random("in"):
            self.pair = ("in", "var" if "var" in f.interfaces else "prec")
        elif f.fform in _NG_PAIR:
            in_keys = [k for k in f.interfaces if k.startswith("in")]
            rand = [k for k in in_keys if random(k)]
            if len(in_keys) == 1 and len(rand) == 1:
                noise_key = next(k for k in ("var", "cov", "prec")
                                 if k in f.interfaces)
                self.pair = (rand[0], noise_key)

    def __call__(self, state: dict, data: dict, chain_cross: dict,
                 ctx: BatchContext, entropies: dict | None = None):
        """``entropies`` (``variable_entropies``) holds each random
        variable's entropy per slot, computed once for every term of one
        evaluation; a marginal not in it is evaluated here."""
        f = self.factor
        batch = ctx.batch
        n_copies = _n_copies(f)
        if self.bethe_fn is not None:
            return self._bethe_term(state, data, chain_cross, ctx)
        if (self.custom_pair is not None and f"_msg:{f.id}:out" in state
                and f"_msg:{f.id}:in" in state):
            return _per_element(self._custom_pair_fe(state, data, ctx),
                                batch)
        if (self.gcv_pair and f"_msg:{f.id}:out" in state
                and f"_msg:{f.id}:in" in state):
            # AE over the joint q(out, in) (build_q attaches the cross
            # rebuilt from the cavities) and the pair's entropy in place of
            # the two marginal ones
            q = build_q(f, state, data, ctx=ctx)
            h = gaussian_pair_entropy(q["out"].var(), q["in"].var(),
                                      q["joint"], scalar=True)
            for name in ("z", "kappa", "omega"):
                qv, v = q.get(name), f.interfaces.get(name)
                if (qv is not None and not isinstance(qv, PointMass)
                        and isinstance(v, Ref) and v.var.kind == "random"):
                    h = h + qv.entropy()
            return _per_element(self.energy_fn(q) - h, batch)
        if self.pair is not None:
            in_key, noise_key = self.pair
            if (f"_msg:{f.id}:out" in state
                    and f"_msg:{f.id}:{in_key}" in state):
                q = build_q(f, state, data, ctx=ctx)
                return _per_element(
                    gaussian_pair_fe(f, q, state, in_key, noise_key), batch)
        q = build_q(f, state, data, chain_cross=chain_cross, ctx=ctx)
        ae = self.energy_fn(q)
        # a missing observation removes its copy: its entropy terms cancel
        # against the variable's degree, so masking the energy is exact
        mask = ctx.masks.get(f.id)
        if mask is not None:
            ae = ae * mask
        grid = _grid(f)
        if grid is not None:
            # a nested-plate factor: the energy stands for its whole copy
            # grid (unit axes where every input is shared along a plate)
            if 0 < ae.ndim < 1 + len(grid):
                ae = ae.reshape(ae.shape + (1,) * (1 + len(grid) - ae.ndim))
            ae = ae.expand((batch,) + grid)
        elif f.plate is not None and n_copies > 1 and ae.ndim >= 2 \
                and ae.shape[1] == 1:
            # every interface shared by the copies: one energy stands for
            # plate.size copies
            ae = ae * n_copies
        total = _per_element(ae, batch)

        h = 0.0
        paired = ()
        if self.is_chain_transition:
            # the structured pair q(out, in) of each step
            cross = chain_cross[f.out.var.name]
            q_out, q_in = q["out"], q["in"]
            if f.fform == "DiscreteTransition":
                hp = discrete_pair_entropy(cross)
            elif f.fform == "AR" and not self.chain_scalar:
                # the shift rows of the embedded state are deterministic:
                # the cluster is (out_0, in), of dimension k + 1
                hp = gaussian_pair_entropy(q_out.cov()[..., :1, :1],
                                           q_in.cov(), cross[..., :1, :],
                                           scalar=False)
            elif self.chain_scalar:
                hp = gaussian_pair_entropy(q_out.var(), q_in.var(), cross,
                                           scalar=True)
            else:
                hp = gaussian_pair_entropy(q_out.cov(), q_in.cov(), cross,
                                           scalar=False)
            h = _per_element(hp, batch)
            paired = ("out", "in")
        for name, v in f.all_interfaces().items():
            qv = q.get(name)
            if name in paired or qv is None or isinstance(qv, PointMass):
                continue
            if isinstance(v, Ref) and v.var.kind == "random":
                # a chain transition's random matrix or noise precision too:
                # the JAX package leaves it out, so its FE of such a chain
                # misses (copies) x H of that marginal
                cov = _coverage(f, v)
                hv = (_slots(entropies[v.var.name], cov)
                      if entropies and v.var.name in entropies
                      else qv.entropy())
                # a plated factor's shared interface: one copy per slot
                if f.plate is not None and cov is None:
                    hv = hv * n_copies
                elif grid is not None and isinstance(v.idx, SymIndex):
                    # a single-axis neighbour's slot takes part in every
                    # copy along the grid's other axes
                    hv = hv * (n_copies // v.idx.plate.size)
                h = h + _per_element(hv, batch)
        return total - h

    def _custom_pair_fe(self, state: dict, data: dict, ctx: BatchContext):
        """AE - H of a custom affine Gaussian lagged transition at the
        fixed point: per copy the pair joint q(out, in) proportional to
        cav_out x cav_in x N(out; A in + b, Q) from the stored cavity
        messages, closed form in (A, b, Q) (the node's own
        ``average_energy`` is bypassed: its message rules define the
        factor)."""
        from ..dists.gaussian import as_weighted_mean_precision
        from ..dists.natural import nat_div

        f = self.factor
        a_c, b_c, q_c = self.custom_pair
        q = build_q(f, state, data, ctx=ctx)
        cav_o = nat_div(q["out"], state[f"_msg:{f.id}:out"])
        cav_i = nat_div(q["in"], state[f"_msg:{f.id}:in"])
        if np.ndim(a_c) == 2:
            return self._custom_pair_fe_mv(cav_o, cav_i)
        no = as_weighted_mean_precision(cav_o)
        ni = as_weighted_mean_precision(cav_i)
        joo = no.w + 1.0 / q_c
        jii = ni.w + a_c * a_c / q_c
        joi = -a_c / q_c
        xo = no.xi + b_c / q_c
        xi_ = ni.xi - a_c * b_c / q_c
        det = joo * jii - joi * joi
        voo, vii, c = jii / det, joo / det, -joi / det
        mo = (jii * xo - joi * xi_) / det
        mi = (joo * xi_ - joi * xo) / det
        resid = mo - a_c * mi - b_c
        ae = 0.5 * (np.log(2 * np.pi * q_c)
                    + (resid ** 2 + voo + a_c * a_c * vii - 2 * a_c * c)
                    / q_c)
        return ae - gaussian_pair_entropy(voo, vii, c, scalar=True)

    def _custom_pair_fe_mv(self, cav_o, cav_i):
        """The vector-state ``_custom_pair_fe``: per copy the pair joint in
        block information form."""
        from ..dists.gaussian import as_mv_weighted_mean_precision

        no = as_mv_weighted_mean_precision(cav_o)
        ni = as_mv_weighted_mean_precision(cav_i)
        like = dict(dtype=no.xi.dtype, device=no.xi.device)
        a_c, b_c, q_c = self.custom_pair
        a = torch.as_tensor(a_c, **like)
        b = torch.as_tensor(b_c, **like)
        qinv = torch.as_tensor(np.linalg.inv(q_c), **like)
        logdet_q = float(np.linalg.slogdet(q_c)[1])
        d = a.shape[0]
        joo = no.w + qinv
        jii = ni.w + a.T @ qinv @ a
        lead = torch.broadcast_shapes(joo.shape[:-2], jii.shape[:-2])
        joo, jii = joo.expand(lead + (d, d)), jii.expand(lead + (d, d))
        joi = (-(qinv @ a)).expand(lead + (d, d))
        jmat = torch.cat([torch.cat([joo, joi], dim=-1),
                          torch.cat([joi.transpose(-1, -2), jii], dim=-1)],
                         dim=-2)
        xo = no.xi + qinv @ b
        xi_ = ni.xi - a.T @ (qinv @ b)
        lead_x = torch.broadcast_shapes(xo.shape[:-1], xi_.shape[:-1])
        xi_full = torch.cat([xo.expand(lead_x + (d,)),
                             xi_.expand(lead_x + (d,))], dim=-1)
        vmat = torch.linalg.inv(jmat)
        mu = torch.einsum("...ij,...j->...i", vmat, xi_full)
        mo, mi = mu[..., :d], mu[..., d:]
        voo, voi, vii = vmat[..., :d, :d], vmat[..., :d, d:], vmat[..., d:, d:]
        resid = mo - torch.einsum("ij,...j->...i", a, mi) - b
        cov_err = (voo - torch.einsum("...ik,jk->...ij", voi, a)
                   - torch.einsum("ik,...jk->...ij", a, voi)
                   + torch.einsum("ik,...kl,jl->...ij", a, vii, a))
        c2 = cov_err + resid[..., :, None] * resid[..., None, :]
        ae = 0.5 * (d * np.log(2 * np.pi) + logdet_q
                    + torch.einsum("ij,...ji->...", qinv, c2))
        h = d * _LOG2PIE - 0.5 * torch.linalg.slogdet(jmat)[1]
        return ae - h


    def _bethe_term(self, state: dict, data: dict, chain_cross: dict,
                    ctx: BatchContext):
        """A deterministic node's contribution from its cavity beliefs (the
        marginals of its random interfaces divided by its stored messages
        there), one copy's term standing for every copy of a plate when
        the copies share their inputs."""
        from ..dists.natural import nat_div

        f = self.factor
        q = build_q(f, state, data, chain_cross=chain_cross, ctx=ctx)
        for name, v in f.all_interfaces().items():
            key = f"_msg:{f.id}:{name}"
            if (name in q and key in state and isinstance(v, Ref)
                    and v.var.kind == "random"):
                q[name] = nat_div(q[name], state[key])
        term = self.bethe_fn(q)
        n_copies = _n_copies(f)
        if (f.plate is not None and n_copies > 1
                and (term.ndim < 2 or term.shape[1] == 1)):
            term = term * n_copies
        return _per_element(term, ctx.batch)


def _slots(h, cov):
    """The slots ``cov`` (``_coverage``) of a variable's per-slot entropy
    (B, slots) (or (B,) for a single-copy variable, (B, N, M) for a grid
    latent, whose grid slot is all of it), as ``build_q`` takes them of its
    marginal."""
    if cov is None or cov == "grid":
        return h
    if isinstance(cov, int):
        return h.select(1, cov)
    return h.narrow(1, cov[0], cov[1] - cov[0])


def variable_entropies(graph: ModelGraph, state: dict) -> dict:
    """Each random variable's entropy per slot over the batch; a point-mass
    marginal has none."""
    return {var.name: state[var.name].entropy()
            for var in graph.random_variables()
            if not isinstance(state[var.name], PointMass)}


def variable_entropy_term(graph: ModelGraph, state: dict, degrees: dict,
                          batch: int, entropies: dict | None = None):
    """sum_i (d_i - 1) H[q_i] over the random variables (per slot), (B,).
    Point-mass marginals contribute nothing: their -inf entropies cancel
    against the factors' terms.  ``degrees`` maps each variable to its slot
    degrees (``slot_degrees``; an array variable's may already be a tensor
    on the state's device); ``entropies`` (``variable_entropies``) saves
    evaluating them here."""
    if entropies is None:
        entropies = variable_entropies(graph, state)
    total = 0.0
    for var in graph.random_variables():
        if var.name not in entropies:
            continue
        h = entropies[var.name]
        deg = degrees[var.name]
        if var.is_array:
            w = torch.as_tensor(deg, dtype=h.dtype, device=h.device) - 1.0
            term = _per_element(w * h, batch)
        else:
            term = (float(deg[0]) - 1.0) * _per_element(h, batch)
        total = total + term
    return total
