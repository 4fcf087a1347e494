"""Per-variable log-scales (counterpart of ``rxinfer_tpu/engine/logscale.py``:
the reference's ``LogScaleAnnotations``), over the batch.

At the fixed point of the static schedule every message can be evaluated
again, so the scales are summed in a pass after inference instead of being
carried by every rule:

- each inbound message to a variable contributes the pair (eta_i, c_i =
  s_i - A(eta_i)), A the family's log-partition and s_i = log(true factor
  message / emitted density) at x0 (the posterior mean), taken from the
  node's average energy at point values: s_i = -AE(point values at x0) -
  log d_i(x0) (a constant in x for a conjugate message);
- the evidence of the product of the true messages is A(sum eta_i) +
  sum c_i;
- next to a ``Mixture(switch, comps)`` factor each component's evidence is
  log Z_k = A(eta_k + eta_lik) + c_k + c_lik, and
      logscale(comp_k) = log w_k + log Z_k,
      logscale(out) = logscale(switch) = logsumexp_k(log w_k + log Z_k).

Every other variable's scale is -FE (log Z on a tree).  The JAX package
evaluates one dataset under ``vmap``; here every term carries the batch on
axis 0 (``BatchContext``), as the blocks' updates do, and every scale is
(B,).
"""

from __future__ import annotations

import warnings

import torch

from ..dists import PointMass
from ..dists.natural import family_key, log_partition, logpdf, prod_reduce
from ..dists.natural import to_natural
from ..graph.ir import Ref
from ..rules.registry import get_message_rule, get_node
from .blocks import BatchContext, _coverage, build_q, mask_message


def _per_element(c, batch: int):
    """A term summed over every axis but the batch axis: (B,)."""
    c = c.expand((batch,) + tuple(c.shape[1:])) if c.ndim else c.expand(batch)
    return c.reshape(batch, -1).sum(1)


def inbound_evidence(compiled, state: dict, data: dict, ctx: BatchContext,
                     varname: str, exclude_factor=None):
    """(family, sum eta_i, sum c_i) over the true inbound messages of a
    plain variable, but ``exclude_factor``'s (a mixture's cavity): the
    variable-local evidence A(sum eta) + sum c = log of the integral of
    the product of the true messages.  Every leaf carries the batch."""
    var = next(v for v in compiled.graph.random_variables()
               if v.name == varname)
    points = {k: PointMass(v.mean()) for k, v in state.items()
              if not k.startswith("_msg:")}
    nat_sum, fam = None, None
    c_total = torch.zeros(ctx.batch, device=ctx.device)
    for f in compiled.graph.factors:
        if f is exclude_factor:
            continue
        iface = next((name for name, v in f.all_interfaces().items()
                      if isinstance(v, Ref) and v.var is var), None)
        if iface is None:
            continue
        # a factor split by a factorization constraint: its mean-field rule
        raw = get_message_rule(f.fform, iface,
                               vmp=f.id in compiled.mf_factor_ids)(
            build_q(f, state, data, exclude=iface, ctx=ctx))
        mask = ctx.masks.get(f.id)
        msg = mask_message(raw, mask)
        fam = family_key(msg)
        # s = log(true message / emitted density) at the point values
        q_pt = build_q(f, points, data, ctx=ctx)
        x0 = q_pt[iface].point
        s = -get_node(f.fform).average_energy(q_pt) - logpdf(raw, x0)
        c = s - log_partition(fam, to_natural(raw))
        if mask is not None:
            c = c * mask
        if isinstance(_coverage(f, f.out if iface == "out"
                                else f.interfaces[iface]), tuple):
            raise NotImplementedError(
                "log-scales of array variables are not supported.")
        if f.plate is not None:   # one (eta, c) pair per factor copy
            msg = prod_reduce(msg, f.plate.size, batch_ndim=1)
        c_total = c_total + _per_element(c, ctx.batch)
        nat = to_natural(msg)
        nat_sum = nat if nat_sum is None else tuple(
            a + b for a, b in zip(nat_sum, nat))
    return fam, nat_sum, c_total


def _switch_log_weights(compiled, state, data, ctx, f):
    """The mixture switch's normalized prior log-weights (B, K): its
    inbound message but the mixture factor's."""
    fam, nat, _ = inbound_evidence(compiled, state, data, ctx,
                                   f.interfaces["switch"].var.name,
                                   exclude_factor=f)
    if fam == "categorical":
        return torch.log_softmax(nat[0], dim=-1)
    if fam == "bernoulli":
        sp = torch.nn.functional.softplus
        return torch.stack([-sp(nat[0]), -sp(-nat[0])], dim=-1)
    raise NotImplementedError(
        f"mixture switch prior family {fam!r} unsupported for log-scale.")


def compute_logscales(compiled, state: dict, data: dict, ctx: BatchContext,
                      fe_last=None) -> dict:
    """Each named variable's log-scale over the batch, (B,): -``fe_last``
    (None without it), and for the variables around a ``Mixture`` factor
    their exact per-component evidences and the mixture's evidence."""
    default = None if fe_last is None else -fe_last
    scales = {v.name: default for v in compiled.graph.random_variables()
              if not v.name.startswith("_")}
    for f in compiled.graph.factors:
        if f.fform != "Mixture":
            continue
        try:
            comps = [f.interfaces[f"comp{i}"] for i in range(f.meta["K"])]
            out_name = f.out.var.name
            _, eta_lik, c_lik = inbound_evidence(
                compiled, state, data, ctx, out_name, exclude_factor=f)
            log_z = []
            for ref in comps:
                fam_k, eta_k, c_k = inbound_evidence(
                    compiled, state, data, ctx, ref.var.name,
                    exclude_factor=f)
                eta = tuple(a + b for a, b in zip(eta_k, eta_lik))
                log_z.append(log_partition(fam_k, eta) + c_k + c_lik)
            log_joint = _switch_log_weights(compiled, state, data, ctx, f) \
                + torch.stack(log_z, dim=-1)
            logz_mix = torch.logsumexp(log_joint, dim=-1)
            for k, ref in enumerate(comps):
                scales[ref.var.name] = log_joint[..., k]
            scales[out_name] = logz_mix
            scales[f.interfaces["switch"].var.name] = logz_mix
        except (NotImplementedError, KeyError, ValueError, TypeError) as exc:
            # the user asked for per-component evidence: say that these
            # variables fall back to the global -FE estimate
            warnings.warn(
                "LogScaleAnnotations: per-component evidence analysis of the "
                f"Mixture factor on {f.out.var.name!r} failed "
                f"({type(exc).__name__}: {exc}); its variables fall back to "
                "the global −FE evidence estimate.", stacklevel=2)
    return scales
