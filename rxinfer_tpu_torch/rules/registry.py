"""Rule registry (counterpart of ``rxinfer_tpu/rules/registry.py``).

A node definition is a class registered under its canonical fform name with
``message_to_<iface>(q) -> Distribution`` rules (``q`` maps interface names
to marginals, PointMass for observed values and constants) and optional
mean-field ``vmp_message_to_<iface>`` variants.  Lookups happen when a program
is built, never per call.

Ported: ``node``, ``get_node``, ``get_message_rule``,
``get_average_energy``, ``has_node``, ``call_rule``, ``RuleNotFoundError``,
``NodeFunctionRuleFallback`` and ``trace_messages``.
"""

from __future__ import annotations

import contextvars
from typing import Callable

_NODES: dict[str, type] = {}


class trace_messages:
    """Record every message-rule dispatch of the sweeps run inside the
    block (reference "Tracing individual message computations",
    docs/src/manuals/debugging.md:136-143)::

        with trace_messages() as mt:
            infer(model=m, data=..., device="cpu")
        mt.records  # [{'node': 'Bernoulli', 'interface': 'p',
                    #   'mean_field': False}, ...]

    One entry per (node, interface, variant) a plain group dispatches, and
    ``{'node': '<chain:GaussianChainBlock>', 'interface': 'x', ...}`` per
    chain block solved, in dispatch order.  The port runs its sweeps
    eagerly, so every sweep of every call records; the JAX package
    records while it traces a program (its first sweep and its scan body
    once).  A ``contextvars`` recorder: nested blocks and concurrent
    inferences each see their own, and leaving a block restores the
    enclosing one."""

    _active = contextvars.ContextVar("trace_messages_active", default=None)

    def __init__(self):
        self.records: list[dict] = []
        self._token = None

    def __enter__(self):
        self._token = trace_messages._active.set(self)
        return self

    def __exit__(self, *exc):
        trace_messages._active.reset(self._token)
        self._token = None
        return False

    @staticmethod
    def record(**entry):
        rec = trace_messages._active.get()
        if rec is not None:
            rec.records.append(entry)


class RuleNotFoundError(KeyError):
    pass


def node(fform: str):
    """Register a node-rule namespace class under a canonical fform name."""

    def deco(cls):
        cls.fform = fform
        _NODES[fform] = cls
        return cls

    return deco


def get_node(fform: str):
    try:
        return _NODES[fform]
    except KeyError:
        raise RuleNotFoundError(
            f"No node definition registered for '{fform}' in the PyTorch "
            f"port. Registered: {sorted(_NODES)}."
        ) from None


def get_average_energy(fform: str) -> Callable:
    """The node's ``average_energy(q)``, E_q[-log f] per factor copy."""
    fn = getattr(get_node(fform), "average_energy", None)
    if fn is None:
        raise RuleNotFoundError(
            f"Node '{fform}' defines no average_energy — free_energy=True is "
            "not supported for models containing it.")
    return fn


def has_node(fform: str) -> bool:
    return fform in _NODES


def get_message_rule(fform: str, iface: str, vmp: bool = False) -> Callable:
    """Resolve the message rule for (node, interface); ``vmp=True`` selects
    the mean-field variant when the node has one."""
    cls = get_node(fform)
    if vmp:
        fn = getattr(cls, f"vmp_message_to_{iface}", None)
        if fn is not None:
            return fn
    fn = getattr(cls, f"message_to_{iface}", None)
    if fn is None:
        raise RuleNotFoundError(
            f"Rule not found: node '{fform}' has no message rule towards "
            f"interface '{iface}'. Available: "
            f"{[m[len('message_to_'):] for m in dir(cls) if m.startswith('message_to_')]}."
        )
    return fn


def call_rule(fform: str, iface: str, vmp: bool = False, meta: dict = None,
              **marginals):
    """Invoke a node's message rule outside inference (the reference's
    ``@call_rule NodeType(:iface, Marginalisation)(q_... = ...)``).  The
    keyword arguments map the node's other interfaces to marginals or
    messages (distributions; a constant as a ``PointMass``);
    ``iface="average_energy"`` evaluates the node's average energy
    instead."""
    q = dict(marginals)
    if meta is not None:
        q["_meta"] = meta
    if iface == "average_energy":
        return get_average_energy(fform)(q)
    return get_message_rule(fform, iface, vmp=vmp)(q)


class NodeFunctionRuleFallback:
    """Missing message rules approximated from the node's ``logpdf``
    (reference NodeFunctionRuleFallback, docs/src/manuals/inference/
    undefinedrules.md:82-113): the message towards an interface is the
    node function with every other interface fixed at its marginal's mean,
    a function-form ``LogPdfMessage`` that a functional-form constraint
    (``ProjectedTo`` / ``SampleListFormConstraint`` /
    ``PointMassFormConstraint``) on the receiving variable must project.
    Enabled by ``infer(options={"rulefallback": NodeFunctionRuleFallback()})``.

    ``make_rule`` takes, beside the JAX package's (fform, iface), what the
    batch-major rule cannot read from its inputs: whether the factor is
    plated (its copies sit on the axis after the batch, and the message
    sums them) and which interfaces carry the batch axis (references to
    variables, not constants)."""

    def make_rule(self, fform: str, iface: str, plated: bool = False,
                  batched: tuple = ()) -> Callable:
        from ..dists import LogPdfMessage
        from .expectations import e_mean

        cls = get_node(fform)
        logpdf = getattr(cls, "logpdf", None)
        if logpdf is None:
            raise RuleNotFoundError(
                f"Rule not found for '{fform}' -> '{iface}', and the node "
                "defines no logpdf for NodeFunctionRuleFallback to use.")

        def rule(q):
            others = {name: e_mean(d) for name, d in q.items()
                      if name != "_meta"}
            batch = next(((others[n].shape[0],) for n in batched
                          if n in others and others[n].ndim), ())

            def log_fn(x):
                # x: (S, batch...); a plate's copies on the axis after it
                vals = dict(others)
                vals[iface] = x[..., None] if plated else x
                return logpdf(vals)

            return LogPdfMessage(log_fn, plate_axes=1 if plated else 0,
                                 batch_shape=batch)

        return rule
