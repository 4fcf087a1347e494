"""Rule registry (counterpart of ``rxinfer_tpu/rules/registry.py``).

A node definition is a class registered under its canonical fform name with
``message_to_<iface>(q) -> Distribution`` rules (``q`` maps interface names
to marginals, PointMass for observed values and constants) and optional
mean-field ``vmp_message_to_<iface>`` variants.  Lookups happen when a program
is built, never per call.

Ported subset: ``node``, ``get_node``, ``get_message_rule``,
``get_average_energy``, ``has_node`` and ``RuleNotFoundError``.  Not
ported: ``trace_messages``, ``call_rule`` and ``NodeFunctionRuleFallback``.
"""

from __future__ import annotations

from typing import Callable

_NODES: dict[str, type] = {}


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
