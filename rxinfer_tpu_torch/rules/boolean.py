"""Boolean logic nodes over Bernoulli variables: OR, AND, NOT, IMPLY
(counterpart of ``rxinfer_tpu/rules/boolean.py``).

The messages are exact sum-product contractions of the 0/1 truth table with
the incoming Bernoulli marginals (the cavities: every interface is in the
node's BP cluster, ``uses_cavity``).  The JAX package writes them as
``einsum`` over a (2, 2, 2) table at ``precision="highest"``; here each
contraction is spelled out as elementwise products and sums over the four
input states, which no matmul precision setting can reach.
"""

from __future__ import annotations

import torch

from ..dists import Bernoulli
from .expectations import e_mean
from .registry import node


def _p(q, name):
    return e_mean(q[name])


def _msg(p_num, p_den):
    total = p_num + p_den
    return Bernoulli(torch.clamp(p_num / torch.clamp(total, min=1e-30),
                                 1e-7, 1 - 1e-7))


def _states(p):
    """(weight of 0, weight of 1) of a Bernoulli mean."""
    return (1.0 - p, p)


class _TruthTable:
    """A two-input boolean factor out = op(in1, in2)."""

    uses_cavity = True

    # subclasses define op(a, b) -> 0/1 for python ints

    @classmethod
    def _rows(cls):
        """The four (a, b, op(a, b)) rows of the table."""
        return [(a, b, int(cls.op(a, b))) for a in (0, 1) for b in (0, 1)]

    @classmethod
    def message_to_out(cls, q):
        w1, w2 = _states(_p(q, "in1")), _states(_p(q, "in2"))
        probs = [0.0, 0.0]
        for a, b, o in cls._rows():
            probs[o] = probs[o] + w1[a] * w2[b]
        return _msg(probs[1], probs[0])

    @classmethod
    def message_to_in1(cls, q):
        wo, w2 = _states(_p(q, "out")), _states(_p(q, "in2"))
        probs = [0.0, 0.0]
        for a, b, o in cls._rows():
            probs[a] = probs[a] + wo[o] * w2[b]
        return _msg(probs[1], probs[0])

    @classmethod
    def message_to_in2(cls, q):
        wo, w1 = _states(_p(q, "out")), _states(_p(q, "in1"))
        probs = [0.0, 0.0]
        for a, b, o in cls._rows():
            probs[b] = probs[b] + wo[o] * w1[a]
        return _msg(probs[1], probs[0])

    @classmethod
    def bethe_term(cls, q):
        """-H of the joint belief q(out, in1, in2) proportional to table x
        mu_out x mu_in1 x mu_in2, from the cavity messages (E[-log f] is 0
        on the table's support).  The joint's support is the four rows."""
        wo = _states(_p(q, "out"))
        w1, w2 = _states(_p(q, "in1")), _states(_p(q, "in2"))
        joint = [wo[o] * w1[a] * w2[b] for a, b, o in cls._rows()]
        z = torch.clamp(joint[0] + joint[1] + joint[2] + joint[3], min=1e-30)
        h = 0.0
        for j in joint:
            j = j / z
            h = h - j * torch.log(torch.clamp(j, min=1e-37))
        return -h


@node("OR")
class ORNode(_TruthTable):
    interfaces = ("out", "in1", "in2")

    @staticmethod
    def op(a, b):
        return int(a or b)


@node("AND")
class ANDNode(_TruthTable):
    interfaces = ("out", "in1", "in2")

    @staticmethod
    def op(a, b):
        return int(a and b)


@node("IMPLY")
class IMPLYNode(_TruthTable):
    interfaces = ("out", "in1", "in2")

    @staticmethod
    def op(a, b):
        return int((not a) or b)


@node("NOT")
class NOTNode:
    interfaces = ("out", "in")
    uses_cavity = True

    @staticmethod
    def message_to_out(q):
        return Bernoulli(1.0 - _p(q, "in"))

    @staticmethod
    def message_to_in(q):
        return Bernoulli(1.0 - _p(q, "out"))

    @staticmethod
    def bethe_term(q):
        """-H of the joint q(out, in) proportional to delta(out = not in) x
        mu_out x mu_in: one bit of freedom, the entropy of the fused
        Bernoulli."""
        po, pi = _p(q, "out"), _p(q, "in")
        p1 = (1.0 - po) * pi   # in = 1, hence out = 0
        p0 = po * (1.0 - pi)
        z = torch.clamp(p0 + p1, min=1e-30)
        p = p1 / z
        h = -(torch.xlogy(p, p) + torch.xlogy(1.0 - p, 1.0 - p))
        return -h
