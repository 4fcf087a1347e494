"""Model graph: IR, ``@model`` DSL and constraints of the PyTorch port."""

from .constraints import (  # noqa: F401
    AbstractFormConstraint,
    AutoProposal,
    ComposedFormConstraint,
    Constraints,
    FixedMarginalFormConstraint,
    FullFactorization,
    InitMessage,
    LeftProposal,
    MeanField,
    PointMassFormConstraint,
    RightProposal,
    SampleListFormConstraint,
    UnspecifiedFormConstraint,
    constraints,
    factorize,
    factorize_slots,
)
from .dsl import (  # noqa: F401
    AND,
    IMPLY,
    NOT,
    OR,
    BinomialPolya,
    ContinuousTransition,
    Delta,
    MultinomialPolya,
    Probit,
    SoftDot,
    tie,
)
