"""rxinfer_tpu_torch — the PyTorch/CUDA port of ``rxinfer_tpu``.

Slices 1 and 2 of the port: batched linear-Gaussian state-space smoothing
and batched HMM structured VMP.  A model written with ``@model``, ``latent``,
``plate``, ``MvNormal``/``Normal``, ``Categorical``, ``DirichletCollection``
and ``Transition`` runs through ``batched_program`` / ``infer_batched`` on
an NVIDIA GPU: its Gaussian chains are solved by the hand-written CUDA
smoother kernels of ``csrc/fused_smoother.cu``, its discrete chains by the
forward-backward kernels of ``csrc/fused_fb.cu`` (both built with ``nvcc``
at first use), and its plain conjugate groups by natural-parameter message
products.  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

The package imports torch and numpy only — never JAX nor ``rxinfer_tpu``.
"""

from . import rules  # noqa: F401  (registers the ported node rules)
from .dists import (  # noqa: F401
    MvNormalMeanCovariance,
    MvNormalMeanPrecision,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    PointMass,
)
from .graph.dsl import (  # noqa: F401
    Categorical,
    DirichletCollection,
    DiscreteTransition,
    Gamma,
    MvNormal,
    Normal,
    Transition,
    latent,
    model,
    plate,
)
from .inference import (  # noqa: F401
    BatchedInferenceResult,
    KeepEach,
    KeepLast,
    batched_program,
    infer_batched,
)
