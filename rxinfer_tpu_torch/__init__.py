"""rxinfer_tpu_torch — the PyTorch/CUDA port of ``rxinfer_tpu``.

A model written with ``@model``, ``latent``, ``plate``,
``MvNormal``/``Normal``, ``Categorical``, ``DirichletCollection`` and
``Transition`` runs through ``infer`` on one dataset, and through
``batched_program`` / ``infer_batched`` over many, on an NVIDIA GPU.  In a
batched program its Gaussian chains are solved by the hand-written CUDA
smoother kernels of ``csrc/fused_smoother.cu``, its discrete chains by the
forward-backward kernels of ``csrc/fused_fb.cu``, and its plain conjugate
groups by natural-parameter message products; a chain the plan leaves off
the kernels (``options={"fused_kernels": False}``, missing observations in
a Gaussian batch, a state dimension or state count beyond the kernels') and
every chain of ``infer`` runs the associative-scan smoother and
forward-backward of ``ops/kalman.py`` / ``ops/discrete_chain.py`` in torch;
``options={"observation_dtype": "int8" | "float8_e4m3fn"}`` feeds the
Gaussian chains from observations quantized by the kernels of
``csrc/quantized.cu`` (``ops/quantized.py``, which also holds the
``quantized_evidence`` ingest entry points).  ``parallel.filtering`` filters
a stream of observations over many parallel chains, continuous batching, in
the kernel of ``csrc/fused_filter.cu``.  Every kernel is built with ``nvcc``
at first use.  Entry points run on ``"cuda"`` unless the caller passes
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
    InferenceResult,
    KeepEach,
    KeepLast,
    UnfactorizedData,
    batched_program,
    getreturnval,
    infer,
    infer_batched,
    iserror,
    issuccess,
)
