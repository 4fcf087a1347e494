"""rxinfer_tpu_torch — the PyTorch/CUDA port of ``rxinfer_tpu``.

A model written with ``@model``, ``latent``, ``plate``,
``MvNormal``/``Normal`` (sums of random terms in their means: ``a + b``,
``A @ x + B @ u``), ``Gamma``, ``InverseGamma``, ``Wishart``,
``InverseWishart``, ``Beta``, ``Bernoulli``, ``Binomial``, ``Poisson``,
``Multinomial``, ``Uniform``, ``Uninformative``, ``Sum``, ``lincomb``,
``Categorical``, ``Dirichlet``, ``DirichletCollection``, ``Transition``,
``NormalMixture``, ``Mixture``, ``AR``, ``GCV``, ``dot``, ``Delta``
(``Linearization``, ``Unscented``, ``CVIProjection``, a known inverse),
``Probit``, ``SoftDot``, the logic nodes ``OR`` / ``AND`` / ``NOT`` /
``IMPLY`` with ``tie``, ``BinomialPolya`` / ``MultinomialPolya``,
``ContinuousTransition``, grid data and grid latents over nested plates
(``y[i, j]``, ``latent((N, M))``), ``factor_node`` and ``where`` blocks
(``RequireMessage``) runs through
``infer`` on one dataset, through ``batched_program`` / ``infer_batched``
over many, and through
``infer(autoupdates=...)``, the streaming engine, on one stream or many, on
an NVIDIA GPU; ``free_energy=True``
returns the Bethe free energy after every sweep (``engine/bethe.py``);
``constraints=`` takes factorization, form (``ProjectedTo``,
``PointMassFormConstraint``, ...) and message-form constraints
(``graph/constraints.py``, ``engine/projection.py``), and
``options={"rulefallback": NodeFunctionRuleFallback()}`` nodes defined by
their ``logpdf`` (``factor_node``).  In a
batched program its Gaussian chains are solved by the hand-written CUDA
smoother kernels of ``csrc/fused_smoother.cu``, its discrete chains by the
forward-backward kernels of ``csrc/fused_fb.cu`` (``csrc/fused_fb_wide.cu``
above 8 states) — a Gaussian chain whose
observation precision or process noise is a random ``Gamma`` / ``Wishart``
variable too, with that precision re-closed per chain every sweep — and
its plain conjugate groups by natural-parameter message products; a chain the plan leaves off
the kernels (``options={"fused_kernels": False}``, missing observations in
a Gaussian batch, a state dimension beyond the kernels') and
every chain of ``infer`` runs the associative-scan smoother and
forward-backward of ``ops/kalman.py`` / ``ops/discrete_chain.py`` in torch;
``options={"observation_dtype": "int8" | "float8_e4m3fn"}`` feeds the
Gaussian chains from observations quantized by the kernels of
``csrc/quantized.cu`` (``ops/quantized.py``, which also holds the
``quantized_evidence`` ingest entry points).  ``parallel.filtering`` filters
a stream of observations over many parallel chains, continuous batching, in
the kernels of ``csrc/fused_filter.cu`` (``csrc/fused_filter_wide.cu`` for a
state dimension of 9 to 16 or more than 8 observations).  Every kernel is built with ``nvcc``
at first use.  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead.

Models compose from submodels (``scope``, ``submodel`` with
``default_constraints`` / ``default_init``, node contraction under
``infer(allow_node_contraction=True)``), and data arithmetic folds into
derived data.  ``trace_messages`` records the rule dispatches of the
sweeps; sessions (``utils/session.py``), telemetry to a local file
(``utils/telemetry.py``), checkpoints (``save_checkpoint`` /
``load_checkpoint``), ``profile_trace``, ``benchmark_table``,
``convert_to_tensorboard`` and ``StopEarlyIterationStrategy`` instrument
the entry points.

The package imports torch and numpy only — never JAX nor ``rxinfer_tpu``.
"""

from . import dists, rules  # noqa: F401  (rules: registers the node rules)
from .dists import *  # noqa: F401,F403  (the families at the top level)
from .dists import (  # noqa: F401
    BernoulliLogits,
    GammaShapeRate,
    GammaShapeScale,
    MvNormalMeanCovariance,
    MvNormalMeanPrecision,
    MvNormalMeanScalePrecision,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    PointMass,
    WishartInverseScale,
)
from .graph.dsl import (  # noqa: F401
    AR,
    GCV,
    ARMeta,
    ARsafe,
    ARunsafe,
    AND,
    IMPLY,
    NOT,
    OR,
    Bernoulli,
    BinomialPolya,
    ContinuousTransition,
    Beta,
    Binomial,
    Categorical,
    Delta,
    Dirichlet,
    DirichletCollection,
    DiscreteTransition,
    Gamma,
    GammaMixture,
    InverseGamma,
    InverseWishart,
    Mixture,
    Multinomial,
    MultinomialPolya,
    MvNormal,
    Normal,
    NormalMixture,
    Poisson,
    Probit,
    RequireMessage,
    RequireMessageFunctionalDependencies,
    SoftDot,
    Sum,
    Transition,
    Uniform,
    Uninformative,
    Wishart,
    dot,
    factor_node,
    latent,
    lincomb,
    model,
    plate,
    scope,
    submodel,
    tie,
    where,
)
from .graph.constraints import (  # noqa: F401
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
from .rules.registry import (  # noqa: F401
    NodeFunctionRuleFallback,
    call_rule,
    trace_messages,
)
from .engine.projection import ProjectedTo  # noqa: F401
from .rules import (  # noqa: F401
    CVI,
    CVIProjection,
    DeltaMeta,
    Linearization,
    Unscented,
)
from .inference_streaming import (  # noqa: F401
    RxInferenceEngine,
    RxInferenceEvent,
    autoupdates,
)
from .postprocess import (  # noqa: F401
    LogScaleAnnotations,
    Marginal,
    NoopPostprocess,
    UnpackMarginalPostprocess,
    getannotations,
    getdata,
    getlogscale,
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
from .diagnostics import (  # noqa: F401
    DefaultObjectiveDiagnosticChecks,
    ObjectiveDiagnosticCheckInfs,
    ObjectiveDiagnosticCheckNaNs,
)
from .utils import (  # noqa: F401
    Session,
    create_session,
    summarize_session,
    summarize_session_table,
)
from .utils.callbacks import (  # noqa: F401
    BenchmarkCallbacks,
    StopEarlyIterationStrategy,
    TraceCallbacks,
    benchmark_table,
    convert_to_tensorboard,
    profile_trace,
)
from .utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401

__version__ = "0.1.0"
