"""Distribution substrate of the PyTorch port (Gaussian families with the
scale-precision one, Beta, Bernoulli, Binomial, Categorical, Dirichlet,
DirichletCollection, Multinomial, GammaShapeRate, GammaShapeScale,
InverseGamma, Poisson, Uniform, Wishart, InverseWishart, MixtureDist,
PointMass, SampleList and the function-form LogPdfMessage; counterpart of
``rxinfer_tpu/dists``).  ``sampling.py``
holds their draws, modes and log-densities."""

from .base import (  # noqa: F401
    HUGE,
    TINY,
    Distribution,
    ProductError,
    dist_dataclass,
    prod,
    register_prod,
    tree_leaves,
    tree_map,
)
from .gaussian import (  # noqa: F401
    AbstractMvNormal,
    AbstractNormal,
    MvNormalMeanCovariance,
    MvNormalMeanPrecision,
    MvNormalMeanScalePrecision,
    MvNormalWeightedMeanPrecision,
    NormalMeanPrecision,
    NormalMeanVariance,
    NormalWeightedMeanPrecision,
    as_mv_weighted_mean_precision,
    as_weighted_mean_precision,
    pd_inverse,
    pd_logdet,
)
from .discrete import (  # noqa: F401
    Categorical,
    Dirichlet,
    DirichletCollection,
    Multinomial,
)
from .matrix import InverseWishart, Wishart, WishartInverseScale  # noqa: F401
from .mixture import MixtureDist  # noqa: F401
from .pointmass import (  # noqa: F401
    LogPdfMessage,
    PointMass,
    SampleList,
    register_pointmass_products,
)
from .scalar_families import (  # noqa: F401
    AbstractGamma,
    Bernoulli,
    BernoulliLogits,
    Beta,
    Binomial,
    GammaShapeRate,
    GammaShapeScale,
    InverseGamma,
    Poisson,
    Uniform,
)

register_pointmass_products(
    Beta,
    Bernoulli,
    BernoulliLogits,
    Categorical,
    Dirichlet,
    DirichletCollection,
    NormalMeanVariance,
    NormalMeanPrecision,
    NormalWeightedMeanPrecision,
    MvNormalMeanCovariance,
    MvNormalMeanPrecision,
    MvNormalWeightedMeanPrecision,
    MvNormalMeanScalePrecision,
    GammaShapeRate,
    GammaShapeScale,
    InverseGamma,
    Poisson,
    Binomial,
    Uniform,
    Multinomial,
    Wishart,
    WishartInverseScale,
    InverseWishart,
)
