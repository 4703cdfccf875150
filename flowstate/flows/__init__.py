"""Normalizing-flow library (pure-functional, pytree params)."""

from flowstate.flows.affine import (
    AffineConstFlow,
    AffineCoupling,
    AffineCouplingBlock,
    CCAffineConst,
    MaskedAffineFlow,
)
from flowstate.flows.autoregressive import (
    MADE,
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    MaskedAffineAutoregressive,
    MaskedPiecewiseRQSAutoregressive,
)
from flowstate.flows.core import (
    NormalizingFlow,
    ScannedLayers,
    build_circular_flow,
    build_conditional_circular_flow,
    generate_samples,
)
from flowstate.flows.image import (
    ActNormImage,
    ConvNet2d,
    ConvResidualNet,
    GlowBlock,
)
from flowstate.flows.models import (
    ClassCondFlow,
    ConditionalNormalizingFlow,
    ContextAffineCoupling,
    MultiscaleFlow,
)
from flowstate.flows.lipschitz import (
    InducedNormCNN,
    InducedNormConv2d,
    InducedNormLinear,
    InducedNormMLP,
    normalize_u,
    normalize_v,
    projmax,
    vector_norm,
)
from flowstate.flows.residual import (
    LipschitzCNN,
    LipschitzMLP,
    Residual,
    asym_squash,
    batch_jacobian,
    batch_trace,
    geometric_sample,
    leaky_elu,
    lipswish,
    poisson_sample,
)
from flowstate.flows.base import Composite, Reverse
from flowstate.flows.coupling import (
    CircularSplineCoupling,
    CoupledRationalQuadraticSpline,
    create_alternating_binary_mask,
    create_mid_split_binary_mask,
    create_random_binary_mask,
    sum_except_batch,
)
from flowstate.flows.distributions import (
    AffineGaussian,
    ClassCondDiagGaussian,
    DiagGaussian,
    GaussianPCA,
    GlowBase,
    GaussianMixture,
    UniformBase,
    UniformGaussian,
    UniformParticle,
)
from flowstate.flows.elementary import Planar, Radial
from flowstate.flows.mixing import (
    Invertible1x1Conv,
    InvertibleAffine,
    LULinearPermute,
    Permute,
)
from flowstate.flows.nets import (
    MLP,
    ClampExp,
    ConstScaleLayer,
    PeriodicFeaturesCat,
    PeriodicFeaturesElementwise,
    ResidualNet,
    TorusEGNN,
    TransformerNet,
    clamp_exp,
)
from flowstate.flows.normalization import ActNorm, BatchNorm
from flowstate.flows.periodic import PeriodicShift, PeriodicWrap
from flowstate.flows.reshape import Merge, Split, Squeeze
from flowstate.flows.sampling import HAIS
from flowstate.flows.stochastic import (
    DiagGaussianProposal,
    HamiltonianMonteCarlo,
    MetropolisHastings,
)
from flowstate.flows.targets import CoulombGas, DoubleWellLJ, DWNormal, SimpleLJ
from flowstate.flows.transforms import LogitTransform, Shift
from flowstate.flows.toy_targets import (
    CircularGaussianMixture,
    ConditionalDiagGaussian,
    ImagePrior,
    LinearInterpolation,
    RingMixture,
    Sinusoidal,
    SinusoidalGap,
    SinusoidalSplit,
    Smiley,
    TwoIndependent,
    TwoModes,
    TwoMoons,
    rejection_sample,
)
from flowstate.flows.vae import (
    ConstDiagGaussian,
    Dirac,
    NNBernoulliDecoder,
    NNDiagGaussian,
    NNDiagGaussianDecoder,
    NormalizingFlowVAE,
    UniformEncoder,
)

__all__ = [
    # model
    "NormalizingFlow", "build_circular_flow",
    "build_conditional_circular_flow", "NormalizingFlowVAE",
    "ScannedLayers", "generate_samples",
    "ConditionalNormalizingFlow", "ContextAffineCoupling", "ClassCondFlow", "MultiscaleFlow",
    # residual + image
    "Residual", "LipschitzMLP", "LipschitzCNN", "lipswish",
    "InducedNormLinear", "InducedNormConv2d", "InducedNormMLP",
    "InducedNormCNN", "normalize_u", "normalize_v", "projmax",
    "vector_norm",
    "geometric_sample", "poisson_sample", "batch_jacobian", "batch_trace",
    "leaky_elu", "asym_squash",
    "GlowBlock", "ConvNet2d", "ConvResidualNet", "ActNormImage",
    # couplings / splines
    "CircularSplineCoupling", "CoupledRationalQuadraticSpline",
    "create_alternating_binary_mask", "create_mid_split_binary_mask",
    "create_random_binary_mask", "sum_except_batch",
    "Reverse", "Composite",
    # affine family
    "AffineConstFlow", "CCAffineConst", "AffineCoupling", "MaskedAffineFlow",
    "AffineCouplingBlock",
    # autoregressive
    "MADE", "MaskedAffineAutoregressive", "MaskedPiecewiseRQSAutoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    # mixing
    "Permute", "InvertibleAffine", "LULinearPermute", "Invertible1x1Conv",
    # elementary / norm / periodic / reshape
    "Planar", "Radial", "ActNorm", "BatchNorm", "PeriodicWrap",
    "PeriodicShift", "Split", "Merge", "Squeeze",
    # stochastic + sampling
    "MetropolisHastings", "HamiltonianMonteCarlo", "DiagGaussianProposal",
    "HAIS",
    # bases
    "UniformParticle", "UniformBase", "DiagGaussian", "UniformGaussian",
    "GaussianMixture", "ClassCondDiagGaussian", "GlowBase", "AffineGaussian",
    "GaussianPCA",
    # nets
    "ResidualNet", "MLP", "TransformerNet", "TorusEGNN",
    "PeriodicFeaturesElementwise", "PeriodicFeaturesCat",
    "ConstScaleLayer", "ClampExp", "clamp_exp",
    "LogitTransform", "Shift",
    # physics targets
    "SimpleLJ", "DoubleWellLJ", "DWNormal", "CoulombGas",
    # toy targets / priors
    "TwoMoons", "CircularGaussianMixture", "RingMixture", "TwoIndependent",
    "ConditionalDiagGaussian", "TwoModes", "Sinusoidal", "SinusoidalGap",
    "SinusoidalSplit", "Smiley", "ImagePrior", "LinearInterpolation",
    "rejection_sample",
    # vae
    "Dirac", "UniformEncoder", "ConstDiagGaussian", "NNDiagGaussian",
    "NNDiagGaussianDecoder", "NNBernoulliDecoder",
]
