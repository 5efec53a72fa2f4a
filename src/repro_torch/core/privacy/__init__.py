"""Trustworthiness evaluation: gradient inversion + SSIM/PSNR (paper §V-C),
the trajectory harness that tells cold-start from steady-state leakage
(threaded compressor state), and DP accounting
(:mod:`repro_torch.core.privacy.accounting`)."""

from repro_torch.core.privacy.accounting import (
    PrivacyAccountant,
    TrainingBudget,
    advanced_composition,
    amplified_epsilon,
    basic_composition,
    compose_training,
    gaussian_epsilon,
    gaussian_sigma,
)
from repro_torch.core.privacy.gia import (
    GIAConfig,
    cosine_distance,
    invert_gradients,
    invert_gradients_batched,
    observed_gradient,
    total_variation,
)
from repro_torch.core.privacy.harness import (
    AttackPoint,
    HarnessConfig,
    PostHocNoiseCompressor,
    run_attack_harness,
    sweep_methods,
)
from repro_torch.core.privacy.ssim import psnr, ssim

__all__ = [
    "GIAConfig",
    "cosine_distance",
    "invert_gradients",
    "invert_gradients_batched",
    "observed_gradient",
    "total_variation",
    "ssim",
    "psnr",
    "AttackPoint",
    "HarnessConfig",
    "PostHocNoiseCompressor",
    "run_attack_harness",
    "sweep_methods",
    "PrivacyAccountant",
    "TrainingBudget",
    "advanced_composition",
    "amplified_epsilon",
    "basic_composition",
    "compose_training",
    "gaussian_epsilon",
    "gaussian_sigma",
]
