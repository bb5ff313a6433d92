from ccdm_tpu_torch.diffusion.categorical import (
    CategoricalDiffusion,
    categorical_kl,
    max_prob_onehot,
    q_xt_given_x0_probs,
    q_xt_given_xtm1_probs,
    sample_onehot,
    theta_post,
    theta_post_prob,
    theta_post_prob_naive,
    uniform_onehot_noise,
)
from ccdm_tpu_torch.diffusion.sampling import (
    SamplerConfig,
    ancestral_sampler,
    sample_prior,
    subsampled_t_values,
)

__all__ = [
    "CategoricalDiffusion",
    "categorical_kl",
    "q_xt_given_x0_probs",
    "q_xt_given_xtm1_probs",
    "theta_post",
    "theta_post_prob",
    "theta_post_prob_naive",
    "sample_onehot",
    "max_prob_onehot",
    "uniform_onehot_noise",
    "SamplerConfig",
    "ancestral_sampler",
    "sample_prior",
    "subsampled_t_values",
]
