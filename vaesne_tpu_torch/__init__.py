"""PyTorch/CUDA port of VAESNe for one NVIDIA H100.

A second package beside the JAX reference ``vaesne_tpu``: the serving path of
the photometry + spectra MoE-MMVAE in PyTorch, with the JAX package's TPU
kernel on that path (fused masked attention, forward) written by hand in
CUDA for Hopper. Imports torch, numpy and the standard library only.
"""

from .distributions import Laplace, MaskedGridLaplace, Normal, get_mean, kl_divergence, log_mean_exp
from .models import MMVAE, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from .ops import attention_reference, fused_attention, routes_to_kernel
from .serving import InferenceServer
from .utils import init_params, load_jax_params

__all__ = [
    "InferenceServer", "Laplace", "MMVAE", "MaskedGridLaplace", "Normal",
    "PhotoSpecMMVAE", "PhotometricVAE", "SpectraVAE", "attention_reference",
    "fused_attention", "get_mean", "init_params", "kl_divergence",
    "load_jax_params", "log_mean_exp", "routes_to_kernel",
]
