"""PyTorch/CUDA port of VAESNe for one NVIDIA H100.

A second package beside the JAX reference ``vaesne_tpu``: the serving and
training paths of the photometry + spectra MoE-MMVAE and of the host-galaxy
image VAE in PyTorch, with the
JAX package's TPU kernels on those paths written by hand for Hopper in CUDA
C++ (fused masked attention forward and backward, the masked Laplace
log-likelihood forward and backward), and the data layer, configs,
checkpoints and training drivers (``data``, ``utils.config``,
``utils.checkpoint``, ``experiments``). Imports torch, numpy and the
standard library only; the kernels are built with nvcc at their first use
on a card.
"""

from . import objectives, training
from .distributions import Laplace, MaskedGridLaplace, Normal, get_mean, kl_divergence, log_mean_exp
from .models import HostImgVAE, MMVAE, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from .ops import attention_reference, fused_attention, masked_laplace_loglik, routes_to_kernel
from .serving import InferenceServer
from .training import TrainState, adamw, make_train_step
from .utils import fold_in, init_params, load_jax_params, to_jax_params

__all__ = [
    "HostImgVAE", "InferenceServer", "Laplace", "MMVAE", "MaskedGridLaplace", "Normal",
    "PhotoSpecMMVAE", "PhotometricVAE", "SpectraVAE", "TrainState", "adamw",
    "attention_reference", "fold_in", "fused_attention", "get_mean", "init_params",
    "kl_divergence", "load_jax_params", "log_mean_exp", "make_train_step",
    "masked_laplace_loglik", "objectives", "routes_to_kernel", "to_jax_params", "training",
]
