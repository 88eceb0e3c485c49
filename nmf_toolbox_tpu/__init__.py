"""nmf_toolbox_tpu — an accelerator-native non-negative matrix factorization
framework.

A from-scratch JAX/XLA re-design with the capabilities of the MATLAB
"NMF Toolbox" (colinvaz/nmf-toolbox): eleven solver families, the full
config/parameter surface, and utilities — built device-first (Gram-form
updates, on-device convergence loops, a Pallas/Triton KL kernel, mesh
sharding) rather than as a translation.
"""
from .core import EPS, Result
from .ops import reconstruct, projfunc
from .models import (nmf, lnmf, seminmf, convexnmf, chnmf, cnmf, nmfsc,
                     cnmfsc, cmfwisa, chcnmf, constrainednmf, nmf_hals,
                     nmf_streaming, nmf_encode_streaming, nmf_batched,
                     nmf_multiseed,
                     nmf_encode, cnmf_encode, cmfwisa_encode, nmf2d, nmf2d_encode, symnmf)
from .rank import pick_rank, consensus_stability, estimate_rank_svd
from .utils import wiener_masks, separate, separate_waveforms, \
    stft, istft, griffinlim, magnitude

reconstruct_from_decomposition = reconstruct  # reference-style alias

__all__ = ["EPS", "Result", "reconstruct", "reconstruct_from_decomposition",
           "projfunc", "nmf", "lnmf", "seminmf", "convexnmf", "chnmf",
           "cnmf", "nmfsc", "cnmfsc", "cmfwisa", "chcnmf", "constrainednmf",
           "nmf_hals", "nmf_streaming", "nmf_encode_streaming", "nmf_batched", "nmf_multiseed", "nmf_encode", "cnmf_encode", "cmfwisa_encode", "nmf2d", "nmf2d_encode", "symnmf",
           "wiener_masks", "separate", "separate_waveforms", "stft", "istft", "griffinlim", "magnitude",
           "pick_rank", "consensus_stability", "estimate_rank_svd"]
__version__ = "1.1.0"
