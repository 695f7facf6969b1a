"""Hand-written CUDA kernels for Hopper, their plain versions and ops.

Importing this package builds nothing and needs neither ``nvcc`` nor
``triton``: a kernel is built at its first launch (``_build.load``).
"""

from repro_torch.kernels import (decode_attention, flash_attention,
                                 threepass_softmax, twopass_softmax,
                                 twopass_xent)

# Every kernel wrapper of the package; each counts its launches in
# ``.launches``.
WRAPPERS = {
    "twopass_softmax_2d": twopass_softmax.twopass_softmax_2d,
    "twopass_stats_2d": twopass_softmax.twopass_stats_2d,
    "threepass_recompute_2d": threepass_softmax.threepass_recompute_2d,
    "threepass_reload_2d": threepass_softmax.threepass_reload_2d,
    "xent_fwd_2d": twopass_xent.xent_fwd_2d,
    "xent_bwd_2d": twopass_xent.xent_bwd_2d,
    "lmhead_xent_fwd_2d": twopass_xent.lmhead_xent_fwd_2d,
    "lmhead_xent_dh_2d": twopass_xent.lmhead_xent_dh_2d,
    "lmhead_xent_dw_2d": twopass_xent.lmhead_xent_dw_2d,
    "decode_attention_paged": decode_attention.decode_attention_paged,
    "decode_attention": decode_attention.decode_attention,
    "flash_attention_fwd_gqa": flash_attention.flash_attention_fwd_gqa,
    "flash_attention_bwd_gqa": flash_attention.flash_attention_bwd_gqa,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
