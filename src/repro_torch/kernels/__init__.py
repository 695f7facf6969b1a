"""Hand-written CUDA kernels for Hopper, their plain versions and ops.

Importing this package builds nothing and needs neither ``nvcc`` nor
``triton``: a kernel is built at its first launch (``_build.load``).
"""

from repro_torch.kernels import decode_attention, twopass_softmax

# Every kernel wrapper of the package; each counts its launches in
# ``.launches``.
WRAPPERS = {
    "twopass_softmax_2d": twopass_softmax.twopass_softmax_2d,
    "twopass_stats_2d": twopass_softmax.twopass_stats_2d,
    "decode_attention_paged": decode_attention.decode_attention_paged,
    "decode_attention": decode_attention.decode_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
