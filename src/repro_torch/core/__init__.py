"""Core: the paper's contribution — Two-Pass softmax via extended exponents."""

from repro_torch.core.numerics import (  # noqa: F401
    ExtFloat,
    exp2_int,
    ext_add,
    exp_via_extexp,
    ext_exp,
    ext_exp_reconstruct,
    ext_log,
    ext_scale_add,
    ext_sum,
    ext_zero,
)
from repro_torch.core.policy import DEFAULT_POLICY, SoftmaxPolicy  # noqa: F401
from repro_torch.core.softmax_api import (  # noqa: F401
    SoftmaxAlgorithm,
    logsumexp,
    softmax,
)
from repro_torch.core.twopass import (  # noqa: F401
    twopass_logsumexp,
    twopass_logsumexp_sharded,
    twopass_softmax,
    twopass_softmax_sharded,
)
