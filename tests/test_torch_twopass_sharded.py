"""The sharded two-pass softmax and logsumexp over 2 and 4 ``gloo`` ranks,
each holding a slice of the reduced axis (the vocabulary), against the
reference's unsharded ``twopass_softmax`` / ``twopass_logsumexp`` at atol
2e-6, the tolerance of ``tests/test_core_numerics.py``'s sharded checks.
Each call issues exactly one collective: the ``all_reduce`` that gathers
the ranks' ``(m, n)`` pairs."""

import numpy as np
import pytest

from _torch_ranks import run_ranks, twopass_worker
from repro.core import twopass as jtp


@pytest.mark.parametrize("world,cols", [(2, 1000), (4, 1003)],
                         ids=["2-ranks", "4-ranks-uneven"])
def test_sharded_twopass_matches_the_unsharded_reference(tmp_path, world,
                                                         cols):
    rng = np.random.default_rng(world)
    x = (rng.standard_normal((6, cols)) * 8).astype(np.float32)
    x[1, :5] = 60.0                      # rows whose mass sits on one rank
    x[2] = -np.inf
    x[2, cols - 1] = 3.0
    cuts = np.linspace(0, cols, world + 1).astype(int).tolist()
    res = run_ranks(twopass_worker, world, tmp_path, x, world, cuts)
    want_p = np.asarray(jtp.twopass_softmax(x))
    want_l = np.asarray(jtp.twopass_logsumexp(x, keepdims=True))
    got_p = np.concatenate([r["softmax"] for r in res], axis=-1)
    np.testing.assert_allclose(got_p, want_p, atol=2e-6, rtol=0)
    for r in res:
        np.testing.assert_allclose(r["lse"], want_l, atol=2e-6, rtol=0)
        assert r["softmax_calls"] == ["all_reduce"]
        assert r["lse_calls"] == ["all_reduce"]
        assert r["active_calls"] == ["all_reduce"]
    got_active = np.concatenate([r["softmax_active"] for r in res], -1)
    np.testing.assert_array_equal(got_active, got_p)
