"""The port's flash attention (the plain versions of the CUDA kernels of
``csrc/flash_attention.cu`` and the differentiable op around them) against
the JAX package on the CPU: forward, saved stats and dq/dk/dv, with the
reference's Pallas kernels in interpret mode and its jnp (m, n) forms.

The port's "cuda" implementation runs the kernel wrappers, which take
their plain versions for tensors on the CPU; "twopass" runs the plain
forms directly.  Tolerances are the reference's own
(tests/test_train_backward.py): atol 2e-5 / 3e-5 in float32, 5e-2 in bf16;
the stats compare through ``lse = ln m_sum + n_sum ln 2`` at atol 1e-4,
never pair by pair (``m_sum`` may differ by a factor of 2 where a score
lands on a rounding boundary of ``n``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, registry

LN2 = float(np.log(2.0))


def _inputs(b=2, h=3, sq=48, skv=80, d=16, hkv=None, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    dv = dv or d
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dv)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, dv)).astype(np.float32)
    return q, k, v, do


def _expand(x, h):
    """K/V broadcast to the q-heads, as the reference's model route."""
    return np.repeat(x, h // x.shape[1], axis=1)


def _jax(q, k, v, do, impl, causal=False, window=None, dtype=jnp.float32):
    h = q.shape[1]
    args = [jnp.asarray(x, dtype) for x in (q, _expand(k, h), _expand(v, h))]

    def f(q_, k_, v_):
        return jops.flash_attention(q_, k_, v_, causal, None, window, None,
                                    None, None, impl)
    o, vjp = jax.vjp(f, *args)
    dq, dk, dv = vjp(jnp.asarray(do, dtype))
    hkv = k.shape[1]

    def group_sum(x):                   # dk/dv over each KV head's q-heads
        x = np.asarray(x, np.float32)
        return x.reshape(x.shape[0], hkv, h // hkv, *x.shape[2:]).sum(2)
    return (np.asarray(o, np.float32), np.asarray(dq, np.float32),
            group_sum(dk), group_sum(dv))


def _torch(q, k, v, do, impl, causal=False, window=None,
           dtype=torch.float32, **kw):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True)
              for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, window=window, impl=impl,
                            **kw)
    o.backward(torch.from_numpy(do).to(dtype))
    for t in [o] + [x.grad for x in leaves]:
        assert t.dtype == dtype
    return [t.detach().float().numpy() for t in [o] + [x.grad
                                                      for x in leaves]]


def _close(got, want, atol, what):
    for name, a, b in zip("o dq dk dv".split(), got, want):
        assert not np.isnan(a).any(), (what, name)
        np.testing.assert_allclose(a, b, atol=atol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
@pytest.mark.parametrize("impl", ["cuda", "twopass"])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 24)])
def test_masks_match_reference(impl, jimpl, causal, window):
    q, k, v, do = _inputs()
    _close(_torch(q, k, v, do, impl, causal, window),
           _jax(q, k, v, do, jimpl, causal, window), 2e-5,
           f"{impl}/{jimpl} causal={causal} window={window}")


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
@pytest.mark.parametrize("sq,skv", [(40, 100), (1, 96), (129, 257)])
def test_ragged_lengths_match_reference(jimpl, sq, skv):
    # nothing is padded on the port's side: the chunk spans end inside the
    # sequences, as the kernels' tiles do
    q, k, v, do = _inputs(b=1, h=2, sq=sq, skv=skv)
    _close(_torch(q, k, v, do, "cuda", True),
           _jax(q, k, v, do, jimpl, True), 3e-5, f"{jimpl} {sq}x{skv}")


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
def test_empty_causal_rows_are_exact_zeros(jimpl):
    # Sq > Skv, causal: the first Sq - Skv rows see no key
    sq, skv = 100, 40
    q, k, v, do = _inputs(b=1, h=2, sq=sq, skv=skv)
    got = _torch(q, k, v, do, "cuda", True)
    want = _jax(q, k, v, do, jimpl, True)
    cut = sq - skv
    assert not got[0][:, :, :cut].any() and not got[1][:, :, :cut].any()
    _close(got, want, 3e-5, f"{jimpl} empty rows")
    o, m, n = ops.flash_attention_fwd_stats(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, impl="cuda")
    assert not m[:, :, :cut].any() and bool((m[:, :, cut:] > 0).all())


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
def test_bf16_matches_reference(jimpl):
    q, k, v, do = _inputs()
    _close(_torch(q, k, v, do, "cuda", True, dtype=torch.bfloat16),
           _jax(q, k, v, do, jimpl, True, dtype=jnp.bfloat16), 5e-2,
           f"{jimpl} bf16")


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 7)])
@pytest.mark.parametrize("h,hkv", [(4, 2), (6, 1)])
def test_gqa_indexes_kv_heads(h, hkv, causal, window):
    # the port keeps Hkv heads; the reference broadcasts them and its VJP
    # sums dk/dv over each group
    q, k, v, do = _inputs(b=1, h=h, hkv=hkv, sq=33, skv=33)
    _close(_torch(q, k, v, do, "cuda", causal, window),
           _jax(q, k, v, do, "twopass", causal, window), 3e-5,
           f"gqa {h}/{hkv}")


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
@pytest.mark.parametrize("impl", ["cuda", "twopass"])
def test_fwd_stats_match_reference(impl, jimpl):
    q, k, v, _ = _inputs()
    want = jops.flash_attention_fwd_stats(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, impl=jimpl)
    got = ops.flash_attention_fwd_stats(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, impl=impl)
    assert got[1].shape == got[2].shape == (2, 3, 48, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    lse = np.log(got[1].numpy()) + got[2].numpy() * LN2
    lse_j = np.log(np.asarray(want[1])) + np.asarray(want[2]) * LN2
    np.testing.assert_allclose(lse, lse_j, atol=1e-4)


@pytest.mark.parametrize("jimpl", ["pallas", "twopass"])
@pytest.mark.parametrize("impl", ["cuda", "twopass"])
def test_bwd_from_the_reference_stats(impl, jimpl):
    # the backward consumes any forward's residuals: the reference's
    # (o, m_sum, n_sum) in, dq/dk/dv against the reference's backward
    q, k, v, do = _inputs(b=1, h=2, sq=70, skv=70)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, m, n = jops.flash_attention_fwd_stats(jq, jk, jv, causal=True,
                                             window=20, impl=jimpl)
    want = jops.flash_attention_bwd(jq, jk, jv, o, m, n, jdo, causal=True,
                                    window=20, impl=jimpl)
    got = ops.flash_attention_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, m, n, do)),
        causal=True, window=20, impl=impl)
    for name, a, b in zip("dq dk dv".split(), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5,
                                   err_msg=name)


# v's head dim apart from q's and k's (multi-head latent attention: reduced
# deepseek's 24 / 16), and head dims that are no multiple of 8
V_DIMS = [(24, 16), (20, 12)]


@pytest.mark.parametrize("impl", ["cuda", "twopass"])
@pytest.mark.parametrize("d,dv", V_DIMS, ids=["d24-dv16", "d20-dv12"])
def test_v_head_dim_matches_reference(impl, d, dv):
    q, k, v, do = _inputs(b=2, h=4, hkv=2, sq=37, skv=37, d=d, dv=dv)
    got = _torch(q, k, v, do, impl, True)
    assert [x.shape[-1] for x in got] == [dv, d, d, dv]
    _close(got, _jax(q, k, v, do, "pallas", True), 3e-5,
           f"{impl} d={d} dv={dv}")


@pytest.mark.parametrize("d,dv", V_DIMS, ids=["d24-dv16", "d20-dv12"])
def test_v_head_dim_stats_and_bwd_match_reference(d, dv):
    # the plain forward's o and stats against the reference's Pallas
    # forward, then the plain backward from the reference's residuals
    # against its Pallas backward
    q, k, v, do = _inputs(b=1, h=2, sq=45, skv=45, d=d, dv=dv)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, m, n = jops.flash_attention_fwd_stats(jq, jk, jv, causal=True,
                                             impl="pallas")
    got = tfa.flash_attention_fwd_gqa(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert got[0].shape == (1, 2, 45, dv)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o), atol=1e-5)
    lse = np.log(got[1].numpy()) + got[2].numpy() * LN2
    np.testing.assert_allclose(
        lse, np.log(np.asarray(m)) + np.asarray(n) * LN2, atol=1e-4)
    want = jops.flash_attention_bwd(jq, jk, jv, o, m, n, jdo, causal=True,
                                    impl="pallas")
    grads = tfa.flash_attention_bwd_gqa(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, m, n, do)),
        causal=True)
    for name, a, b in zip("dq dk dv".split(), grads, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 256),
                                   (256, 128)])
def test_chunk_lengths_change_only_sum_order(bq, bk):
    # the blocks set the plain forms' chunking (the kernels' tile is fixed)
    q, k, v, do = _inputs(b=1, h=2, sq=256, skv=384)
    want = _jax(q, k, v, do, "twopass", True)
    _close(_torch(q, k, v, do, "twopass", True, block_q=bq, block_k=bk),
           want, 3e-5, f"blocks {bq}x{bk}")


def test_pruned_chunks_change_no_number():
    # chunks that every row's mask covers are skipped; folding them in
    # instead (one chunk covering everything) gives the same o and stats
    q, k, v, _ = _inputs(b=1, h=2, sq=96, skv=96)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    kw = dict(causal=True, scale=0.25, window=20)
    one = tfa.flash_attention_fwd_gqa_plain(qt, kt, vt, **kw)
    many = tfa.flash_attention_fwd_gqa_plain(qt, kt, vt, n_q_chunks=6,
                                             n_kv_chunks=6, **kw)
    assert torch.equal(one[2], many[2])          # n_sum: a max
    torch.testing.assert_close(one[0], many[0], atol=1e-6, rtol=1e-6)


def test_ref_impl_is_autograd_over_the_oracle():
    q, k, v, do = _inputs(b=1, h=4, hkv=2, sq=20, skv=20)
    got = _torch(q, k, v, do, "ref", True)
    want = _torch(q, k, v, do, "twopass", True)
    _close(got, want, 3e-5, "ref vs twopass")


def test_dispatch_and_registry():
    from repro_torch.core.policy import SoftmaxPolicy

    pol = SoftmaxPolicy(use_kernels=True)
    assert ops.train_bwd_impl(pol, None, "cpu") == "twopass"
    assert ops.train_bwd_impl(pol, None, "cuda") == "cuda"
    assert ops.train_bwd_impl(SoftmaxPolicy(), None, "cuda") == "ref"
    for op in ("flash_attention", "flash_attention_bwd"):
        assert registry.block_shapes(op, 4096, 4096) == (64, 64)
        assert registry.block_shapes(op, 40, 100) == (64, 64)
        # a policy override reaches the plain forms' chunking
        assert SoftmaxPolicy(attn_block_q=128).resolve_blocks(
            op, 4096, 4096) == (128, 64)
    assert tfa.chunk_counts(4096, 4096, 64, 64) == (8, 16)
    with pytest.raises(ValueError, match="stats-saving"):
        ops.flash_attention_fwd_stats(*(torch.zeros(1, 1, 4, 8),) * 3,
                                      impl="ref")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b=1, h=2, hkv=1,
                                                       sq=30, skv=30))
    before = (tfa.flash_attention_fwd_gqa.launches,
              tfa.flash_attention_bwd_gqa.launches)
    kw = dict(causal=True, scale=0.25)
    o, m, n = tfa.flash_attention_fwd_gqa(q, k, v, **kw)
    assert all(torch.equal(a, b) for a, b in zip(
        (o, m, n), tfa.flash_attention_fwd_gqa_plain(q, k, v, **kw)))
    g = tfa.flash_attention_bwd_gqa(q, k, v, o, m, n, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(
        g, tfa.flash_attention_bwd_gqa_plain(q, k, v, o, m, n, do, **kw)))
    # launches count kernel launches only
    assert (tfa.flash_attention_fwd_gqa.launches,
            tfa.flash_attention_bwd_gqa.launches) == before
