#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers N]

Phases (any failure exits non-zero; nothing is caught):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, TF32 switches, and the build of every kernel from
   ``src/repro_torch/csrc`` (nvcc, one process per source, in parallel);
2. kernels: each CUDA kernel held against its plain PyTorch version on the
   card at the serving path's shapes, with its time, its plain version's
   time, one PyTorch library call's time where one computes the same
   function, and its bound (bytes over 3.35 TB/s or operations over the
   float32 peak, whichever is larger); the softmax kernel's bits do not
   change when a row is padded with -inf columns;
3. engine: qwen2.5-14b at full width (d_model 5120, 40/8 heads, d_ff
   13824, vocab 152064, bf16, seeded random weights) serving 12 requests
   through ``ContinuousBatchingEngine(paged=True, use_kernels=True,
   temperature=0)`` on 8 slots; launch counts are zeroed just before and
   read just after;
4. parity: the strip pool (``paged=False``) gives the same tokens; the
   plain forms (``use_kernels=False``) give prefill logits within a stated
   bf16 tolerance; a short ``temperature=0.8`` run drives the sampler's
   softmax kernel.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_S = 67e12          # H100 SXM float32 outside the tensor cores
SOFTMAX_OPS = 74           # float ops per element, both passes
STATS_OPS = 46             # float ops per element, pass 1 (with its folds)
ARCH = "qwen2.5-14b"
MAX_LEN = 1664             # 13 pages of 128: prompts up to 1500 + 32 new
N_SLOTS = 8
N_REQ = 12
NEW_TOKENS = 32


def say(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------------------
# Timing.
# ---------------------------------------------------------------------------
def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn``, each after an L2
    flush (the serving path meets every layer's data cold)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------
def kernel_phase(torch, rng):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import twopass_softmax as tp

    dev = "cuda"
    rows = {}

    def err(got, want):
        g, w = got.float(), want.float()
        d = (g - w).abs()
        return (float(d.max()),
                float((d / w.abs().clamp(min=1e-30)).max()))

    # -- two-pass softmax / stats: prefill scores and the sampler --------
    shapes = [("prefill_bucket_1024", 40 * 1024, 1024),
              ("prefill_bucket_1664", 40 * 1664, 1664),
              ("ragged", 40 * 37, 1000), ("sampler", 8, 152064)]
    for name, r, c in shapes:
        x = torch.from_numpy(rng.standard_normal((r, c), dtype="float32")
                             * 8).to(dev)
        if name.startswith("prefill"):
            # causal rows: columns past the query are -inf, as on the path
            x = torch.where(torch.arange(c, device=dev)[None, :]
                            > torch.arange(r, device=dev)[:, None] % c,
                            -torch.inf, x)
        y = tp.twopass_softmax_2d(x)
        torch.cuda.synchronize()
        a, rel = err(y, tp.twopass_softmax_2d_plain(x))
        ok = torch.allclose(y, tp.twopass_softmax_2d_plain(x), atol=5e-6,
                            rtol=1e-5)
        check(ok, f"twopass_softmax_2d {name}: max abs err {a}")
        m, n = tp.twopass_stats_2d(x)
        mp, np_ = tp.twopass_stats_2d_plain(x)
        sa, _ = err(m, mp)
        check(torch.equal(n, np_) and torch.allclose(m, mp, rtol=1e-5,
                                                     atol=0),
              f"twopass_stats_2d {name}: m err {sa}")
        say("kernel_check", kernel="twopass_softmax_2d", shape=[r, c],
            case=name, max_abs_err=a, max_rel_err=rel,
            tol="atol 5e-6 rtol 1e-5: the same ExtExp bits, only the "
                "order of the (m, n) sum differs")
        say("kernel_check", kernel="twopass_stats_2d", shape=[r, c],
            case=name, m_max_abs_err=sa, n_equal=True,
            tol="n_sum exact (a max); m_sum rtol 1e-5 (sum order)")
        if name in ("prefill_bucket_1024", "sampler"):
            nb = r * c * 4
            t_k = cuda_ms(torch, lambda: tp.twopass_softmax_2d(x))
            t_p = cuda_ms(torch, lambda: tp.twopass_softmax_2d_plain(x), 5)
            t_l = cuda_ms(torch, lambda: torch.softmax(x, -1))
            b_ms, b_by = bound(2 * nb, SOFTMAX_OPS * r * c)
            rows.setdefault("twopass_softmax_2d", {})[name] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, paper_3n_ms=3 * nb / HBM_BYTES_S * 1e3,
                max_abs_err=a, shape=[r, c])
            s_k = cuda_ms(torch, lambda: tp.twopass_stats_2d(x))
            s_p = cuda_ms(torch, lambda: tp.twopass_stats_2d_plain(x), 5)
            s_l = cuda_ms(torch, lambda: torch.logsumexp(x, -1))
            b_ms, b_by = bound(nb + 8 * r, STATS_OPS * r * c)
            rows.setdefault("twopass_stats_2d", {})[name] = dict(
                ms=s_k, plain_ms=s_p, library_ms=s_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=sa, shape=[r, c])
        del x, y, m, n, mp, np_

    # -inf padding changes no bit, though it changes the threads per row
    for r, c, c2 in ((40 * 37, 1000, 1664), (8, 1000, 152064)):
        x = torch.from_numpy(rng.standard_normal((r, c), dtype="float32")
                             * 8).to(dev)
        xp = torch.full((r, c2), -torch.inf, device=dev)
        xp[:, :c] = x
        y, yp = tp.twopass_softmax_2d(x), tp.twopass_softmax_2d(xp)
        st, stp = tp.twopass_stats_2d(x), tp.twopass_stats_2d(xp)
        check(torch.equal(y, yp[:, :c]) and not bool(yp[:, c:].any())
              and all(torch.equal(a, b) for a, b in zip(st, stp)),
              f"softmax bits change under -inf padding {c} -> {c2}")
        say("kernel_check", kernel="twopass_softmax_2d+twopass_stats_2d",
            case=f"-inf padding {c} -> {c2} columns",
            threads=[tp.threads_for(c), tp.threads_for(c2)],
            bitwise_equal=True)
    del x, xp, y, yp, st, stp

    # all -inf row: NaN, as the reference kernel gives (m_sum = 0)
    x = torch.full((2, 300), -torch.inf, device=dev)
    x[1, 7] = 1.0
    y = tp.twopass_softmax_2d(x)
    check(bool(torch.isnan(y[0]).all()) and abs(float(y[1, 7]) - 1) < 1e-6,
          "all -inf row")
    say("kernel_check", kernel="twopass_softmax_2d", case="all -inf row",
        result="NaN row, as the reference kernel (m_sum = 0)")

    # -- decode attention at the serving shapes --------------------------
    s, hkv, g, d, ps = N_SLOTS, 8, 5, 128, 128
    pmax = MAX_LEN // ps
    lengths = rng.integers(200, 1500, s) + 16
    lengths[3] = 0                                      # a free slot
    n_pages = 1 + s * pmax
    table = rng.permutation(np.arange(1, n_pages))[:s * pmax]
    table = table.reshape(s, pmax).astype(np.int32)
    table[3] = 0                                        # free: trash row
    table[5, -2:] = table[6, :2]                        # aliased past len
    lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    tab = torch.from_numpy(table).to(dev)
    bf = torch.bfloat16
    q = torch.randn((s, hkv, g, d), device=dev).to(bf)
    kp = torch.randn((n_pages, ps, hkv, d), device=dev).to(bf)
    vp = torch.randn((n_pages, ps, hkv, d), device=dev).to(bf)
    # the same cache as a strip pool [S, T, Hkv, D], read transposed
    ks = kp[tab.long()].reshape(s, pmax * ps, hkv, d)
    vs = vp[tab.long()].reshape(s, pmax * ps, hkv, d)
    sc = d ** -0.5
    kv_bytes = int(lengths.sum()) * hkv * 2 * d * 2
    io_bytes = 2 * q.numel() * 2 + s * pmax * 4 + s * 4
    dec_ops = int(lengths.sum()) * hkv * g * (4 * d + 20)

    def paged(qq=q, kk=kp, vv=vp, k_scale=None, v_scale=None, window=None):
        return da.decode_attention_paged(qq, kk, vv, tab, lens, k_scale,
                                         v_scale, scale=sc, window=window,
                                         pages_per_tile=1)

    def paged_plain(qq=q, kk=kp, vv=vp, k_scale=None, v_scale=None,
                    window=None):
        return da.decode_attention_paged_plain(
            qq, kk, vv, tab, lens, k_scale, v_scale, scale=sc, window=window,
            n_t_chunks=pmax)

    def contig(qq=q, kk=ks, vv=vs, window=None):
        return da.decode_attention(qq, kk.transpose(1, 2), vv.transpose(1, 2),
                                   lens, scale=sc, window=window,
                                   block_t=ps)

    def contig_plain(qq=q, kk=ks, vv=vs, window=None):
        return da.decode_attention_plain(
            qq, kk.transpose(1, 2), vv.transpose(1, 2), lens, scale=sc,
            window=window, n_t_chunks=pmax)

    # Tolerances.  float32 output: the reference decode tests' atol 1e-5
    # (only the order of f32 sums differs).  bfloat16 output: the f32
    # results differ by that much, then each rounds to bfloat16, so they
    # may land one bf16 step (2^-7 of the value) apart: |err| <= 1e-5 +
    # 1e-2 |want|.  A window one key off moves an output by ~1 / N_eff
    # (~3e-3 at a window of 300), ~6x the bf16 limit on values of ~5e-2.
    f32_tol = dict(atol=1e-5, rtol=0.0)
    bf16_tol = dict(atol=1e-5, rtol=1e-2)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    cases = [("bf16", {}, bf16_tol),
             ("window_300_bf16", dict(window=300), bf16_tol),
             ("f32", dict(qq=qf, kk=kf, vv=vf), f32_tol),
             ("window_300_f32", dict(qq=qf, kk=kf, vv=vf, window=300),
              f32_tol)]
    for gran in ("page", "page_head"):
        shp = (n_pages, ps) if gran == "page" else (n_pages, ps, hkv)
        k8 = torch.randint(-127, 128, (n_pages, ps, hkv, d), device=dev,
                           dtype=torch.int8)
        v8 = torch.randint(-127, 128, (n_pages, ps, hkv, d), device=dev,
                           dtype=torch.int8)
        ksc = torch.rand(shp, device=dev) * 0.02
        vsc = torch.rand(shp, device=dev) * 0.02
        kw = dict(kk=k8, vv=v8, k_scale=ksc, v_scale=vsc)
        cases += [(f"int8_{gran}_bf16q", kw, bf16_tol),
                  (f"int8_{gran}_f32q", dict(kw, qq=qf), f32_tol)]

    def held(got, want, tol, what):
        a, rel = err(got, want)
        excess = float(((got.float() - want.float()).abs()
                        / (tol["atol"] + tol["rtol"] * want.float().abs()))
                       .max())
        check(excess <= 1.0, f"{what}: max abs err {a} beyond {tol}")
        return dict(max_abs_err=a, max_rel_err=rel, tol=tol,
                    worst_err_over_limit=excess)

    for name, kw, tol in cases:
        got = paged(**kw)
        torch.cuda.synchronize()
        r = held(got, paged_plain(**kw), tol, f"decode_attention_paged {name}")
        check(bool((got[3] == 0).all()), f"paged {name}: free slot not 0")
        say("kernel_check", kernel="decode_attention_paged", case=name, **r)
    ksf, vsf = ks.float(), vs.float()
    for name, kw, tol in cases[:4]:
        ckw = dict(kw, kk=ksf, vv=vsf) if "kk" in kw else kw
        got = contig(**ckw)
        torch.cuda.synchronize()
        r = held(got, contig_plain(**ckw), tol, f"decode_attention {name}")
        check(torch.equal(got, paged(**kw)),
              f"decode_attention {name}: strip != paged bits")
        say("kernel_check", kernel="decode_attention", case=name, **r,
            strip_equals_paged_bitwise=True)
    del qf, kf, vf, ksf, vsf

    a_p, _ = err(paged(), paged_plain())
    a_c, _ = err(contig(), contig_plain())
    mask = (torch.arange(pmax * ps, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    q_l = q.reshape(s, hkv * g, 1, d)
    k_l, v_l = ks.transpose(1, 2), vs.transpose(1, 2)
    b_ms, b_by = bound(kv_bytes + io_bytes, dec_ops)
    rows["decode_attention_paged"] = {"main": dict(
        ms=cuda_ms(torch, paged), plain_ms=cuda_ms(torch, paged_plain, 5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=a_p,
        shape=dict(q=list(q.shape), pages=list(kp.shape), pmax=pmax,
                   lengths=lengths.tolist()))}
    rows["decode_attention"] = {"main": dict(
        ms=cuda_ms(torch, contig), plain_ms=cuda_ms(torch, contig_plain, 5),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_l, v_l, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=a_c,
        shape=dict(q=list(q.shape), k=list(k_l.shape),
                   lengths=lengths.tolist()))}
    for name, by_case in rows.items():
        for case, r in by_case.items():
            say("kernel_time", kernel=name, case=case,
                bound_us=r["bound_ms"] * 1e3, **r)
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4: the engine at full width.
# ---------------------------------------------------------------------------
def engine_phase(torch, rng, n_layers: int):
    import repro_torch.kernels as K
    from repro_torch.models import build_model
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    m = build_model(ARCH, n_layers=n_layers, use_kernels=True)
    cfg = m.cfg
    say("engine_config", arch=ARCH, n_layers=cfg.n_layers,
        full_depth=48, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
        weights="bfloat16, seeded torch.Generator on the card")
    t0 = time.perf_counter()
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say("weights", seconds=time.perf_counter() - t0,
        bytes=sum(t.numel() * 2 for t in _leaves(params)))
    plens = rng.integers(200, 1501, N_REQ)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
               for n in plens]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]

    def serve(model, **kw):
        eng = ContinuousBatchingEngine(model, params, slots=N_SLOTS,
                                       max_len=MAX_LEN, seed=3, **kw)
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t = time.perf_counter()
        comps = eng.run(reqs())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = K.launch_counts()
        toks = [list(c.tokens) for c in comps]
        out = dict(eng.throughput(), wall_s=wall, launches=counts,
                   decode_ms_per_step=(eng.stats["decode_s"]
                                       / max(1, eng.stats["steps"]) * 1e3),
                   peak_bytes=torch.cuda.max_memory_allocated())
        del eng
        torch.cuda.empty_cache()
        return toks, out

    # main path: paged pool, kernels on, greedy
    toks_paged, st = serve(m, paged=True, temperature=0.0)
    say("engine", path="paged, use_kernels=True, temperature=0",
        prompt_lens=plens.tolist(), **st)
    check(all(len(t) == NEW_TOKENS for t in toks_paged), "token counts")
    check(st["launches"]["twopass_softmax_2d"] > 0,
          "softmax kernel not launched on the main path")
    check(st["launches"]["decode_attention_paged"] > 0,
          "paged decode kernel not launched on the main path")
    check(st["admitted"] == N_REQ and N_REQ > N_SLOTS, "backfill")
    launches = dict(st["launches"])

    toks_strip, st2 = serve(m, paged=False, temperature=0.0)
    say("engine", path="strip, use_kernels=True, temperature=0", **st2)
    check(st2["launches"]["decode_attention"] > 0,
          "strip decode kernel not launched")
    check(toks_strip == toks_paged, "strip tokens != paged tokens")
    say("parity", check="strip == paged tokens", equal=True)
    launches["decode_attention"] = st2["launches"]["decode_attention"]

    # plain forms: prefill logits of each request, and token agreement
    m_plain = build_model(ARCH, n_layers=n_layers, use_kernels=False)
    worst = 0.0
    for p in prompts[:3]:
        tok = torch.tensor([p], device="cuda")
        lk, _ = engine.prefill(params, tok, cfg=cfg, max_len=MAX_LEN)
        lp, _ = engine.prefill(params, tok, cfg=m_plain.cfg,
                               max_len=MAX_LEN)
        rel = float((lk.float() - lp.float()).abs().max()
                    / lp.float().abs().max())
        worst = max(worst, rel)
    check(worst <= 5e-2, f"prefill logits kernels vs plain: {worst}")
    toks_plain, st3 = serve(m_plain, paged=True, temperature=0.0)
    agree = sum(a == b for x, y in zip(toks_plain, toks_paged)
                for a, b in zip(x, y)) / (N_REQ * NEW_TOKENS)
    say("parity", check="use_kernels=False vs True",
        prefill_logits_max_err_over_max_logit=worst,
        tol="5e-2 of the largest logit: bf16 activations through "
            f"{cfg.n_layers} layers round differently once the softmax "
            "sums differ in order", token_agreement=agree,
        launches=st3["launches"])
    check(sum(st3["launches"].values()) == 0,
          "use_kernels=False launched a kernel")

    # sampler: temperature 0.8 drives the softmax kernel over the vocab
    m_s = build_model(ARCH, n_layers=n_layers, use_kernels=True)
    eng = ContinuousBatchingEngine(m_s, params, slots=N_SLOTS,
                                   max_len=MAX_LEN, temperature=0.8, seed=5)
    K.reset_launch_counts()
    comps = eng.run([Request(rid=i, prompt=prompts[i][:200],
                             max_new_tokens=4) for i in range(N_SLOTS)])
    torch.cuda.synchronize()
    c = K.launch_counts()
    check(all(len(x.tokens) == 4 for x in comps), "sampled token counts")
    check(all(0 <= t < cfg.vocab for x in comps for t in x.tokens),
          "sampled token range")
    check(c["twopass_softmax_2d"] > (N_SLOTS * cfg.n_layers),
          "sampler softmax kernel not launched")
    say("engine", path="paged, use_kernels=True, temperature=0.8",
        launches=c)
    del eng
    idle = idle_share(torch, m, params, prompts)
    return launches, idle


def idle_share(torch, m, params, prompts):
    """Device busy time over wall time for a short traced serving run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    eng = ContinuousBatchingEngine(m, params, slots=N_SLOTS,
                                   max_len=MAX_LEN, temperature=0.0)
    reqs = [Request(rid=i, prompt=prompts[i][:256], max_new_tokens=8)
            for i in range(N_SLOTS)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e6
    if busy <= 0:
        return None
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=max(0.0, 1 - busy / wall))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


REPLACES = {
    "twopass_softmax_2d": "src/repro/kernels/twopass_softmax.py:76",
    "twopass_stats_2d": "src/repro/kernels/twopass_softmax.py:115",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:239",
    "decode_attention": "src/repro/kernels/decode_attention.py:151",
}
SOURCES = {
    "twopass_softmax_2d": "src/repro_torch/csrc/twopass_softmax.cu",
    "twopass_stats_2d": "src/repro_torch/csrc/twopass_softmax.cu",
    "decode_attention_paged": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
}
MAIN_CASE = {"twopass_softmax_2d": "prefill_bucket_1024",
             "twopass_stats_2d": "prefill_bucket_1024",
             "decode_attention_paged": "main", "decode_attention": "main"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48,
                    help="decoder depth of the engine phase (full: 48)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    say("env", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
        build_s=_build.build_seconds)
    print(_build.ptxas_report(), flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul on")

    rng = np.random.default_rng(0)
    torch.manual_seed(0)                 # the card's own random inputs
    t0 = time.perf_counter()
    rows = kernel_phase(torch, rng)
    say("kernels_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches, idle = engine_phase(torch, rng, args.layers)
    say("engine_done", seconds=time.perf_counter() - t0,
        idle=idle if idle else "not measured")
    kernels = []
    for name in REPLACES:
        r = rows[name][MAIN_CASE[name]]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
