"""The port's serving CLI (``python -m repro_torch.launch.serve``) on the CPU:
it serves a reduced model under each softmax algorithm, every other family
too (deepseek's multi-head latent attention with moe; vlm as the
reference's lockstep batch with patch inputs), the prefix cache's and
the streaming generator's flags, int8 pages and the host swap tier, and
every flag for something not ported yet exits with an error that names
its ROADMAP item."""

import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
        "--requests", "3", "--slots", "2", "--prompt-len", "12",
        "--steps", "4"]


@pytest.mark.parametrize("extra", [
    ["--softmax", "three_pass_reload", "--kernels"],
    ["--softmax", "three_pass_recompute", "--temperature", "0.8", "--strip"],
    ["--temperature", "0", "--kernels", "--page-size", "8", "--pages", "4"],
], ids=["reload-kernels", "recompute-sampled-strip", "two-pass-paged"])
def test_cli_serves_on_the_cpu(extra, capsys):
    serve.main(BASE + extra)
    out = capsys.readouterr().out
    assert "served 3 requests over 2 slots" in out
    assert "prefill: 36 tok" in out
    algo = extra[1] if extra[0] == "--softmax" else "two_pass"
    assert "decode:  9 tok" in out and f"via {algo} sampler" in out
    assert ("strip pool" in out) == ("--strip" in extra)
    # CPU tensors take the plain versions: no kernel launches
    assert ("kernel launches: {}" in out) == ("--kernels" in extra)


# --mesh itself is served (tests/test_torch_tp_serving.py); int8 pages
# under it are not
@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2x2", "--backend", "gloo", "--kv-dtype", "int8"], 22)])
def test_unported_flags_exit_with_their_item(flags, item, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(BASE + flags)
    assert e.value.code == 2
    assert f"ROADMAP queue A item {item}" in capsys.readouterr().err


SWAP = ["--host-swap-bytes", "1000000", "--pages", "5", "--prompt-len",
        "14", "--steps", "6", "--no-prefix-cache"]


@pytest.mark.parametrize("flags,quant,swap", [
    (["--kv-dtype", "int8"], "page", False),
    (["--kv-dtype", "int8", "--scale-granularity", "page_head"],
     "page_head", False),
    (SWAP, None, True),
    (["--kv-dtype", "int8", "--kernels"] + SWAP, "page", True)],
    ids=["int8", "int8-page_head", "swap", "int8-swap-kernels"])
def test_cli_serves_int8_pages_and_the_swap_tier(flags, quant, swap,
                                                 capsys):
    """``--kv-dtype int8`` serves from int8 arenas at either scale
    granularity; ``--host-swap-bytes`` on 4 usable pages of 8 (two
    14-token prompts that grow into a third page) demotes a slot to host
    RAM and promotes it back, the store empty at the end."""
    serve.main(BASE + ["--page-size", "8", "--temperature", "0"] + flags)
    out = capsys.readouterr().out
    assert "served 3 requests over 2 slots" in out
    assert ("prefill: 42 tok" if swap else "prefill: 36 tok") in out
    assert ("decode:  15 tok" if swap else "decode:  9 tok") in out
    assert (f", int8/{quant} scales" in out) == (quant is not None)
    lines = [line for line in out.splitlines()
             if line.startswith("host swap: ")]
    assert bool(lines) == swap
    if swap:
        n = int(lines[0].split()[2])
        assert n > 0 and lines[0] == (f"host swap: {n} demoted, {n} "
                                      "prefetched back, 0 bytes resident")
        assert "0 preempted" in out


@pytest.mark.parametrize("flags,hits", [
    (["--shared-prefix-len", "8"], 2),
    (["--shared-prefix-len", "8", "--kernels", "--temperature", "0"], 2),
    (["--shared-prefix-len", "12", "--stream"], 2),
    (["--shared-prefix-len", "8", "--no-prefix-cache"], None),
    (["--stream"], 0)],
    ids=["shared-prefix", "shared-prefix-kernels", "shared-prefix-stream",
         "no-prefix-cache", "stream"])
def test_cli_serves_the_prefix_cache_and_stream_flags(flags, hits, capsys):
    """The prefix cache is on by default, ``--no-prefix-cache`` turns it
    off, and ``--stream`` prints each request's deltas as they come.  In
    pages of 8, the second and third requests adopt the head's first page
    by reference: with a 12-token head (the whole prompt) the match of 11
    tokens is trimmed to that page, since the 16-token bucket leaves room
    for a tail of 8 after 8 tokens only."""
    serve.main(BASE + ["--page-size", "8"] + flags)
    out = capsys.readouterr().out
    assert "served 3 requests over 2 slots" in out
    assert "prefill: 36 tok" in out and "decode:  9 tok" in out
    if hits is None:
        assert "prefix cache" not in out
    else:
        assert (f"prefix cache: {hits} hits, {hits * 8} prompt tok "
                "adopted by reference") in out
    deltas = [line for line in out.splitlines()
              if line.startswith("delta: request ")]
    assert bool(deltas) == ("--stream" in flags)
    if deltas:
        assert "streamed: " in out and "first delta per request" in out
        toks = {}
        for line in deltas:
            rid, new = line[len("delta: request "):].split(" +")
            toks.setdefault(int(rid), []).extend(eval(new))
        assert sorted(len(t) for t in toks.values()) == [4, 4, 4]
        assert f"sample row: {toks[0]}" in out


@pytest.mark.parametrize("flags,frames", [
    (["--enc-frames", "8"], 8), (["--enc-frames", "8", "--enc-chunk", "4"], 8),
    ([], 12)], ids=["enc-frames", "enc-chunk", "frames-default"])
def test_cli_serves_the_encdec_family(flags, frames, capsys):
    serve.main(["--arch", "whisper-base"] + BASE[2:]
               + ["--temperature", "0", "--kernels"] + flags)
    out = capsys.readouterr().out
    assert "whisper-base: served 3 requests over 2 slots / paged pool" in out
    # prefill counts each request's frames and prompt, as the reference
    assert f"prefill: {3 * (12 + frames)} tok" in out
    assert f"encode:  {3 * frames} frames" in out
    assert "decode:  9 tok" in out and "kernel launches: {}" in out


def test_cli_serves_the_moe_family(capsys):
    serve.main(["--arch", "granite-moe-3b-a800m"] + BASE[2:]
               + ["--temperature", "0", "--kernels"])
    out = capsys.readouterr().out
    assert ("granite-moe-3b-a800m: served 3 requests over 2 slots / paged "
            "pool") in out
    # exact prompt lengths: expert capacity comes from a prompt's length
    assert "1 prefill buckets" in out
    assert "prefill: 36 tok" in out and "decode:  9 tok" in out
    assert "kernel launches: {}" in out


def test_cli_serves_multi_head_latent_attention(capsys):
    serve.main(["--arch", "deepseek-v2-lite-16b"] + BASE[2:]
               + ["--temperature", "0", "--kernels"])
    out = capsys.readouterr().out
    assert ("deepseek-v2-lite-16b: served 3 requests over 2 slots / paged "
            "pool") in out
    assert "1 prefill buckets" in out         # moe: exact prompt lengths
    assert "prefill: 36 tok" in out and "decode:  9 tok" in out
    assert "kernel launches: {}" in out


@pytest.mark.parametrize("extra", [[], ["--strip"]], ids=["paged", "strip"])
def test_cli_serves_the_hybrid_family(extra, capsys):
    serve.main(["--arch", "hymba-1.5b"] + BASE[2:]
               + ["--temperature", "0", "--kernels"] + extra)
    out = capsys.readouterr().out
    pool = "strip pool" if extra else "paged pool"
    assert f"hymba-1.5b: served 3 requests over 2 slots / {pool}" in out
    # exact prompt lengths: the mamba state runs through a prompt's pad
    assert "1 prefill buckets" in out
    assert "prefill: 36 tok" in out and "decode:  9 tok" in out
    assert "kernel launches: {}" in out


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_cli_serves_the_vlm_family_in_lockstep_with_patches(temperature,
                                                            capsys):
    serve.main(["--arch", "qwen2-vl-7b"] + BASE[2:]
               + ["--temperature", temperature, "--kernels"])
    out = capsys.readouterr().out
    # as the reference: one lockstep batch of --slots prompts, each after
    # the reduced config's 8 patches; tokens count the text only
    assert ("qwen2-vl-7b: lockstep batch=2, 8 patches a prompt (no "
            "continuous-batching path for family=vlm)") in out
    assert "prefill: 24 tok" in out and "decode:  8 tok" in out
    assert "kernel launches: {}" in out


def test_cli_refuses_the_strip_pool_for_encdec(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "whisper-base"] + BASE[2:] + ["--strip"])
    assert e.value.code == 2 and "needs the paged pool" in \
        capsys.readouterr().err


def test_cli_serves_the_ssm_family_on_the_strip_pool(capsys):
    serve.main(["--arch", "rwkv6-1.6b"] + BASE[2:]
               + ["--temperature", "0", "--kernels"])
    out = capsys.readouterr().out
    assert "rwkv6-1.6b: served 3 requests over 2 slots / strip pool" in out
    # exact prompt lengths: an ssm prompt is never padded to a bucket
    assert "1 prefill buckets" in out and "prefill: 36 tok" in out
    assert "decode:  9 tok" in out and "kernel launches: {}" in out


def test_cli_runs_as_a_module_and_defaults_to_the_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *BASE,
         "--softmax", "three_pass_reload", "--kernels"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "decode:  9 tok" in out.stdout
    if not __import__("torch").cuda.is_available():
        no_device = [a for a in BASE if a not in ("--device", "cpu")]
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *no_device],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert out.returncode == 2 and "no CUDA device" in out.stderr
