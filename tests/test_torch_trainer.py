"""The port's train loop on the CPU: the checkpointer (roundtrip, async,
atomic publish, GC, the reference's on-disk layout both ways), the
fault-tolerance units, crash-resume through ``Trainer`` and the training
CLI (``python -m repro_torch.launch.train``).  The cases of
tests/test_checkpoint_ft.py, less the elastic-mesh restore (the port has
no mesh yet: ROADMAP queue A item 22)."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models import build_model as jbuild
from repro.training import train_state as jstate
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import params_from_jax
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import train_state
from repro_torch.training.trainer import Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tiny_state(seed=0):
    m = build_model("granite-20b", reduced=True, n_layers=2, device="cpu")
    return m, train_state.init_state(m.init(seed))


def _leaves(state):
    return [state.opt.step] + adamw.leaves(state.params) + adamw.leaves(
        state.opt.m) + adamw.leaves(state.opt.v)


def _zeros_like(state):
    return train_state.TrainState(
        adamw.tree_map(torch.zeros_like, state.params),
        adamw.AdamWState(torch.zeros_like(state.opt.step),
                         adamw.tree_map(torch.zeros_like, state.opt.m),
                         adamw.tree_map(torch.zeros_like, state.opt.v)))


class TestCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        _, state = _tiny_state()
        state.opt.step.fill_(7)
        ck = Checkpointer(tmp_path)
        ck.save(7, state, blocking=True)
        assert ck.latest_step() == 7
        restored = ck.restore(7, _zeros_like(state))
        assert type(restored) is type(state)
        for a, b in zip(_leaves(state), _leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_async_save(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(tmp_path)
        ck.save(3, state, blocking=False)
        ck.wait()
        assert ck.latest_step() == 3

    def test_async_save_is_a_snapshot(self, tmp_path):
        # the train step updates the state in place after save() returns
        _, state = _tiny_state()
        want = [t.clone() for t in _leaves(state)]
        ck = Checkpointer(tmp_path)
        ck.save(1, state)
        for t in adamw.leaves(state.params):
            t.add_(1.0)
        ck.wait()
        got = ck.restore(1, _zeros_like(state))
        assert all(torch.equal(a, b) for a, b in zip(want, _leaves(got)))

    def test_atomicity_no_partial_dirs(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(tmp_path)
        ck.save(1, state, blocking=True)
        # only published dirs count; a stray tmp dir is invisible
        (tmp_path / "step_0000000002.tmp").mkdir()
        assert ck.latest_step() == 1

    def test_gc_keeps_latest(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, state, blocking=True)
        assert ck.steps() == [3, 4]
        ck.save(4, state, blocking=True)          # a step saved again
        assert ck.steps() == [3, 4]

    def test_mesh_restore_is_refused(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(tmp_path)
        ck.save(5, state, blocking=True)
        with pytest.raises(NotImplementedError, match="item 22"):
            ck.restore_latest(state, mesh=object(), specs={})

    def test_reference_checkpoints_restore_in_the_port(self, tmp_path):
        # a float32 reduced state written by the reference's Checkpointer
        # restores here to the parameters convert gives, and back
        jm = jbuild("qwen2.5-14b", reduced=True)
        jp = jm.init(jax.random.PRNGKey(1))
        js = jstate.init_state(jp)
        JCheckpointer(tmp_path / "jax").save(4, js, blocking=True)
        files = sorted(os.listdir(tmp_path / "jax" / "step_0000000004"))
        assert ".opt__.m__blocks__attn__wk__b.npy" in files
        assert ".opt__.step.npy" in files

        tm = build_model("qwen2.5-14b", reduced=True, device="cpu")
        target = train_state.init_state(tm.init(0))
        step, got = Checkpointer(tmp_path / "jax").restore_latest(target)
        assert step == 4
        want = params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg,
                               device="cpu")
        got_p, want_p = (dict(ckpt_mod._flatten(t))
                         for t in (got.params, want))
        assert got_p.keys() == want_p.keys()
        for key, a in got_p.items():
            assert a.dtype == torch.float32 and torch.equal(a, want_p[key])
        assert not any(t.any() for t in adamw.leaves(got.opt.m))
        assert int(got.opt.step) == 0 and got.opt.step.dtype == torch.int32

        # the port writes the same files, which the reference restores
        Checkpointer(tmp_path / "port").save(4, got, blocking=True)
        assert sorted(os.listdir(tmp_path / "port" / "step_0000000004")) \
            == files
        back = JCheckpointer(tmp_path / "port").restore(
            4, jax.tree.map(np.zeros_like, js))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestCrashResume:
    def test_resume_reproduces_uninterrupted_run(self, tmp_path):
        """Train 6 steps straight vs 3 + crash + resume to 6: the losses of
        steps 3-5 agree (exactly-once data + checkpointed optimizer
        state)."""
        cell = ShapeCell("t", 8, 8, "train")

        def run(steps, ckdir):
            m = build_model("granite-20b", reduced=True, n_layers=2,
                            device="cpu")
            t = Trainer(m, cell, TrainerConfig(
                steps=steps, checkpoint_every=3, checkpoint_dir=str(ckdir),
                log_every=100, peak_lr=1e-3, warmup=2))
            t.run()
            return t.metrics_history

        h1 = run(6, tmp_path / "a")
        run(3, tmp_path / "b")            # the crash: a run cut at step 3
        h2 = run(6, tmp_path / "b")
        assert [m["step"] for m in h2] == [3, 4, 5]
        assert Checkpointer(tmp_path / "a").steps() == [3, 6]
        losses1 = {m["step"]: m["loss"] for m in h1}
        losses2 = {m["step"]: m["loss"] for m in h2}
        for s in (3, 4, 5):
            np.testing.assert_allclose(losses1[s], losses2[s], rtol=1e-5)

    def test_trainer_refuses_a_mesh(self):
        m = build_model("granite-20b", reduced=True, n_layers=2,
                        device="cpu")
        with pytest.raises(NotImplementedError, match="item 22"):
            Trainer(m, ShapeCell("t", 8, 2, "train"), TrainerConfig(),
                    mesh=object())


class TestFaultTolerance:
    def test_heartbeat_states(self):
        mon = ft.HeartbeatMonitor(["h0", "h1"], suspect_after_s=10,
                                  fail_after_s=20)
        mon.beat("h0", now=100.0)
        mon.beat("h1", now=100.0)
        assert mon.status(now=105.0) == {"h0": "healthy", "h1": "healthy"}
        mon.beat("h0", now=112.0)
        assert mon.status(now=115.0)["h1"] == "suspect"   # 15s > 10s
        assert mon.status(now=115.0)["h0"] == "healthy"
        assert mon.failed_hosts(now=125.0) == ["h1"]      # 25s > 20s
        assert mon.should_restart(now=125.0)

    def test_straggler_detection(self):
        t = ft.StepTimer(window=20, straggler_factor=2.0)
        for _ in range(10):
            assert not t.record(1.0)
        assert t.record(5.0)          # 5x median
        assert not t.record(1.1)

    def test_restart_backoff(self):
        p = ft.RestartPolicy(max_restarts=3, base_backoff_s=1.0)
        assert p.next_backoff() == 1.0
        assert p.next_backoff() == 2.0
        assert p.next_backoff() == 4.0
        assert p.next_backoff() is None

    @pytest.mark.parametrize("chips,expect", [
        (512, (32, 16)), (511, (16, 16)), (256, (16, 16)),
        (240, (8, 16)), (16, (1, 16)), (15, None)])
    def test_elastic_plan(self, chips, expect):
        assert ft.elastic_plan(chips, model_parallel=16) == expect


class TestTrainCli:
    BASE = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu"]

    def test_trains_on_the_cpu(self):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *self.BASE,
             "--steps", "2"], capture_output=True, text=True, timeout=300,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        assert out.returncode == 0, out.stderr[-2000:]
        final = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("final:")]
        assert len(final) == 1 and "'step': 1" in final[0]

    def test_kernels_and_resume(self, tmp_path, capsys):
        # --kernels on the CPU: the flash route and the fused LM-head CE
        # through their plain versions (no kernel launch)
        ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
        train_cli.main(self.BASE + ["--steps", "2", "--kernels"] + ck)
        out = capsys.readouterr().out
        assert "kernel launches: {}" in out
        train_cli.main(self.BASE + ["--steps", "3", "--kernels"] + ck)
        out = capsys.readouterr().out
        assert "final: {'step': 2," in out
        assert Checkpointer(tmp_path).steps() == [2, 3]

    @pytest.mark.parametrize("flags,item", [
        (["--mesh", "1x1"], 22), (["--arch", "rwkv6-1.6b"], 27),
        (["--arch", "granite-moe-3b-a800m"], 29),
        (["--arch", "qwen2-vl-7b"], 31), (["--arch", "hymba-1.5b"], 32)])
    def test_unported_flags_exit_with_their_item(self, flags, item, capsys):
        with pytest.raises(SystemExit) as e:
            train_cli.main(self.BASE + flags)
        assert e.value.code == 2
        assert f"item {item}" in capsys.readouterr().err
