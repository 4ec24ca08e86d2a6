"""The port's train step and its ``train()`` loop.

The train step against JAX's ``build_cell(...).fn`` over 3 steps, from
the same params (JAX-initialized, carried across by ``params_from_jax``)
and the same batches (the token pipelines are bit-equal), reduced
configs, lr 3e-3 peak with warmup over 3 of 300 steps
(``_torch_train_inputs.train_steps_vs_jax``), held to
``_torch_train_inputs.TOL``: in f32 losses rtol 1e-5 and the update
within 1e-3 of its norm; in bf16 losses rtol 2e-4 and the update within
0.1 of its norm (that constant says why).

The vision, encoder-decoder and SSM configs take the same f32 limits:
both packages get the same ``patches`` or ``audio`` arrays added to the
token pipelines' batches, and the vision and encoder-decoder models'
``wq``/``wk`` are scaled to their true fan-in on both sides
(``_torch_train_inputs.TRUE_FAN_IN`` says why).

``train()`` on the CPU at the reference's system-test settings
(``tests/test_system.py``: qwen3-1.7b, and mamba2-130m across an
injected failure and a restart).  ``train()`` feeds the token pipeline's
text alone, as the reference's does: whisper-base fails in both
packages for want of ``audio``; the port's phi-3-vision-4.2b trains on
text, where the reference's jitted step refuses a batch without
``patches``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_train_inputs import (TOL, TRUE_FAN_IN, train_steps_vs_jax,
                                 true_fan_in)

from repro.configs import get_config, reduced_config
from repro.launch.train import train as jtrain
from repro.models import model as JM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig as TShapeConfig
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.launch import train as T
from repro_torch.launch.steps import build_cell
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves

B, S = 4, 32


@pytest.mark.parametrize("arch,dtype", [("qwen3-1.7b", "float32"),
                                        ("llama3-8b", "float32"),
                                        ("qwen3-1.7b", "bfloat16"),
                                        ("phi-3-vision-4.2b", "float32"),
                                        ("whisper-base", "float32"),
                                        ("mamba2-130m", "float32")])
def test_train_step_matches_jax_over_three_steps(arch, dtype):
    cfg = reduced_config(get_config(arch), compute_dtype=dtype)
    tcfg = treduced(tget(arch), compute_dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jp = JM.init_params(JM.param_specs(cfg), jax.random.PRNGKey(0))
    if arch in TRUE_FAN_IN:
        jp = jax.tree.map(jax.numpy.asarray, true_fan_in(
            jax.tree.map(np.asarray, jp), cfg.d_model, TRUE_FAN_IN[arch]))
    train_steps_vs_jax(cfg, tcfg, jp, TOL[dtype], batch=B, seq=S)


def test_train_cell_refuses_multi_device_modes_and_serving_shapes():
    # the data-parallel modes run on a mesh (tests/test_torch_sharded_
    # train.py); pipeline stages and an unknown sync are refused
    cfg = treduced(tget("qwen3-1.7b"))
    shape = TShapeConfig("t", S, B, "train")
    with pytest.raises(NotImplementedError, match="item 6c"):
        build_cell(cfg, shape, TM.RunOptions(pipeline=True))
    with pytest.raises(ValueError, match="grad_sync"):
        build_cell(cfg, shape, TM.RunOptions(grad_sync="ring"))
    # without a mesh (no "pod") the compressed sync is the plain step, as
    # in the reference
    build_cell(cfg, shape, TM.RunOptions(grad_sync="compressed"))
    # serving shapes build their cells (tests/test_torch_serving_cells.py);
    # an unknown kind is refused
    assert build_cell(cfg, TShapeConfig("p", S, B, "prefill")).fn is not None
    with pytest.raises(ValueError, match="train"):
        build_cell(cfg, TShapeConfig("p", S, B, "score"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ckpt"))
    losses = T.train("qwen3-1.7b", steps=30, batch=8, seq=64, reduced=True,
                     ckpt_dir=ck, ckpt_every=10, log_every=1000,
                     lr_peak=3e-3, total_steps=300, device="cpu")
    return ck, losses


def test_train_reduces_loss(trained):
    _, losses = trained
    assert len(losses) == 30
    assert all(isinstance(x, float) for x in losses)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_train_checkpoints_and_restart_continues(trained):
    ck, losses = trained
    assert CheckpointManager(ck).steps() == [10, 20, 30]
    more = T.train("qwen3-1.7b", steps=33, batch=8, seq=64, reduced=True,
                   ckpt_dir=ck, ckpt_every=100, log_every=1000,
                   lr_peak=3e-3, total_steps=300, device="cpu")
    assert len(more) == 3                       # steps 30..32
    assert np.isfinite(more).all()
    assert np.mean(more) < np.mean(losses[:5])


def test_injected_failure_then_recovery_replays_the_stream(tmp_path):
    """Crash mid-run, restart from the last committed step; the resumed
    losses equal an uninterrupted run's on the CPU (same ops, same
    order, the stream replayed from the restored step)."""
    kw = dict(batch=4, seq=64, reduced=True, log_every=1000, device="cpu")
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure"):
        T.train("qwen3-1.7b", steps=20, ckpt_dir=ck, ckpt_every=5,
                fail_at_step=12, **kw)
    assert CheckpointManager(ck).steps() == [5, 10]
    resumed = T.train("qwen3-1.7b", steps=14, ckpt_dir=ck, ckpt_every=100,
                      total_steps=200, **kw)
    assert len(resumed) == 4                    # steps 10..13
    whole = T.train("qwen3-1.7b", steps=14, total_steps=200, **kw)
    np.testing.assert_allclose(resumed, whole[10:], rtol=1e-6)


def test_mamba2_injected_failure_then_recovery_replays_the_stream(tmp_path):
    """The reference's system test (``tests/test_system.py``: mamba2-130m,
    batch 4 × 64, a failure injected at step 12 with checkpoints every 5)
    on the port, reduced, on the CPU: the restart resumes from step 10
    and its losses equal an uninterrupted run's (the SSD's backward runs
    the same ops in the same order in both)."""
    kw = dict(batch=4, seq=64, reduced=True, log_every=1000, device="cpu")
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure"):
        T.train("mamba2-130m", steps=20, ckpt_dir=ck, ckpt_every=5,
                fail_at_step=12, **kw)
    assert CheckpointManager(ck).steps() == [5, 10]
    resumed = T.train("mamba2-130m", steps=14, ckpt_dir=ck, ckpt_every=100,
                      total_steps=200, **kw)
    assert len(resumed) == 4                    # steps 10..13
    whole = T.train("mamba2-130m", steps=14, total_steps=200, **kw)
    assert np.isfinite(whole).all()
    np.testing.assert_allclose(resumed, whole[10:], rtol=1e-6)


def test_train_feeds_text_alone_as_the_reference_does():
    """``train()`` feeds the token pipeline's ``tokens``/``labels`` only,
    in both packages.  The encoder-decoder model fails for want of
    ``audio`` in both (the port: a KeyError from the loss; the
    reference: a ValueError from its jitted step, whose input shardings
    expect ``audio``).  The port's vision model trains on text, as both
    packages' ``lm_loss`` allows (no patch rows are written); the
    reference's ``train()`` refuses it the same way, for want of
    ``patches``."""
    kw = dict(steps=2, batch=2, seq=16, reduced=True, log_every=1000)
    losses = T.train("phi-3-vision-4.2b", device="cpu", **kw)
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(ValueError, match="patches"):
        jtrain("phi-3-vision-4.2b", **kw)
    for run in (lambda: jtrain("whisper-base", **kw),
                lambda: T.train("whisper-base", device="cpu", **kw)):
        with pytest.raises((KeyError, ValueError), match="audio"):
            run()


def test_make_train_state_is_f32_and_seeded():
    cfg = treduced(tget("llama3-8b"))
    a, opt = T.make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    b, _ = T.make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(x.dtype == torch.float32 for x in tree_leaves(a))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert set(opt) == {"mu", "nu", "count"} and int(opt["count"]) == 0
    assert all(not m.any() for m in tree_leaves(opt["mu"]))


def test_train_cli_on_cpu(capsys, tmp_path):
    T.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 3 and "[train] done; loss" in out
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3]
    T.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored from step 3" in out and "no step left" in out
